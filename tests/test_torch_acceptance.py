"""External-pose acceptance gates of the port, the easy regime and the
dataset pipelines: the runs of tests/test_acceptance.py (default) and
tests/test_acceptance_stress.py (exposure A/B, tum, asl) through the
port's `offline_runner.main` at VGA over 200 frames with the default
FlameParams (`chip_smoke.acceptance_run`). Each run is held to the JAX
package's run of the same frames, `chip_smoke.JAX_ACCEPT_VGA200`
(`chip_smoke.accept_verdict`): rmse, recall and coverage within
JAX_BAND; each of the JAX file's gates that the JAX run passes, passed
(the ones it fails, its known coverage floors, are held to the JAX run
by the band); exposure B beating A wherever JAX's does. Every run also:
200 frames, none failed, every frame healthy, the id buffer of frame 97
and of poseframe 150 (after the third ring wrap) equal to the plain v4
version's recomputation from the engine's state and to the plain
formulation up to evaluation-order splits; on the card, v4 launched on
every frame and v2 and v3 never, and every frame the run read equal bit
for bit to the CPU's rendering of it, which the JAX run read
(`chip_smoke.frame_digest`).

Slow (minutes each on the CPU): left out of the tier-1 run. They run on
the card where one exists, else on the CPU:

    python -m pytest tests/test_torch_acceptance.py -m slow -q -s
"""
import json
import os

import pytest
import torch

import chip_smoke

# One intra-op thread at import, as every port test file: the tier-1
# run imports this file in its workers. A run on the CPU takes the cores.
torch.set_num_threads(1)


def _check(name, out, other=None):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        r = chip_smoke.acceptance_run(name, device, str(out))
        differ = {}
        if device == "cuda":
            from flame_ros_torch.datasets.synthetic import VGA, make_sequence
            differ = chip_smoke.frames_differ(
                r["digests"], chip_smoke.sequence_digests(make_sequence(
                    chip_smoke.ACCEPT_FRAMES, VGA, device="cpu",
                    **chip_smoke.accept_sequence(name))))
    finally:
        torch.set_num_threads(threads)
    if other is not None:
        other = (other["summary"], chip_smoke.JAX_ACCEPT_VGA200[
            "exposure_a"])
    verdict, ok = chip_smoke.accept_verdict(
        name, r["summary"], chip_smoke.JAX_ACCEPT_VGA200[name], other)
    print(json.dumps({"device": device, "run": name, "ok": ok,
                      "summary": r["summary"], "verdict": verdict,
                      "ms_per_frame_p50": r["ms_per_frame_p50"],
                      "launches": r["launches"], "checks": r["checks"],
                      "frames_differ_from_cpu": differ}))
    assert ok, verdict
    assert not any(differ.values()), differ
    return r


@pytest.mark.slow
def test_default_vga200(tmp_path):
    _check("default", tmp_path)


@pytest.mark.slow
def test_exposure_zero_mean_ssd_ab_vga200(tmp_path):
    a = _check("exposure_a", tmp_path)
    _check("exposure_b", tmp_path, other=a)


@pytest.mark.slow
def test_tum_pipeline_vga200(tmp_path):
    _check("tum", tmp_path)


@pytest.mark.slow
def test_asl_pipeline_mav_vga200(tmp_path):
    _check("asl", tmp_path)
