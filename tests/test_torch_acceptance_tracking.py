"""Tracking-mode acceptance gates of the port: the eight runs of
tests/test_acceptance_tracking.py (easy, low texture, rotation, mav,
occlusion 80:89; easy and rotation with windowed bundle adjustment; the
pod-dense configuration with BA), read from `chip_smoke.TRACK_ACCEPT_RUNS`
and run through the port's `main --pose-source tracking` at VGA over 200
frames (`chip_smoke.track_acceptance_run`). Each run is held to the JAX
package's runs of the same frames, as phase 15 of chip_smoke.py holds it
(`chip_smoke.track_verdict`): poses within 1e-4 of the unmoved JAX run
(`JAX_TRACK_ACCEPT`) up to the frame where JAX's own runs on frames one
float32 step apart part from it, the first three BA costs within 1e-3
relative; rmse, recall, coverage, ATE, RPE and the BA solves within phase
8's bands about the spread of those runs (`JAX_TRACK_ACCEPT_SPREAD`);
each of the JAX file's gates that the unmoved JAX run passes, passed. The
pod-dense run's BA windows hold the full 16384-point budget: on one card
the nodelet's auto rule (`FlameNodelet.ba_devices`) keeps every solve
unsharded, as JAX's rule does on one CPU device; the run needs at least
20 of them, each at 16384 points. On the card, every frame the run read
equals bit for bit the CPU's rendering of it, which the JAX runs read.

Slow (hours on the CPU): left out of the tier-1 run. They run on the card
where one exists, else on the CPU:

    python -m pytest tests/test_torch_acceptance_tracking.py -m slow -q -s
"""
import json
import os

import pytest
import torch

import chip_smoke

# One intra-op thread at import, as every port test file: the tier-1
# run imports this file in its workers. A run on the CPU takes the cores.
torch.set_num_threads(1)


def _check(name, out):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        r = chip_smoke.track_acceptance_run(name, device, str(out))
        differ = {}
        if device == "cuda":
            from flame_ros_torch.datasets.synthetic import VGA, make_sequence
            differ = chip_smoke.frames_differ(
                r["digests"], chip_smoke.sequence_digests(make_sequence(
                    chip_smoke.ACCEPT_FRAMES, VGA, device="cpu",
                    **chip_smoke.track_sequence(name))))
    finally:
        torch.set_num_threads(threads)
    verdict, ok = chip_smoke.track_verdict(name, r)
    print(json.dumps({"device": device, "run": name, "ok": ok,
                      "summary": r["summary"], "verdict": verdict,
                      "ms_per_frame_p50": r["ms_per_frame_p50"],
                      "launches": r["launches"], "checks": r["checks"],
                      "frames_differ_from_cpu": differ}))
    assert ok, verdict
    assert not any(differ.values()), differ


@pytest.mark.slow
def test_tracking_easy_vga200(tmp_path):
    _check("easy", tmp_path)


@pytest.mark.slow
def test_tracking_easy_ba_refine_vga200(tmp_path):
    _check("easy_ba", tmp_path)


@pytest.mark.slow
def test_tracking_low_texture_vga200(tmp_path):
    _check("low_texture", tmp_path)


@pytest.mark.slow
def test_tracking_rotation_vga200(tmp_path):
    _check("rotation", tmp_path)


@pytest.mark.slow
def test_tracking_rotation_ba_vga200(tmp_path):
    _check("rotation_ba", tmp_path)


@pytest.mark.slow
def test_tracking_mav_vga200(tmp_path):
    _check("mav", tmp_path)


@pytest.mark.slow
def test_tracking_occlusion_recovery_vga200(tmp_path):
    _check("occlusion", tmp_path)


@pytest.mark.slow
def test_pod_dense_ba_vga(tmp_path):
    _check("pod_dense", tmp_path)
