"""Tracking-mode acceptance gates of the port: the gates of
tests/test_acceptance_tracking.py (easy, low texture, rotation, mav,
occlusion 80:89; easy and rotation with windowed bundle adjustment; the
pod-dense configuration with BA), run through the port's `main
--pose-source tracking` at VGA over 200 frames with the default
FlameParams (cfg/pod_dense_ba.yaml for the last). Each asserts the JAX
file's own bounds. The pod-dense gate's BA windows hold the full
16384-point budget. The port has the point-sharded solver
(`hybrid_bundle_adjust_sharded`), but on one card the nodelet's auto
rule (`FlameNodelet.ba_devices`, frontends/nodelet.py:480-500: shard at
that budget only when two or more cards are visible) keeps every solve
unsharded, on the one device. The gate asserts the routing facts of the
unsharded solves it sees: every one at the full budget, at least 20.

Slow (hours on the CPU): left out of the tier-1 run. They run on the card
where one exists, else on the CPU:

    python -m pytest tests/test_torch_acceptance_tracking.py -m slow -q
"""
import contextlib
import io
import json
import os

import pytest
import torch

from flame_ros_torch.frontends import nodelet as nodelet_mod
from flame_ros_torch.frontends.offline_runner import main

POD_DENSE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfg", "pod_dense_ba.yaml")


def _run(*extra):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--dataset", "synthetic", "--resolution", "vga",
              "--frames", "200", "--pose-source", "tracking",
              "--device", device, *extra])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    print(json.dumps({"device": device, "args": list(extra), **summary}))
    return summary


@pytest.mark.slow
def test_tracking_easy_vga200():
    s = _run()
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["ate_rmse"] < 0.005 * s["gt_path_length"], s
    assert s["ate_rmse"] < 0.01, s
    assert s["idepth_rmse"] < 0.05, s
    assert s["precision"] > 0.95, s
    assert s["recall"] > 0.82, s
    assert s["rpe_trans_rmse"] < 0.003, s
    assert s["rpe_rot_rmse_deg"] < 0.05, s


@pytest.mark.slow
def test_tracking_easy_ba_refine_vga200():
    s = _run("--ba-refine")
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["ate_rmse"] < 0.008 * s["gt_path_length"], s
    assert s["ate_rmse_sim3"] < 0.01, s
    assert s["idepth_rmse"] < 0.05, s
    assert s["recall"] > 0.82, s


@pytest.mark.slow
def test_tracking_low_texture_vga200():
    s = _run("--texture-gain", "0.3")
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["ate_rmse"] < 0.01 * s["gt_path_length"], s
    assert s["idepth_rmse"] < 0.06, s
    assert s["recall"] > 0.85, s
    assert s["rpe_rot_rmse_deg"] < 0.4, s


@pytest.mark.slow
def test_tracking_rotation_vga200():
    s = _run("--motion", "rotation")
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["rpe_rot_rmse_deg"] < 0.03, s
    assert s["rpe30_rot_rmse_deg"] < 0.5, s
    assert s["rpe_trans_rmse"] < 0.003, s
    assert s["ate_rmse_sim3"] < 0.01, s
    assert s["ate_rmse"] < 0.03, s
    assert s["recall"] > 0.73, s
    assert s["idepth_rmse"] < 0.06, s


@pytest.mark.slow
def test_tracking_rotation_ba_vga200():
    s = _run("--motion", "rotation", "--ba-refine")
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["rpe_rot_rmse_deg"] < 0.03, s
    assert s["rpe30_rot_rmse_deg"] < 0.5, s
    assert s["ate_rmse_sim3"] < 0.015, s
    assert s["ate_rmse"] < 0.03, s
    assert s["recall"] > 0.75, s


@pytest.mark.slow
def test_tracking_mav_vga200():
    s = _run("--motion", "mav")
    assert s["frames"] == 200 and s["failed"] == 0
    assert s["ate_rmse"] < 0.007 * s["gt_path_length"], s
    assert s["rpe_rot_rmse_deg"] < 0.05, s
    assert s["rpe_trans_rmse"] < 0.003, s
    assert s["recall"] > 0.70, s
    assert s["idepth_rmse"] < 0.06, s


@pytest.mark.slow
def test_tracking_occlusion_recovery_vga200():
    s = _run("--occlude", "80:89")
    assert 10 <= s["track_failed_frames"] <= 18, s
    assert s["frames"] >= 200 - 18, s
    assert s["failed"] == 0, s
    assert s["ate_rmse"] < 0.005 * s["gt_path_length"], s
    assert s["idepth_rmse"] < 0.05, s
    assert s["recall"] > 0.85, s


@pytest.mark.slow
def test_pod_dense_ba_vga(monkeypatch):
    calls = []
    orig = nodelet_mod.hybrid_bundle_adjust

    def spy(*a, **kw):
        calls.append(a[5].shape[0])   # P of this solve
        return orig(*a, **kw)

    monkeypatch.setattr(nodelet_mod, "hybrid_bundle_adjust", spy)
    s = _run("--ba-refine", "--config", POD_DENSE)
    assert s["frames"] == 200 and s["failed"] == 0, s
    assert s["track_failed_frames"] <= 4, s
    assert len(calls) >= 20, len(calls)
    assert all(p == 16384 for p in calls), calls[:4]
    assert s["ate_rmse"] < 0.18, s
    assert s["idepth_rmse"] < 0.15, s
    assert s["recall"] > 0.65, s
