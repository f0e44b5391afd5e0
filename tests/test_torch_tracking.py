"""The port's tracking modules held against the JAX package's on the CPU,
at 96x128 with frames rendered by the port's renderer (`track_frame`
and `optimize_pose_graph` are held in tests/test_torch_tracking_node.py,
which shares their JAX compiles with the nodelet stream there).

- `_select_ref_points` on an image built so that most gradient scores
  tie: the selected uv, validity and inverse depths bit for bit (the
  JAX package ranks with `jax.lax.top_k`, lower index first among ties).
- `ate_rmse` (se3, sim3, none) and `rpe` (delta 1 and 5) equal the JAX
  package's numpy versions to 1e-9; `with_pose_noise` gives the JAX
  package's poses for a seed to 1e-6.
- The synthetic stress knobs (`texture_gain`, `exposure_amp`) equal the
  JAX `make_sequence`'s transforms applied to the same base frames, to
  1e-4 gray levels.
- The tracking failure gate (`FlameNodelet._track_ok`) on the cases of
  tests/test_tracking_recovery.py, `ba_refine=True` accepted and
  `pose_tracking.ba_sharded=True` refused, and `debug.profile_stages`
  filling the stage-timing keys on a 7-frame run (no JAX needed).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flame_ros_tpu.datasets.synthetic as jsyn
from flame_ros_tpu.eval import metrics as jmet
from flame_ros_tpu.frontends.offline_runner import \
    with_pose_noise as j_with_pose_noise
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.models import tracking as jtr
from flame_ros_torch.config import FlameParams
from flame_ros_torch.datasets.synthetic import make_sequence, make_trajectory
from flame_ros_torch.eval import metrics as tmet
from flame_ros_torch.frontends.nodelet import FlameNodelet
from flame_ros_torch.frontends.offline_runner import \
    with_pose_noise as t_with_pose_noise
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models import tracking as ttr
from flame_ros_torch.models.engine import Flame
from flame_ros_torch.ops.pyramid import build_pyramid
from flame_ros_torch.utils.stage_profiler import STAGES

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)


def _pyr(img):
    return build_pyramid(torch.from_numpy(np.ascontiguousarray(img)),
                         4).numpy()


def test_select_ref_points_ties_bit_exact():
    """Most candidates of a repeating 8-bit pattern share a gradient
    score; the 512 kept of 2048 must be the JAX package's, in order."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = (32.0 * ((xx + 2 * yy) % 5)).astype(np.float32)
    idepth = np.full((H, W), 0.5, np.float32)
    idepth[::7, ::3] = np.nan          # some candidates fail the gate
    pyr = _pyr(img)
    j = jax.jit(jtr._select_ref_points, static_argnums=(2, 3, 4))(
        jnp.asarray(pyr), jnp.asarray(idepth), JCAM, 512, 4.0)
    t = ttr._select_ref_points(torch.from_numpy(pyr),
                               torch.from_numpy(idepth), TCAM, 512, 4.0)
    # Five intensities, so a handful of gradient scores: ties everywhere.
    assert len(np.unique(np.asarray(j[3]))) <= 5
    for name, a, b in zip(("uv", "xi", "valid", "iref"), j[:4], t[:4]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    np.testing.assert_allclose(t[4].numpy(), np.asarray(j[4]), rtol=1e-6)


def test_trajectory_metrics_and_pose_noise_match_jax(rng):
    n = 40
    gt_t = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    c, s = np.cos(0.03), np.sin(0.03)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    est_t = gt_t @ rot.T * 1.03 + 0.1 + rng.normal(0, 0.01, (n, 3))
    for align in ("se3", "sim3", "none"):
        a = tmet.ate_rmse(est_t, gt_t, align=align)
        b = jmet.ate_rmse(est_t, gt_t, align=align)
        assert abs(a - b) <= 1e-9, align
    gq = rng.normal(size=(n, 4))
    gq /= np.linalg.norm(gq, axis=1, keepdims=True)
    eq = gq + rng.normal(0, 0.01, (n, 4))
    for delta in (1, 5):
        a = tmet.rpe(eq, est_t, gq, gt_t, delta=delta)
        b = jmet.rpe(eq, est_t, gq, gt_t, delta=delta)
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-9, (delta, k)
    with pytest.raises(ValueError):
        tmet.rpe(eq[:2], est_t[:2], gq[:2], gt_t[:2], delta=5)

    poses = make_trajectory(6, "strafe", device="cpu")

    def frames():
        for i in range(6):
            yield SimpleNamespace(img_id=i, quat=poses.q[i].numpy().copy(),
                                  trans=poses.t[i].numpy().copy())
    for j, t in zip(j_with_pose_noise(frames(), 0.02, 1.5, seed=7),
                    t_with_pose_noise(frames(), 0.02, 1.5, seed=7)):
        np.testing.assert_allclose(t.quat, np.asarray(j.quat), atol=1e-6)
        np.testing.assert_allclose(t.trans, np.asarray(j.trans), atol=1e-6)


def test_stress_knobs_match_jax(monkeypatch):
    """The port's make_sequence(texture_gain=, exposure_amp=) against the
    JAX package's make_sequence applied to the port's base frames (its
    renderer and trajectory patched to return the port's)."""
    n = 2
    base = make_sequence(n, TCAM, device="cpu")
    monkeypatch.setattr(jsyn, "make_trajectory",
                        lambda *a, **k: SimpleNamespace(
                            q=base.poses.q.numpy(), t=base.poses.t.numpy()))
    for gain, amp, period in ((0.3, 0.0, 50.0), (0.6, 0.4, 5.0)):
        frames = iter(list(zip(base.images.numpy(), base.depths.numpy())))
        monkeypatch.setattr(jsyn, "render_frame",
                            lambda *a, **k: next(frames))
        j = jsyn.make_sequence(n, JCAM, texture_gain=gain,
                               exposure_amp=amp, exposure_period=period)
        t = make_sequence(n, TCAM, texture_gain=gain, exposure_amp=amp,
                          exposure_period=period, device="cpu")
        np.testing.assert_allclose(t.images.numpy(), j.images, rtol=0,
                                   atol=1e-4, err_msg=str((gain, amp)))
        np.testing.assert_array_equal(t.depths.numpy(), j.depths)
        assert t.images.dtype == torch.float32
        assert float(t.images.min()) >= 0 and float(t.images.max()) <= 255


def _result(cost, n_inliers, n_valid):
    return ttr.TrackResult(q=torch.tensor([1.0, 0, 0, 0]), t=torch.zeros(3),
                           final_cost=torch.tensor(cost),
                           n_inliers=torch.tensor(n_inliers),
                           gain=torch.tensor(1.0), offset=torch.tensor(0.0),
                           n_valid=torch.tensor(n_valid))


def test_track_gate_cases():
    """tests/test_tracking_recovery.py's gate cases, QVGA defaults."""
    node = FlameNodelet(TCAM, FlameParams(), pose_source="tracking",
                        device="cpu")
    assert node._track_ok(_result(6.0, 1800, 1950))          # clean
    assert not node._track_ok(_result(24.0, 0, 800))         # saturated
    assert not node._track_ok(_result(0.0, 0, 0))            # degenerate
    assert not node._track_ok(_result(10.0, 300, 1500))      # few inliers
    assert not node._track_ok(_result(float("nan"), 1000, 1500))
    # Bundle adjustment: unsharded at the default budget (the JAX rule
    # shards at >= 16384 points over >= 2 cards; the CPU is one device);
    # ba_sharded=True builds a nodelet whose solve is point-sharded, over
    # the one CPU device here.
    node = FlameNodelet(TCAM, FlameParams(), pose_source="tracking",
                        ba_refine=True, device="cpu")
    assert node.ba_refine and node.ba_devices(256) is None
    assert node.ba_devices(16384) is None
    sharded = FlameParams.from_dict({"pose_tracking": {"ba_sharded": True}})
    node = FlameNodelet(TCAM, sharded, pose_source="tracking",
                        ba_refine=True, device="cpu")
    assert node.ba_refine
    assert node.ba_devices(256) == [torch.device("cpu")]


def test_profile_stages_refused():
    """debug.profile_stages is accepted and, every profile_stages_every
    frames, fills the stage-timing keys (tests/test_engine.py's
    test_profile_stages_populates_timing_vocabulary, on the port): the
    12 stages the profiler re-times plus the engine's own "update"."""
    p = FlameParams.from_dict({
        "engine": {"max_features": 256, "max_keyframes": 4},
        "debug": {"profile_stages": True, "profile_stages_every": 5}})
    assert p.resolved("cpu").debug.profile_stages is True
    assert FlameParams().resolved("cpu").debug.profile_stages is False
    seq = make_sequence(7, TCAM, device="cpu")
    engine = Flame(W, H, cam=TCAM, params=p, device="cpu")
    for i in range(7):
        assert engine.update(float(seq.timestamps[i]), i,
                             SE3(seq.poses.q[i], seq.poses.t[i]),
                             seq.images[i].numpy(), i % 3 == 0)
    t = engine.stats_.timings()
    keys = set(STAGES) | {"update"}
    assert len(keys) == 13 and keys <= set(t), sorted(keys - set(t))
    assert all(t[k] >= 0.0 for k in keys)
    # The hot stages carry real measurements; the disabled filters 0.
    for k in ("update_idepths", "sync_graph", "triangulate"):
        assert t[k] > 0.0, k
    assert t["median_filter"] == t["lowpass_filter"] == 0.0
    rec = engine.stats_.to_record(7, 0.0)
    assert rec["update_idepths_ms"] == t["update_idepths"]
