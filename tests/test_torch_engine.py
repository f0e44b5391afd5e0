"""The port's engine (flame_ros_torch/models/engine.py) and offline runner
held against the JAX package's on the CPU, at 96x128 with 256 feature
slots and 4 keyframes.

- Lockstep: the JAX engine runs a few frames, its state is carried into
  the port (`Flame.load_state`), then both process one poseframe and one
  ordinary frame. Every EngineState leaf is compared: integer and
  boolean leaves exactly, float leaves to 1e-4 absolute plus 1e-5
  relative (f32 operation-order noise; `cell_err` holds mean photometric
  errors of up to ~100 gray levels, where 1e-4 is ~1 ulp), and the
  packed stats vector likewise.
- Slice band: `run_offline` over the same numpy frames on both. Host
  Delaunay of last-bit-different vertex positions may pick different
  triangles, so the runs are compared by a band: final rmse within 15 %
  relative and coverage within 0.05. The port with bf16 epipolar
  gathers is held to the JAX package's bf16 engine bands
  (tests/test_engine.py:553-562).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.frontends.offline_runner import run_offline as jrun
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.models.engine import Flame as JFlame
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import QVGA, make_sequence
from flame_ros_torch.frontends.offline_runner import Frame, main
from flame_ros_torch.frontends.offline_runner import run_offline as trun
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, Flame,
                                           state_from_numpy, state_to_numpy)

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4}}


@pytest.fixture(scope="module")
def seq():
    """Ten frames rendered once, as numpy arrays, by the port's renderer
    (the JAX package's takes ~20x longer on the CPU); the same arrays go
    to both engines."""
    s = make_sequence(10, TCAM, motion="strafe", device="cpu")
    return SimpleNamespace(
        images=s.images.numpy(), depths=s.depths.numpy(),
        timestamps=np.asarray(s.timestamps),
        poses=SimpleNamespace(q=s.poses.q.numpy(), t=s.poses.t.numpy()))


def _jax_state(st):
    out = {f"feat.{k}": np.asarray(v) for k, v in st.feat._asdict().items()}
    out.update({k: np.asarray(v) for k, v in st._asdict().items()
                if k != "feat"})
    return out


def _assert_states_match(jst, tst, what):
    a, b = _jax_state(jst), state_to_numpy(tst)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, (what, k)
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=1e-5,
                                       err_msg=f"{what}: {k}")


def test_engine_lockstep(seq):
    q, t = np.array(seq.poses.q), np.array(seq.poses.t)
    je = JFlame(W, H, cam=JCAM, params=JParams.from_dict(SMALL))

    def jpose(i):
        return JSE3(jnp.asarray(q[i]), jnp.asarray(t[i]))

    for i in range(6):
        assert je.update(seq.timestamps[i], i, jpose(i), seq.images[i],
                         i % 6 == 0, gt_depth=seq.depths[i])
    te = Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
               device="cpu")
    te.load_state(_jax_state(je.state), host=dict(
        num_poseframes=je._num_poseframes, frame_count=je._frame_count,
        kf_slot=je._kf_slot, max_frame_id=je._max_frame_id,
        installed_topo_wm=je._installed_topo_wm))
    _assert_states_match(je.state, te.state, "carried")
    for i, what in ((6, "poseframe"), (7, "frame")):
        pf = i % 6 == 0
        assert je.update(seq.timestamps[i], i, jpose(i), seq.images[i], pf,
                         gt_depth=seq.depths[i])
        assert te.update(seq.timestamps[i], i,
                         TSE3(torch.from_numpy(q[i]), torch.from_numpy(t[i])),
                         seq.images[i], pf, gt_depth=seq.depths[i])
        _assert_states_match(je.state, te.state, what)
        jr, tr = je.flush_stats(), te.flush_stats()
        for k in DEVICE_STATS_KEYS:
            assert tr[k] == pytest.approx(jr[k], rel=1e-4, abs=1e-4), (what,
                                                                       k)
        np.testing.assert_array_equal(te.last_status, je.last_status)
    assert te.num_poseframes == je.num_poseframes
    assert te._topo_installs == 1   # the poseframe's retriangulation
    np.testing.assert_allclose(te.get_inverse_depth_map(),
                               je.get_inverse_depth_map(), atol=1e-4)


def _frames(seq, n):
    q, t = np.array(seq.poses.q), np.array(seq.poses.t)
    return [Frame(i, float(seq.timestamps[i]), seq.images[i], seq.depths[i],
                  q[i], t[i]) for i in range(n)]


def test_run_offline_slice_band(seq):
    n = 8
    jres = jrun(_frames(seq, n), JCAM, JParams.from_dict(SMALL))
    tres = trun(_frames(seq, n), TCAM, TParams.from_dict(SMALL),
                device="cpu")
    assert tres.frames_processed == jres.frames_processed == n
    assert tres.frames_failed == 0
    assert np.isfinite(tres.mean_rmse)
    assert tres.mean_rmse == pytest.approx(jres.mean_rmse, rel=0.15)
    assert abs(tres.final_coverage - jres.final_coverage) <= 0.05
    assert tres.final_coverage > 0.3
    # compute_dtype="bfloat16" (bf16 epipolar gathers) in the bands of
    # tests/test_engine.py:553-562, at that test's configuration: QVGA,
    # 18 frames, 512 feature slots, 30 sweeps a frame.
    s = make_sequence(18, QVGA, motion="strafe", device="cpu")
    bf16 = TParams.from_dict({
        "engine": {"max_features": 512, "max_keyframes": 4,
                   "pd_iters_per_frame": 30, "compute_dtype": "bfloat16"},
        "input": {"poseframe_subsample_factor": 6}})
    eng = Flame(QVGA.width, QVGA.height, cam=QVGA, params=bf16,
                device="cpu")
    for i in range(18):
        assert eng.update(float(s.timestamps[i]), i,
                          TSE3(s.poses.q[i], s.poses.t[i]), s.images[i],
                          i % 6 == 0)
    est = eng.get_inverse_depth_map()
    d = s.depths[17].numpy()
    gt = np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0)
    m = np.isfinite(est) & (gt > 0)
    err = np.abs(est - gt)[m]
    assert m.mean() > 0.4, m.mean()
    assert np.median(err) < 0.02 and (err < 0.1).mean() > 0.85


def test_state_round_trip():
    eng = Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
                device="cpu")
    d = state_to_numpy(eng.state)
    st = state_from_numpy(d, "cpu", like=eng.state)
    for k, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, d[k])
        assert v.dtype == d[k].dtype
    d["vtx_uv"] = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError):
        eng.load_state(d)


def test_engine_rejects_bad_input(seq):
    eng = Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
                device="cpu")
    q, t = np.array(seq.poses.q), np.array(seq.poses.t)
    nan_pose = TSE3(torch.full((4,), float("nan")), torch.zeros(3))
    assert not eng.update(0.0, 0, nan_pose, seq.images[0], True)
    bad = seq.images[0].copy()
    bad[3, 4] = np.inf
    assert not eng.update(0.0, 0, TSE3(torch.from_numpy(q[0]),
                                       torch.from_numpy(t[0])), bad, True)
    assert eng.num_failed_frames == 2
    assert eng.update(0.0, 0, TSE3(torch.from_numpy(q[0]),
                                   torch.from_numpy(t[0])), seq.images[0],
                      False)
    assert eng.num_poseframes == 1     # the first frame is forced a pf
    rec = eng.flush_stats()
    assert rec["health"] == 1.0 and rec["true_pos"] == -1.0


def test_main_synthetic_cpu(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("engine:\n  max_features: 256\n  max_keyframes: 4\n")
    main(["--dataset", "synthetic", "--frames", "3", "--device", "cpu",
          "--config", str(cfg), "--out", str(tmp_path / "out")])
    import json
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 3 and summary["failed"] == 0
    assert set(summary) == {"frames", "failed", "fps", "idepth_rmse",
                            "precision", "recall", "coverage", "abs_rel",
                            "delta1"}
    assert (tmp_path / "out" / "stats.txt").exists()


def test_params_round_trip_into_engine():
    jp = dataclasses.replace(JParams.from_dict(SMALL).resolved("cpu"))
    eng = Flame(W, H, cam=TCAM, params=TParams.from_dict(jp.to_dict()),
                device="cpu")
    assert eng.params.to_dict() == jp.to_dict()
