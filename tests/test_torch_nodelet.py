"""The port's live frontend (flame_ros_torch/frontends/nodelet.py) and the
engine's host API held against the JAX package's on the CPU, at 96x128
with 256 feature slots and 4 keyframes.

- The stream: both nodelets take the same 13 numpy frames (GT depth
  folded into the stats); meshes, stats keys, poseframes and the
  trajectory are equal; per-frame integer stats exactly, float stats to
  1e-3 relative plus 1e-4 absolute (the total photometric error, a sum
  of near-zero residuals over the exactly rendered scene, plus 0.1); the
  final idepth maps to 1e-4 on the pixels both cover, which must be all
  but 0.5 % of either's.
- Host edits (poseframe_callback: pose update and pruning) and
  checkpoints are exact: the same carried state gives equal leaves.
- Patch-mode epipolar_update on a fixed input: status codes, dropouts,
  validity and the six counters exactly; mu and var to 1e-4 relative
  plus 1e-7 absolute (as line mode in tests/test_torch_ops.py).
- The truth harness: one ordinary frame and one poseframe through
  `update(..., idepths_truth=...)` from a carried state; integer leaves
  exactly, float leaves to 1e-4 absolute plus 1e-5 relative (as
  tests/test_torch_engine.py), stats as in the stream.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.frontends.nodelet import FlameNodelet as JNode
from flame_ros_tpu.frontends.nodelet import InputFrame as JInputFrame
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.models.engine import Flame as JFlame
from flame_ros_tpu.ops import epipolar as jep
from flame_ros_tpu.ops import pyramid as jpyr
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.frontends.nodelet import FlameNodelet as TNode
from flame_ros_torch.frontends.nodelet import Health
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, Flame,
                                           state_to_numpy)
from flame_ros_torch.ops import epipolar as tep
from flame_ros_torch.ops.detection import detect_features

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4}}
N_STREAM = 13


@pytest.fixture(scope="module")
def seq():
    """15 frames rendered once by the port's renderer, as numpy arrays
    that both packages take."""
    s = make_sequence(15, TCAM, motion="strafe", device="cpu")
    return dict(images=s.images.numpy(), depths=s.depths.numpy(),
                times=np.asarray(s.timestamps), q=s.poses.q.numpy(),
                t=s.poses.t.numpy())


def _feed(node, seq, n, **kw):
    for i in range(n):
        assert node.push_frame(i, float(seq["times"][i]), seq["q"][i],
                               seq["t"][i], seq["images"][i],
                               depth=seq["depths"][i], **kw)
        node.run_until_idle(idle_timeout=0.01)


@pytest.fixture(scope="module")
def streams(seq):
    """The JAX and the port nodelet over the same N_STREAM frames, with
    their meshes and stats records."""
    out = {}
    for name, node in (
            ("jax", JNode(JCAM, JParams.from_dict(SMALL),
                          eval_gt_depth=True)),
            ("torch", TNode(TCAM, TParams.from_dict(SMALL),
                            eval_gt_depth=True, device="cpu"))):
        meshes, stats = [], []
        node.on_mesh.append(lambda i, t, m, meshes=meshes: meshes.append(i))
        node.on_stats.append(stats.append)
        _feed(node, seq, N_STREAM)
        out[name] = (node, meshes, stats)
    return out


def _jax_state(st):
    out = {f"feat.{k}": np.asarray(v) for k, v in st.feat._asdict().items()}
    out.update({k: np.asarray(v) for k, v in st._asdict().items()
                if k != "feat"})
    return out


def _host_counters(e):
    return dict(num_poseframes=e._num_poseframes,
                frame_count=e._frame_count, kf_slot=e._kf_slot,
                max_frame_id=e._max_frame_id,
                installed_topo_wm=e._installed_topo_wm)


def _assert_leaves(a, b, what, exact=False):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, (what, k)
        if exact or a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=1e-5,
                                       err_msg=f"{what}: {k}")


def test_nodelet_stream_matches_jax(streams):
    jnode, jmeshes, jstats = streams["jax"]
    tnode, tmeshes, tstats = streams["torch"]
    assert tmeshes == jmeshes == list(range(N_STREAM))
    assert len(tstats) == len(jstats) == N_STREAM
    for jr, tr in zip(jstats, tstats):
        assert set(tr) == set(jr)
        assert tr["img_id"] == jr["img_id"]
        assert tr["queue_size"] == jr["queue_size"] == 0
        assert tr["latency_ms"] > 0 and tr["process_frame_ms"] > 0
        for k in DEVICE_STATS_KEYS:
            if k.startswith("num_") or k in ("true_pos", "true_neg",
                                             "false_pos", "false_neg"):
                assert tr[k] == jr[k], (tr["img_id"], k)
            else:
                atol = 0.1 if k == "total_photo_error" else 1e-4
                assert tr[k] == pytest.approx(jr[k], rel=1e-3, abs=atol), \
                    (tr["img_id"], k)
    assert tnode.engine.num_poseframes == jnode.engine.num_poseframes == 3
    assert [(i, t) for i, t, _ in tnode.trajectory] == \
        [(i, t) for i, t, _ in jnode.trajectory]
    for (_, _, tp), (_, _, jp) in zip(tnode.trajectory, jnode.trajectory):
        np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), atol=1e-6)
        np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-6)
    tm = tnode.engine.get_inverse_depth_map()
    jm = jnode.engine.get_inverse_depth_map()
    both = np.isfinite(tm) & np.isfinite(jm)
    assert (np.isfinite(tm) ^ np.isfinite(jm)).mean() <= 0.005
    assert both.mean() > 0.3
    np.testing.assert_allclose(tm[both], jm[both], atol=1e-4)
    assert tnode.health == Health.READY


def test_queue_drops_under_burst(seq):
    counts = []
    for node in (JNode(JCAM, JParams.from_dict(SMALL), queue_size=4),
                 TNode(TCAM, TParams.from_dict(SMALL), queue_size=4,
                       device="cpu")):
        accepted = sum(node.push_frame(i, float(seq["times"][i]),
                                       seq["q"][i], seq["t"][i],
                                       seq["images"][i]) for i in range(12))
        counts.append((accepted, node.queue.num_dropped, len(node.queue)))
    assert counts[0] == counts[1] == (4, 8, 4)
    node.run_until_idle(idle_timeout=0.01)
    assert node.engine._frame_count == 4 and len(node.queue) == 0


def test_angular_rate_gate(seq):
    p = {**SMALL, "output": {"max_angular_rate": 10.0}}   # deg/s
    jnode = JNode(JCAM, JParams.from_dict(p))
    tnode = TNode(TCAM, TParams.from_dict(p), device="cpu")
    published, stats = [], []
    tnode.on_mesh.append(lambda i, t, m: published.append(i))
    tnode.on_stats.append(stats.append)
    # Frame 0 at rest; frame 1 turned 1 rad about y in 1/30 s (gated);
    # frame 2 turned on by 1/30 degree (1 deg/s, published).
    tau = np.zeros((3, 6), np.float32)
    tau[1, 4] = 1.0
    tau[2, 4] = 1.0 + np.radians(1.0 / 30)
    jrates = []
    for i, x in enumerate(tau):
        pose = TSE3.exp(x)
        q, t, ti = pose.q.numpy(), pose.t.numpy(), i / 30
        jpose = JSE3.from_quat_trans(q, t)
        jrates.append(jnode._angular_rate(
            JInputFrame(i, ti, q, t, seq["images"][i]), jpose))
        jnode._last_pose = (ti, jpose)
        tnode.push_frame(i, ti, q, t, seq["images"][i])
    tnode.run_until_idle(idle_timeout=0.01)
    rates = [s["angular_rate_deg_s"] for s in stats]
    assert rates == pytest.approx(jrates, rel=1e-3, abs=1e-3)
    assert rates[1] > 1000 and 0.9 < rates[2] < 1.1
    assert [s["publish_gated"] for s in stats] == [r > 10 for r in jrates]
    assert published == [0, 2]


def test_poseframe_callback_edits_match_jax(streams, seq):
    jnode0 = streams["jax"][0]
    jnode = JNode(JCAM, JParams.from_dict(SMALL))
    jnode.engine.state = jnode0.engine.state
    tnode = TNode(TCAM, TParams.from_dict(SMALL), device="cpu")
    tnode.engine.load_state(_jax_state(jnode.engine.state))
    ids = [0, 6, 12]
    rng = np.random.default_rng(3)
    step = TSE3.exp((rng.normal(size=(3, 6)) * 0.01).astype(np.float32))
    moved = TSE3(torch.from_numpy(seq["q"][ids]),
                 torch.from_numpy(seq["t"][ids])) @ step
    mq, mt = moved.q.numpy(), moved.t.numpy()
    for keep in (ids, ids[1:]):
        k = [ids.index(i) for i in keep]
        jnode.poseframe_callback(keep, JSE3(jnp.asarray(mq[k]),
                                            jnp.asarray(mt[k])))
        tnode.poseframe_callback(keep, TSE3(torch.from_numpy(mq[k]),
                                            torch.from_numpy(mt[k])))
        _assert_leaves(_jax_state(jnode.engine.state),
                       state_to_numpy(tnode.engine.state), keep, exact=True)
    assert tnode._pf_subsample == jnode._pf_subsample == 6
    st = tnode.engine.state
    assert set(st.kf_ids[st.kf_valid].tolist()) == {6, 12}
    np.testing.assert_array_equal(st.kf_q[st.kf_valid].numpy(), mq[1:])
    dead = (st.kf_ids == 0).nonzero()[0].item()
    assert not (st.feat.valid & (st.feat.kf_idx == dead)).any()


def test_checkpoints_round_trip_and_load_jax(streams, tmp_path):
    jnode, tnode = streams["jax"][0], streams["torch"][0]
    fresh = Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
                  device="cpu")
    tnode.engine.save_checkpoint(str(tmp_path / "torch.npz"))
    fresh.load_checkpoint(str(tmp_path / "torch.npz"))
    _assert_leaves(state_to_numpy(tnode.engine.state),
                   state_to_numpy(fresh.state), "port->port", exact=True)
    host = ("num_poseframes", "frame_count", "kf_slot")
    assert [getattr(fresh, f"_{k}") for k in host] == \
        [getattr(tnode.engine, f"_{k}") for k in host]
    # The JAX package's checkpoint loads into the port leaf by leaf, and
    # the port's into the JAX package.
    jnode.engine.save_checkpoint(str(tmp_path / "jax.npz"))
    fresh.load_checkpoint(str(tmp_path / "jax.npz"))
    _assert_leaves(_jax_state(jnode.engine.state),
                   state_to_numpy(fresh.state), "jax->port", exact=True)
    assert [getattr(fresh, f"_{k}") for k in host] == \
        [getattr(jnode.engine, f"_{k}") for k in host]
    je = JFlame(W, H, cam=JCAM, params=JParams.from_dict(SMALL))
    je.load_checkpoint(str(tmp_path / "torch.npz"))
    _assert_leaves(state_to_numpy(tnode.engine.state), _jax_state(je.state),
                   "port->jax", exact=True)
    data = np.load(str(tmp_path / "torch.npz"))
    assert data["__bf16__"].size == 0
    with pytest.raises(ValueError, match="capacity"):
        Flame(W, H, cam=TCAM, params=TParams.from_dict(
            {"engine": {"max_features": 128, "max_keyframes": 4}}),
            device="cpu").load_checkpoint(str(tmp_path / "jax.npz"))


def test_epipolar_patch_mode_matches_jax(seq):
    img0 = seq["images"][0]
    uv, _, valid = detect_features(
        torch.from_numpy(img0), torch.zeros((H // 16, W // 16), dtype=bool),
        win_size=16, min_grad_mag=5.0)
    uv = uv[valid].numpy()
    n_slots, n = 64, len(uv)
    rng = np.random.default_rng(11)
    d = seq["depths"][0]
    gt = 1.0 / np.maximum(d[np.round(uv[:, 1]).astype(int),
                            np.round(uv[:, 0]).astype(int)], 1e-3)
    mu = np.full(n_slots, 0.4, np.float32)
    mu[:n] = gt * rng.uniform(0.8, 1.2, n)
    var = np.full(n_slots, 0.05, np.float32)
    var[: n // 2] = 0.25
    state = dict(
        uv_ref=np.pad(uv, ((0, n_slots - n), (0, 0))).astype(np.float32),
        kf_idx=np.zeros(n_slots, np.int32), mu=mu, var=var,
        dropouts=(np.arange(n_slots) % 7).astype(np.int32),
        valid=np.arange(n_slots) < n, frame_id=np.zeros(n_slots, np.int32))
    kf = np.asarray(jpyr.build_pyramid(jnp.asarray(img0), 3))[None]
    kf_pyrs = np.concatenate([kf, np.zeros_like(kf)])
    kf_q = np.stack([seq["q"][0]] * 2)
    kf_t = np.stack([seq["t"][0]] * 2)
    cur = np.asarray(jpyr.build_pyramid(jnp.asarray(seq["images"][3]), 3))
    args = (kf_pyrs, kf_q, kf_t, cur, seq["q"][3], seq["t"][3])
    for zero_mean in (False, True):
        kw = dict(num_samples=16, patch_size=5, num_levels=3, mode="patch",
                  zero_mean_ssd=zero_mean)
        jr = jep.epipolar_update(
            jep.FeatureFilterState(**{k: jnp.asarray(v)
                                      for k, v in state.items()}),
            *(jnp.asarray(a) for a in args), cam=JCAM, **kw)
        tr = tep.epipolar_update(
            tep.FeatureFilterState(**{k: torch.from_numpy(np.array(v))
                                      for k, v in state.items()}),
            *(torch.from_numpy(np.array(a)) for a in args), cam=TCAM, **kw)
        np.testing.assert_array_equal(tr.status.numpy(),
                                      np.asarray(jr.status))
        assert (tr.status.numpy() == tep.STATUS_OK).sum() > 5
        assert len(set(tr.status.tolist())) >= 3
        for k in jr.counts:
            assert int(tr.counts[k]) == int(jr.counts[k]), (zero_mean, k)
        for k in ("dropouts", "valid"):
            np.testing.assert_array_equal(getattr(tr.state, k).numpy(),
                                          np.asarray(getattr(jr.state, k)))
        for k in ("mu", "var"):
            np.testing.assert_allclose(getattr(tr.state, k).numpy(),
                                       np.asarray(getattr(jr.state, k)),
                                       rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(tr.uv_match.numpy(),
                                   np.asarray(jr.uv_match), atol=1e-3)


def test_truth_harness_update_matches_jax(streams, seq):
    je = JFlame(W, H, cam=JCAM, params=JParams.from_dict(SMALL))
    src = streams["jax"][0].engine
    je.state = src.state
    for k, v in _host_counters(src).items():
        setattr(je, f"_{k}", v)
    te = Flame(W, H, cam=TCAM, params=TParams.from_dict(SMALL),
               device="cpu")
    te.load_state(_jax_state(je.state), host=_host_counters(je))
    for i, is_pf in ((N_STREAM, False), (N_STREAM + 1, True)):
        d = seq["depths"][i]
        truth = np.where(d > 0, 1.0 / np.maximum(d, 1e-6),
                         0.0).astype(np.float32)
        q, t = seq["q"][i], seq["t"][i]
        assert je.update(float(seq["times"][i]), i,
                         JSE3(jnp.asarray(q), jnp.asarray(t)),
                         seq["images"][i], is_pf, idepths_truth=truth,
                         gt_depth=d)
        assert te.update(float(seq["times"][i]), i,
                         TSE3(torch.from_numpy(q), torch.from_numpy(t)),
                         seq["images"][i], is_pf, idepths_truth=truth,
                         gt_depth=d)
        _assert_leaves(_jax_state(je.state), state_to_numpy(te.state),
                       f"truth frame {i}")
        jr, tr = je.flush_stats(), te.flush_stats()
        for k in DEVICE_STATS_KEYS:
            atol = 0.1 if k == "total_photo_error" else 1e-4
            assert tr[k] == pytest.approx(jr[k], rel=1e-4, abs=atol), (i, k)
        np.testing.assert_array_equal(te.last_status, je.last_status)
        # The harness pins every live feature it can see to the truth.
        f = te.state.feat
        assert (f.var[f.valid] == 1e-6).float().mean() > 0.5
    assert te.num_poseframes == je.num_poseframes
    assert te._topo_installs == 1      # the poseframe's retriangulation
    jd, td = je.get_detections(), te.get_detections()
    np.testing.assert_array_equal(td[0], jd[0])
    np.testing.assert_array_equal(td[1], jd[1])
    for a, b in zip(te.get_raw_idepths(), je.get_raw_idepths()):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5)
