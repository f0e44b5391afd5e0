"""The port's direct tracker (`track_frame`) and tracking-mode frontend
(FlameNodelet(pose_source="tracking"), FlameServer, the runner's
--pose-source tracking) held against the JAX package's on the CPU, at
96x128 on frames of a 30-frame strafe trajectory rendered by the port's
renderer (30 fps inter-frame motion).

- `track_frame` (4 levels, 2048 points, the nodelet's settings) on the
  same numpy pyramids: an identity init, a motion-model init and an
  exposure-drifted pair, each with `estimate_affine` True and False. q
  and t to 1e-4, gain and offset to 1e-3, n_valid and n_inliers exactly,
  final_cost to 1e-4 relative (reached: q and t within 1e-6, offset
  within 1e-4).
- The stream: both nodelets (256 feature slots, 4 keyframes, a poseframe
  every 3rd frame, so that the pose graph runs: its fourth node, frame
  9, optimizes the window; windowed BA on every poseframe from the
  third keyframe on, anchored on the keyframe owning the most features)
  take the same 13 numpy frames, depth on frame 0 only. The same frames
  enter the trajectory, the same frames become poseframes, the poses
  agree to 1e-3 (reached: ~1e-4), the engine's keyframe poses after the
  pose-graph and BA corrections to 1e-3, the accepted track costs to
  1e-3 relative, BA runs as often in both (at least twice) with its
  costs to 1e-3 relative, and the failure and relocalization counts
  are equal.
- Occlusion (no BA): frames 5-8 replaced by white flashes. The same
  frames fail (every occluded one, and none enters the trajectory) and
  the failure and relocalization counts are equal. The recovery
  alignment runs from a seed coasted over five frames, where f32 order
  noise flips points across the Huber and bounds masks, so the poses
  after it are not held to the clean stream's 1e-3.
- `optimize_pose_graph` on the three cases of tests/test_pose_graph.py,
  each at the shape of the stream's window solve (4 nodes, 3 edges, 5
  iterations) so that its JAX compile is reused: a noisy chain, a gauge
  case (consistent measurements) and an invalid edge (the garbage third
  edge of the triangle case, masked; the fourth node has no edge). q and
  t to 1e-5 against the JAX CPU (LAPACK) result, final costs to 1e-8
  absolute, and the JAX test's own bounds; the `jacfwd` Jacobian at zero
  perturbation has no NaN and equals `jax.jacfwd`'s to 1e-5 (the gauge
  case has every residual ~0, where `SE3.log`'s safe branches matter).
- `ring_relocalize` on the JAX nodelet's engine state carried across
  (`state_from_numpy`): the same argmin slot, costs to 1e-4 relative,
  equal feature counts; and the nodelet's BA step on that state:
  `gather_ba_inputs` bit for bit, `hybrid_bundle_adjust` (rounds=1, the
  nodelet's schedule) on the ring rolled to the gauge, q, t and idepths
  to 1e-4, the final cost to 1e-4 relative.
- The server in tracking mode: frames sent with no pose, a stats record
  with the tracking fields returned for each.
- Runner `main --pose-source tracking --device cpu`, with and without
  `--ba-refine`: its JSON keys equal the JAX `main`'s.
"""
import contextlib
import io
import json
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import flame_ros_tpu.frontends.offline_runner as jrunner
from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.frontends.nodelet import FlameNodelet as JNode
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.models import ba as jba
from flame_ros_tpu.models import pose_graph as jpg
from flame_ros_tpu.models import tracking as jtr
from flame_ros_tpu.models.tracking import ring_relocalize as j_reloc
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_trajectory, render_frame
from flame_ros_torch.frontends.nodelet import FlameNodelet as TNode
from flame_ros_torch.frontends.offline_runner import main
from flame_ros_torch.frontends.serve import FlameServer, recv_msg, send_msg
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models import ba as tba
from flame_ros_torch.models import pose_graph as tpg
from flame_ros_torch.models import tracking as ttr
from flame_ros_torch.models.engine import state_from_numpy, state_to_numpy
from flame_ros_torch.models.tracking import ring_relocalize as t_reloc
from flame_ros_torch.ops.pyramid import build_pyramid

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": 3}}
# Windowed BA in the clean stream. At this size a new keyframe owns only
# 8-17 features, under the 24 a solve needs, so the gauge is the keyframe
# owning the most.
SMALL_BA = dict(SMALL, pose_tracking={"ba_anchor": "most_owned"})
N_STREAM = 13
IDENT = (np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32))
OCCLUDED = range(5, 9)


@pytest.fixture(scope="module")
def seq():
    """The first N_STREAM frames of a 30-frame trajectory, rendered once
    by the port's renderer, as numpy arrays that both packages take."""
    poses = make_trajectory(30, "strafe", device="cpu")
    frames = [render_frame(TCAM, poses.q[i], poses.t[i])
              for i in range(N_STREAM)]
    return dict(images=np.stack([g.numpy() for g, _ in frames]),
                depths=np.stack([d.numpy() for _, d in frames]),
                times=np.arange(N_STREAM) / 30.0,
                q=poses.q.numpy()[:N_STREAM], t=poses.t.numpy()[:N_STREAM])


def _pyr(img):
    return build_pyramid(torch.from_numpy(np.ascontiguousarray(img)),
                         4).numpy()


def _rel(seq, i, j):
    """GT T_rc from frame i's camera to frame j's."""
    Ti = JSE3(jnp.asarray(seq["q"][i]), jnp.asarray(seq["t"][i]))
    Tj = JSE3(jnp.asarray(seq["q"][j]), jnp.asarray(seq["t"][j]))
    r = Tj.inverse() @ Ti
    return np.array(r.q), np.array(r.t)


def test_track_frame_matches_jax(seq):
    d0 = seq["depths"][0]
    idepth = np.where(d0 > 0, 1.0 / np.maximum(d0, 1e-6),
                      np.nan).astype(np.float32)
    ref = _pyr(seq["images"][0])
    drifted = np.clip(1.2 * seq["images"][1] + 15.0, 0,
                      255).astype(np.float32)
    cases = (("identity", _pyr(seq["images"][1]), IDENT),
             ("motion_model", _pyr(seq["images"][3]), _rel(seq, 0, 2)),
             ("exposure", _pyr(drifted), IDENT))
    for affine in (True, False):
        for name, cur, (q0, t0) in cases:
            j = jtr.track_frame(jnp.asarray(ref), jnp.asarray(idepth),
                                jnp.asarray(cur), jnp.asarray(q0),
                                jnp.asarray(t0), cam=JCAM, num_levels=4,
                                estimate_affine=affine)
            t = ttr.track_frame(torch.from_numpy(ref),
                                torch.from_numpy(idepth),
                                torch.from_numpy(cur), torch.from_numpy(q0),
                                torch.from_numpy(t0), cam=TCAM,
                                num_levels=4, estimate_affine=affine)
            what = f"{name}, estimate_affine={affine}"
            for k, tol in (("q", 1e-4), ("t", 1e-4), ("gain", 1e-3),
                           ("offset", 1e-3)):
                np.testing.assert_allclose(getattr(t, k).numpy(),
                                           np.asarray(getattr(j, k)),
                                           rtol=0, atol=tol, err_msg=what)
            for k in ("n_valid", "n_inliers"):
                assert int(getattr(t, k)) == int(getattr(j, k)), (what, k)
            np.testing.assert_allclose(float(t.final_cost),
                                       float(j.final_cost), rtol=1e-4,
                                       err_msg=what)
            # The gate's host copy holds the same numbers.
            h = t.to_host()
            assert float(h.final_cost) == float(t.final_cost)
            assert int(h.n_valid) == int(t.n_valid)
            assert torch.equal(h.q, t.q) and torch.equal(h.t, t.t)
            if name == "identity" and affine:
                # The GT-depth alignment recovers the inter-frame motion.
                tq, tt = _rel(seq, 0, 1)
                assert np.abs(t.t.numpy() - tt).max() < 0.01


def _stream(node, seq, occluded=()):
    stats = []
    node.on_stats.append(stats.append)
    for i in range(N_STREAM):
        g = seq["images"][i]
        if i in occluded:
            g = np.full_like(g, 250.0)
        assert node.push_frame(i, float(seq["times"][i]), gray=g,
                               depth=seq["depths"][i] if i == 0 else None)
        node.run_until_idle(idle_timeout=0.01)
    return node, stats


def _pair(seq, occluded=(), params=SMALL):
    ba = params is SMALL_BA
    return {"jax": _stream(JNode(JCAM, JParams.from_dict(params),
                                 pose_source="tracking", ba_refine=ba,
                                 eval_gt_depth=True), seq, occluded),
            "torch": _stream(TNode(TCAM, TParams.from_dict(params),
                                   pose_source="tracking", ba_refine=ba,
                                   eval_gt_depth=True, device="cpu"),
                             seq, occluded)}


@pytest.fixture(scope="module")
def streams(seq):
    return _pair(seq, params=SMALL_BA)


@pytest.fixture(scope="module")
def occluded(seq):
    return _pair(seq, OCCLUDED)


def _ids(node):
    return [i for i, _, _ in node.trajectory]


def test_tracking_stream_matches_jax(streams):
    (jn, js), (tn, ts) = streams["jax"], streams["torch"]
    assert _ids(tn) == _ids(jn) == list(range(N_STREAM))
    assert [i for i, _ in tn._pg_nodes] == [i for i, _ in jn._pg_nodes] \
        == [0, 3, 6, 9, 12]
    assert tn.engine.num_poseframes == jn.engine.num_poseframes == 5
    # The keyframe ring after the pose-graph correction at frame 9.
    tst = state_to_numpy(tn.engine.state)
    jst = jn.engine.state
    np.testing.assert_array_equal(tst["kf_ids"], np.asarray(jst.kf_ids))
    for k in ("kf_q", "kf_t"):
        np.testing.assert_allclose(tst[k], np.asarray(getattr(jst, k)),
                                   atol=1e-3, err_msg=k)
    for (_, _, tp), (_, _, jp) in zip(tn.trajectory, jn.trajectory):
        np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), atol=1e-3)
        np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-3)
    np.testing.assert_allclose(tn.track_costs, jn.track_costs, rtol=1e-3)
    # Windowed BA ran on the same poseframes, with the same costs.
    assert len(tn.ba_costs) == len(jn.ba_costs) >= 2
    np.testing.assert_allclose(tn.ba_costs, jn.ba_costs, rtol=1e-3)
    assert (tn.n_track_failed_frames, tn.n_relocalizations) == \
        (jn.n_track_failed_frames, jn.n_relocalizations) == (0, 0)
    assert [r["img_id"] for r in ts] == [r["img_id"] for r in js]
    for jr, tr in zip(js, ts):
        assert set(tr) == set(jr), tr["img_id"]
        if "track_cost" in jr:
            assert tr["track_n_valid"] == jr["track_n_valid"]
            assert tr["track_cost"] == pytest.approx(jr["track_cost"],
                                                     rel=1e-3)


def test_tracking_occlusion_matches_jax(occluded):
    (jn, js), (tn, ts) = occluded["jax"], occluded["torch"]

    def failed(stats):
        return [r["img_id"] for r in stats if r.get("tracking_failed")]

    assert failed(ts) == failed(js) == list(OCCLUDED)
    assert _ids(tn) == _ids(jn)
    assert not set(_ids(tn)) & set(OCCLUDED)
    assert (tn.n_track_failed_frames, tn.n_relocalizations) == \
        (jn.n_track_failed_frames, jn.n_relocalizations)
    assert tn.n_track_failed_frames == len(OCCLUDED)
    assert tn.engine.num_failed_frames == jn.engine.num_failed_frames == 0


def test_ring_relocalize_matches_jax(streams, seq):
    jn = streams["jax"][0]
    st = jn.engine.state
    d = {f"feat.{k}": np.asarray(v) for k, v in st.feat._asdict().items()}
    d.update({k: np.asarray(v) for k, v in st._asdict().items()
              if k != "feat"})
    ts = state_from_numpy(d, "cpu")
    cur = build_pyramid(torch.from_numpy(seq["images"][10]), 4)
    _, _, guess = jn.trajectory[8]
    gq, gt = np.asarray(guess.q), np.asarray(guess.t) + 0.03
    jq, jt, jc, jcount = j_reloc(
        st.kf_pyrs, st.kf_q, st.kf_t, st.kf_valid, st.feat.uv_ref,
        st.feat.mu, st.feat.valid, st.feat.kf_idx, jnp.asarray(cur.numpy()),
        jnp.asarray(gq), jnp.asarray(gt), cam=JCAM, step=0.05, n_steps=3,
        iters=4)   # the nodelet's arguments: its compile is reused
    tq, tt, tc, tcount = t_reloc(
        ts.kf_pyrs, ts.kf_q, ts.kf_t, ts.kf_valid, ts.feat.uv_ref,
        ts.feat.mu, ts.feat.valid, ts.feat.kf_idx, cur,
        torch.from_numpy(gq), torch.from_numpy(gt), cam=TCAM, step=0.05,
        n_steps=3, iters=4)
    jc, tc = np.asarray(jc), tc.numpy()
    assert np.isfinite(jc).sum() >= 2
    assert int(np.argmin(tc)) == int(np.argmin(jc))
    np.testing.assert_array_equal(np.isfinite(tc), np.isfinite(jc))
    fin = np.isfinite(jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-4)
    np.testing.assert_array_equal(tcount.numpy(), np.asarray(jcount))
    np.testing.assert_allclose(tq.numpy()[fin], np.asarray(jq)[fin],
                               atol=1e-4)
    np.testing.assert_allclose(tt.numpy()[fin], np.asarray(jt)[fin],
                               atol=1e-4)

    # The nodelet's BA step on the same state: the packed gather bit for
    # bit, then the solve on the ring rolled to the gauge (the nodelet's
    # arguments, so the stream's JAX compiles are reused).
    P = TParams.from_dict(SMALL).pose_tracking.ba_budget
    jbuf = np.asarray(jba.gather_ba_inputs(
        st.kf_valid, st.kf_ids, st.feat.valid, st.feat.kf_idx,
        st.feat.uv_ref, st.feat.mu, budget=P, anchor="most_owned"))
    tpk = tba.gather_ba_inputs(ts.kf_valid, ts.kf_ids, ts.feat.valid,
                               ts.feat.kf_idx, ts.feat.uv_ref, ts.feat.mu,
                               budget=P, anchor="most_owned")
    np.testing.assert_array_equal(tpk.numpy(), jbuf)
    K = int(ts.kf_valid.shape[0])
    ref = int(jbuf[2 * K])
    off = 2 * K + 2
    pts = (jbuf[off:off + 2 * P].reshape(P, 2), jbuf[off + 2 * P:off + 3 * P],
           jbuf[off + 3 * P:] > 0.5)
    assert int(jbuf[2 * K + 1]) >= 24 and (jbuf[:K] > 0.5).sum() >= 3
    kw = dict(rounds=1, num_iters=4, coarse_iters=2, level=1)
    jres = jba.hybrid_bundle_adjust(
        *(jnp.roll(a, -ref, axis=0) for a in (st.kf_pyrs, st.kf_q, st.kf_t,
                                              st.kf_valid)),
        *(jnp.asarray(a) for a in pts), cam=JCAM, **kw)
    tres = tba.hybrid_bundle_adjust(
        *(torch.roll(a, -ref, 0) for a in (ts.kf_pyrs, ts.kf_q, ts.kf_t,
                                           ts.kf_valid)),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in pts), cam=TCAM,
        **kw)
    for k in ("q", "t", "idepths"):
        np.testing.assert_allclose(getattr(tres, k).numpy(),
                                   np.asarray(getattr(jres, k)), rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(tres.final_cost),
                               float(jres.final_cost), rtol=1e-4)


def _chain(rng, K):
    taus = rng.normal(0, 0.3, (K - 1, 6)).astype(np.float32)
    poses = [JSE3.identity()]
    for k in range(K - 1):
        poses.append(poses[-1] @ JSE3.exp(jnp.asarray(taus[k])))
    return (np.stack([np.asarray(p.q) for p in poses]),
            np.stack([np.asarray(p.t) for p in poses]))


def _meas(q, t, edges):
    out = []
    for i, j in edges:
        r = (JSE3(jnp.asarray(q[i]), jnp.asarray(t[i])).inverse()
             @ JSE3(jnp.asarray(q[j]), jnp.asarray(t[j])))
        out.append((np.asarray(r.q), np.asarray(r.t)))
    return map(np.stack, zip(*out))


def _graph_cases(rng):
    """(name, init q, t, edges, meas q, t, edge_valid, true q, t), all
    with 4 nodes and 3 edges."""
    K, chain = 4, [(0, 1), (1, 2), (2, 3)]
    q, t = _chain(rng, K)
    mq, mt = _meas(q, t, chain)
    nq, nt = [q[0]], [t[0]]
    for k in range(1, K):
        d = JSE3.exp(jnp.asarray(rng.normal(0, 0.05, 6).astype(np.float32)))
        Tk = JSE3(jnp.asarray(q[k]), jnp.asarray(t[k])) @ d
        nq.append(np.asarray(Tk.q))
        nt.append(np.asarray(Tk.t))
    yield ("noisy_chain", np.stack(nq), np.stack(nt), chain, mq, mt, None,
           q, t)
    q, t = _chain(rng, K)
    mq, mt = _meas(q, t, chain)
    yield "gauge", q, t, chain, mq, mt, None, q, t
    q, t = _chain(rng, K)
    tri = [(0, 1), (1, 2), (0, 2)]
    mq, mt = _meas(q, t, tri)
    g = JSE3.exp(jnp.asarray(np.ones(6, np.float32)))
    mq[2], mt[2] = np.asarray(g.q), np.asarray(g.t)
    yield "invalid_edge", q, t, tri, mq, mt, [True, True, False], q, t


def test_pose_graph_matches_jax(rng, streams):
    jac = jax.jit(jax.jacfwd(jpg._residuals))
    for (name, q, t, edges, mq, mt, ev, tq, tt) in _graph_cases(rng):
        jg = jpg.make_graph(JSE3(jnp.asarray(q), jnp.asarray(t)), edges,
                            JSE3(jnp.asarray(mq), jnp.asarray(mt)),
                            edge_valid=ev)
        tg = tpg.make_graph(TSE3(torch.from_numpy(q), torch.from_numpy(t)),
                            edges, TSE3(torch.from_numpy(mq),
                                        torch.from_numpy(mt)),
                            edge_valid=ev)
        # The Jacobian at zero perturbation: finite, equal to jax.jacfwd.
        J = torch.func.jacfwd(lambda x: tpg._residuals(x, tg))(
            torch.zeros((4, 6)))
        assert not torch.isnan(J).any(), name
        np.testing.assert_allclose(J.numpy(),
                                   np.asarray(jac(jnp.zeros((4, 6)), jg)),
                                   rtol=0, atol=1e-5, err_msg=name)
        # num_iters=5, as the nodelet's window solve.
        jq, jt, jc = jpg.optimize_pose_graph(jg, num_iters=5)
        oq, ot, oc = tpg.optimize_pose_graph(tg, num_iters=5)
        np.testing.assert_allclose(oq.numpy(), np.asarray(jq), atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(ot.numpy(), np.asarray(jt), atol=1e-5,
                                   err_msg=name)
        assert abs(float(oc) - float(jc)) < 1e-8, (name, oc, jc)
        assert float(oc) < (1e-8 if name == "noisy_chain" else 1e-9), name
        if name == "noisy_chain":
            for k in range(4):
                d = (TSE3(oq[k], ot[k]).inverse()
                     @ TSE3(torch.from_numpy(tq[k]), torch.from_numpy(tt[k])))
                assert float(torch.linalg.vector_norm(d.log())) < 1e-3
        if name == "gauge":
            np.testing.assert_allclose(ot[0].numpy(), tt[0], atol=1e-5)


def test_server_tracking_mode(seq):
    srv = FlameServer(TCAM, TParams.from_dict(SMALL), port=0, device="cpu",
                      pose_source="tracking")
    srv.start()
    try:
        c = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        imgs = np.clip(seq["images"], 0, 255).astype(np.uint8)
        for i in range(4):
            send_msg(c, {"type": "frame", "img_id": i,
                         "time": float(seq["times"][i]),
                         "shape": [H, W], "dtype": "uint8"},
                     imgs[i].tobytes())
        stats = []
        while len(stats) < 4:
            h, _ = recv_msg(c)
            assert h is not None, "server closed early"
            stats.append(h)
        assert [h["img_id"] for h in stats] == list(range(4))
        assert all(h["type"] == "stats" for h in stats)
        # Frame 0 bootstraps the tracker; every later record carries the
        # tracking fields, failed or not (no depth came with frame 0, so
        # the first alignments run against a flat prior).
        for h in stats[1:]:
            assert {"tracking_failed", "track_cost", "track_n_valid"} <= \
                set(h), h
        ok = [h["img_id"] for h in stats if not h.get("tracking_failed")]
        assert [i for i, _, _ in srv.node.trajectory] == ok
        assert ok[0] == 0
        c.close()
    finally:
        srv.stop()


def test_runner_tracking_cli_keys(monkeypatch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(["--dataset", "synthetic", "--frames", "3",
                    "--pose-source", "tracking", "--device", "cpu"])
    keys = set(json.loads(out.getvalue().strip().splitlines()[-1]))
    assert res.frames_processed >= 1
    # The JAX main's key set, without its run: no frames, default result.
    monkeypatch.setattr(jrunner, "_build_frames", lambda args: ([], JCAM))
    monkeypatch.setattr(jrunner, "run_offline_tracking",
                        lambda *a, **k: jrunner.RunResult())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jrunner.main(["--dataset", "synthetic", "--frames", "3",
                      "--pose-source", "tracking"])
    assert keys == set(json.loads(out.getvalue().strip().splitlines()[-1]))
    # --ba-refine runs, with the same keys.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(["--dataset", "synthetic", "--frames", "3",
                    "--pose-source", "tracking", "--ba-refine", "--device",
                    "cpu"])
    assert res.frames_processed >= 1
    assert keys == set(json.loads(out.getvalue().strip().splitlines()[-1]))
    for bad in (["--window", "6"], ["--pose-noise-sigma", "0.01"]):
        with pytest.raises(SystemExit):
            main(["--dataset", "synthetic", "--frames", "3",
                  "--pose-source", "tracking", "--device", "cpu", *bad])
