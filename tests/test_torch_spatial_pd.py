"""The port's spatially partitioned NLTGV2 sweep (flame_ros_torch/
parallel/spatial_pd.py) and the multi-stream runner on a part layout,
held against the JAX package's on the CPU and against the port's own
unsharded sweep and runner. Part layouts name the CPU several times
(["cpu"] * P); the JAX side runs on the CPU device mesh conftest.py
makes.

- `build_spatial_partition` on the graph of tests/test_spatial_pd.py:43
  (a padded Delaunay graph of 204 random points in 256 slots): every
  array equal to the JAX package's bit for bit, P = 2 and 4; the layout
  conversions (`partition_edges` equal to JAX's, and the round trips
  through `unpartition_edges`/`unpartition_vertex`).
- `pd_iterate_spatial`, P = 2 and 4, 1 and 10 sweeps, against JAX's
  `pd_iterate_spatial` to 1e-6 (the JAX test's bound), and against the
  port's unsharded `pd_iterate`: with the partition's own edge geometry
  (host numpy) within 1e-6 (measured 1.2e-7: numpy's norm and
  reciprocal give alpha 1 ulp away from torch's on ~5 % of the edges),
  and with the geometry rebuilt by the port's `build_topology` from the
  same positions bit for bit. Every replica of a boundary edge holds the
  same dual.
- `pd_iterate_spatial_batched`, two streams, P = 2 and 4, gate_tol 0
  and 1e-4, against JAX's to 1e-6 and against the unsharded
  `pd_iterate` under vmap bit for bit.
- The runner with engine.spatial_parts=2 on [["cpu", "cpu"]], two
  streams (stream 1 one frame behind), 13 frames at 96x128 with 256
  feature slots (3 topology installs), against the port's plain runner
  (every state leaf bit for bit) and against the JAX package's spatial
  runner with tests/test_multi_stream.py:196-243's bounds: maps 1e-4,
  vtx_x and edge_q 1e-5, vtx_in_graph equal, stats rtol 1e-3. A part
  layout whose width is not spatial_parts raises.
- Resuming a spatial checkpoint: the JAX spatial runner's file, saved
  after frame 8 of its uninterrupted run, loaded into a fresh JAX runner
  and into a fresh port runner (the JAX NPZ layout), both continued to
  frame 13. At load each re-triangulates every stream from the restored
  vertex positions and graph membership at watermark `_max_frame_id`
  (flame_ros_tpu/parallel/multi_stream.py:689-693): the installed
  topology equal to JAX's bit for bit, and the resumed port held to the
  resumed JAX run with the bounds above. Where JAX's resumed run differs
  from the uninterrupted one by more than a bound, so must the port's
  (a load that kept the restored edges equals the uninterrupted run).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flame_ros_tpu.config import FlameParams as JParams
from flame_ros_tpu.geometry.camera import Pinhole as JCam
from flame_ros_tpu.geometry.se3 import SE3 as JSE3
from flame_ros_tpu.ops import nltgv2 as jreg
from flame_ros_tpu.parallel import multi_stream as jms
from flame_ros_tpu.parallel import spatial_pd as jsp
from flame_ros_torch.config import FlameParams as TParams
from flame_ros_torch.datasets.synthetic import make_sequence
from flame_ros_torch.geometry.camera import Pinhole as TCam
from flame_ros_torch.geometry.se3 import SE3 as TSE3
from flame_ros_torch.models.engine import state_leaves
from flame_ros_torch.ops import nltgv2 as treg
from flame_ros_torch.parallel import multi_stream as tms
from flame_ros_torch.parallel import spatial_pd as tsp

from test_spatial_pd import _random_delaunay

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W = 96, 128
JCAM = JCam(105.0, 105.0, 63.5, 47.5, W, H)
TCAM = TCam(105.0, 105.0, 63.5, 47.5, W, H)
SMALL = {"engine": {"max_features": 256, "max_keyframes": 4},
         "input": {"poseframe_subsample_factor": 6}}
N_FRAMES = 13
SAVE_AT = 8


@pytest.fixture(scope="module")
def graph():
    edges, ev, uv, vvalid, _ = _random_delaunay()
    V = len(uv)
    inc_e, inc_s, keep = jreg.build_incidence(edges, ev, V, max_degree=16)
    ev = ev & keep
    rng = np.random.default_rng(1)
    z = np.where(vvalid, rng.uniform(0.2, 2.0, V), 0.0).astype(np.float32)
    lam = np.where(vvalid, 1.0, 0.0).astype(np.float32)
    return edges, ev, uv, vvalid, inc_e, inc_s, z, lam


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unsharded(graph, z, iters, gate_tol=0.0):
    edges, ev, uv, vvalid, inc_e, inc_s, _, lam = graph
    top = treg.build_topology(_t(edges), _t(ev), _t(uv), inc_edges=_t(inc_e),
                              inc_sign=_t(inc_s))
    V, E = len(uv), len(edges)
    zt = _t(z)
    gs = treg.GraphState(x=zt, w=torch.zeros(V, 2), q=torch.zeros(E, 3),
                         x_bar=zt, w_bar=torch.zeros(V, 2))
    return treg.pd_iterate(gs, top, zt, _t(lam), _t(vvalid),
                           num_iters=iters, gate_tol=gate_tol)


def test_partition_bit_exact(graph):
    edges, ev, uv, vvalid = graph[:4]
    for n_parts in (2, 4):
        j = jsp.build_spatial_partition(edges, ev, uv, vvalid, n_parts)
        t = tsp.build_spatial_partition(edges, ev, uv, vvalid, n_parts)
        for f in tsp.SpatialPartition._fields:
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (n_parts, f)
        # The layout conversions, on tensors, against JAX's.
        qe = np.random.default_rng(n_parts).normal(size=(len(edges), 3)) \
            .astype(np.float32)
        qp = tsp.partition_edges(t, _t(qe))
        np.testing.assert_array_equal(qp.numpy(), np.asarray(
            jsp.partition_edges(j, jnp.asarray(qe))))
        back = tsp.unpartition_edges(t, qp, len(edges))
        assert torch.equal(back[_t(ev)], _t(qe)[_t(ev)])
        assert not back[~_t(ev)].any()
        xv = _t(uv)
        assert torch.equal(tsp.unpartition_vertex(
            t, tsp.partition_vertex(t, xv)), xv)


def test_pd_iterate_spatial_matches_jax_and_unsharded(graph):
    edges, ev, uv, vvalid, inc_e, inc_s, z, lam = graph
    V, E = len(uv), len(edges)
    xw0 = np.zeros((V, 3), np.float32)
    xw0[:, 0] = z
    for n_parts in (2, 4):
        part = tsp.build_spatial_partition(edges, ev, uv, vvalid, n_parts)
        devs = ["cpu"] * n_parts
        pdev = tsp.shard_partition(devs, part)
        # The same sweep with the edge geometry rebuilt by the port's
        # build_topology from the parts' extended positions.
        uv_ext = tsp._exchange(devs, [e.long() for e in pdev.export_idx],
                               list(_t(tsp.partition_vertex(part, uv))),
                               False)
        tops = [treg.build_topology(pdev.edges_l[p], pdev.edge_valid_l[p],
                                    uv_ext[p]) for p in range(n_parts)]
        pgeo = pdev._replace(dp=tuple(t.dp for t in tops),
                             alpha=tuple(t.alpha for t in tops),
                             beta=tuple(t.beta for t in tops))
        args = [_t(tsp.partition_vertex(part, a)) for a in (xw0, z, lam,
                                                            vvalid)]
        q0 = torch.zeros(part.edge_gid.shape + (3,))
        mesh = Mesh(np.asarray(jax.devices()[:n_parts]), ("part",))
        jpdev = jsp.shard_partition(mesh, part)
        for iters in (1, 10):
            ref = _unsharded(graph, z, iters)
            xw, q = tsp.pd_iterate_spatial(devs, pdev, args[0], q0, *args[1:],
                                           num_iters=iters)
            jx, jq = jsp.pd_iterate_spatial(
                mesh, jpdev, *(jnp.asarray(a.numpy()) for a in args[:1]),
                jnp.zeros(q0.shape, jnp.float32),
                *(jnp.asarray(a.numpy()) for a in args[1:]), num_iters=iters)
            xw, q = torch.stack(xw), torch.stack(q)
            np.testing.assert_allclose(xw.numpy(), np.asarray(jx), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0,
                                       atol=1e-6)
            xb = tsp.unpartition_vertex(part, xw)
            qb = tsp.unpartition_edges(part, q, E)
            live = _t(vvalid)
            for a, b in ((xb[live, 0], ref.x[live]),
                         (xb[live, 1:], ref.w[live]), (qb[_t(ev)],
                                                       ref.q[_t(ev)])):
                assert float((a - b).abs().max()) <= 1e-6, (n_parts, iters)
            xw, q = tsp.pd_iterate_spatial(devs, pgeo, args[0], q0, *args[1:],
                                           num_iters=iters)
            xw, q = torch.stack(xw), torch.stack(q)
            assert torch.equal(tsp.unpartition_vertex(part, xw),
                               torch.cat([ref.x[:, None], ref.w], -1))
            assert torch.equal(tsp.unpartition_edges(part, q, E), ref.q)
        # Replicated boundary duals stay equal (after 10 sweeps).
        seen, n_rep = {}, 0
        for p in range(n_parts):
            for k, g in enumerate(part.edge_gid[p]):
                if g < 0:
                    continue
                if g in seen:
                    n_rep += 1
                    assert torch.equal(q[p, k], seen[g])
                seen[g] = q[p, k]
        assert n_rep > 0


def test_pd_iterate_spatial_batched_matches_jax_and_unsharded(graph):
    """Two streams (the graph, its positions shifted and a quarter of its
    edges stale in stream 1), the current-position geometry and the
    per-frame live mask of the engine's sweep."""
    edges, ev, uv, vvalid, inc_e, inc_s, z, lam = graph
    V, E = len(uv), len(edges)
    S = 2
    rng = np.random.default_rng(4)
    uv_s = np.stack([uv, uv + rng.normal(0, 0.5, uv.shape)]).astype(
        np.float32)
    live_s = np.stack([ev, ev & (rng.random(E) > 0.25)])
    z_s = np.stack([z, z * 1.1]).astype(np.float32)
    lam_s = np.stack([lam, lam])
    vv_s = np.stack([vvalid, vvalid])
    xw0 = np.zeros((S, V, 3), np.float32)
    xw0[..., 0] = z_s
    for n_parts in (2, 4):
        part = tsp.build_spatial_partition(edges, ev, uv, vvalid, n_parts)
        st = tsp.stack_partitions([part] * S)
        devs = ["cpu"] * n_parts
        pdev = tsp.shard_partition(devs, st, batched=True, geometry=False)
        order = st.vtx_order
        gid = np.maximum(st.edge_gid, 0)
        take = lambda a, idx: np.stack([a[s][idx[s]] for s in range(S)])
        xw_p, uv_p = take(xw0, order), take(uv_s, order)
        z_p, lam_p, vm_p = (take(a, order) for a in (z_s, lam_s, vv_s))
        el_p = take(live_s, gid) & st.edge_valid_l
        q_p = np.zeros(gid.shape + (3,), np.float32)
        mesh = jms.make_mesh(jax.devices()[:S * n_parts], parts=n_parts)
        jparts = jsp.SpatialPartition(
            *(None if f in ("dp", "alpha", "beta") else jnp.asarray(a)
              for f, a in zip(tsp.SpatialPartition._fields, st)))
        per = lambda a: [_t(a[:, p]) for p in range(n_parts)]
        for gate in (0.0, 1e-4):
            xw, q = tsp.pd_iterate_spatial_batched(
                devs, pdev, per(xw_p), per(q_p), per(el_p), per(uv_p),
                per(z_p), per(lam_p), per(vm_p), num_iters=10,
                gate_tol=gate)
            xw, q = torch.stack(xw, 1), torch.stack(q, 1)
            jx, jq = jsp.pd_iterate_spatial_batched(
                mesh, jparts, *(jnp.asarray(a) for a in (
                    xw_p, q_p, el_p, uv_p, z_p, lam_p, vm_p)),
                num_iters=10, gate_tol=gate)
            np.testing.assert_allclose(xw.numpy(), np.asarray(jx), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0,
                                       atol=1e-6)

            def unsharded(e_live, pos, zz, ll, vm):
                top = treg.build_topology(_t(edges), e_live, pos,
                                          inc_edges=_t(inc_e),
                                          inc_sign=_t(inc_s))
                gs = treg.GraphState(x=zz, w=torch.zeros(V, 2),
                                     q=torch.zeros(E, 3), x_bar=zz,
                                     w_bar=torch.zeros(V, 2))
                out = treg.pd_iterate(gs, top, zz, ll, vm, num_iters=10,
                                      gate_tol=gate)
                return torch.cat([out.x[:, None], out.w], -1), out.q

            rx, rq = torch.func.vmap(unsharded)(
                _t(live_s), _t(uv_s), _t(z_s), _t(lam_s), _t(vv_s))
            for s in range(S):
                sp = part._replace(edge_gid=st.edge_gid[s])
                assert torch.equal(tsp.unpartition_vertex(sp, xw[s]), rx[s])
                assert torch.equal(tsp.unpartition_edges(sp, q[s], E), rq[s])


@pytest.fixture(scope="module")
def frames():
    s = make_sequence(N_FRAMES, TCAM, motion="strafe", device="cpu")
    return dict(imgs=torch.clamp(s.images, 0, 255).to(torch.uint8).numpy(),
                ts=s.timestamps, q=s.poses.q.numpy(), t=s.poses.t.numpy())


def _frames(fr, i, se3):
    return [(float(fr["ts"][k]), k, se3(fr["q"][k], fr["t"][k]),
             fr["imgs"][k]) for k in (i, max(i - 1, 0))]


def _spatial(params_cls):
    return params_cls.from_dict({
        **SMALL, "engine": {**SMALL["engine"], "spatial_parts": 2}})


def _jse3(q, t):
    return JSE3(np.asarray(q), np.asarray(t))


def _tse3(q, t):
    return TSE3(torch.from_numpy(q), torch.from_numpy(t))


def _jax_runner():
    mesh = jms.make_mesh(jax.devices()[:4], parts=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return jms.MultiStreamRunner(JCAM, num_streams=2,
                                     params=_spatial(JParams), mesh=mesh)


def _result(r, to_np):
    st = r.states
    return dict(maps=r.get_idepth_maps(), stats=r.flush_stats(),
                x=to_np(st.vtx_x), g=to_np(st.vtx_in_graph),
                q=to_np(st.edge_q), ev=to_np(st.edge_valid))


def _topology(st, to_np):
    return {k: to_np(getattr(st, k)) for k in
            ("edges", "edge_valid", "tris", "tri_valid", "inc_edges",
             "inc_sign", "topo_frame_id")}


@pytest.fixture(scope="module")
def jax_spatial(frames, tmp_path_factory):
    """The JAX spatial runner over N_FRAMES frames, its checkpoint after
    frame SAVE_AT, and a fresh JAX runner resumed from that file to
    N_FRAMES (its topology right after the load kept)."""
    r = _jax_runner()
    ckpt = str(tmp_path_factory.mktemp("spatial_ckpt") / "jax_spatial")
    for i in range(N_FRAMES):
        if i == SAVE_AT:
            ckpt = r.save_checkpoint(ckpt)
        r.update(_frames(frames, i, _jse3))
    assert r.parts is not None
    out = _result(r, np.asarray)
    resumed = _jax_runner()
    resumed.load_checkpoint(ckpt)
    loaded = _topology(resumed.states, np.asarray)
    for i in range(SAVE_AT, N_FRAMES):
        resumed.update(_frames(frames, i, _jse3))
    return dict(out, ckpt=ckpt, loaded=loaded,
                resumed=_result(resumed, np.asarray))


def _assert_close(got, ref):
    """The runner bounds of tests/test_multi_stream.py:196-243."""
    ma, mb = got["maps"], ref["maps"]
    both = np.isfinite(ma) & np.isfinite(mb)
    assert (np.isfinite(ma) == np.isfinite(mb)).mean() > 0.999
    assert np.abs(ma - mb)[both].max() < 1e-4
    g = got["g"]
    np.testing.assert_array_equal(g, ref["g"])
    np.testing.assert_allclose(got["x"][g], ref["x"][g], rtol=0, atol=1e-5)
    ev = got["ev"]
    np.testing.assert_allclose(got["q"][ev], ref["q"][ev], rtol=0,
                               atol=1e-5)
    for s, (a, b) in enumerate(zip(got["stats"], ref["stats"])):
        for k in ("coverage", "num_tris", "nltgv2_total_data_cost"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-3,
                                       err_msg=f"stream {s}: {k}")


def _gaps(a, b):
    """The largest differences of two results, in the bounds' terms."""
    g, ev = b["g"], b["ev"]
    both = np.isfinite(a["maps"]) & np.isfinite(b["maps"])
    return {"maps": float(np.abs(a["maps"] - b["maps"])[both].max()),
            "x": float(np.abs(a["x"] - b["x"])[g].max()),
            "q": float(np.abs(a["q"] - b["q"])[ev].max())}


def test_spatial_runner_matches_plain_and_jax(frames, jax_spatial):
    with pytest.warns(RuntimeWarning, match="not been shown to pay"):
        sp = tms.MultiStreamRunner(TCAM, 2, params=_spatial(TParams),
                                   mesh=[["cpu", "cpu"]])
    plain = tms.MultiStreamRunner(TCAM, 2, params=TParams.from_dict(SMALL),
                                  device="cpu")
    installs = 0
    for i in range(N_FRAMES):
        f = _frames(frames, i, _tse3)
        assert sp.update(f) and plain.update(f)
        installs += i % 6 == 0
    assert installs == 3 and sp.parts[0] is not None
    assert sp.parts[0].part.dp is None          # rebuilt every frame
    for a, b in zip(state_leaves(sp.states), state_leaves(plain.states)):
        assert torch.equal(a, b)
    assert sp.flush_stats() == plain.flush_stats()

    _assert_close(_result(sp, torch.Tensor.numpy), jax_spatial)
    with pytest.raises(ValueError, match="width"):
        tms.MultiStreamRunner(TCAM, 2, params=_spatial(TParams),
                              mesh=[["cpu"] * 4])
    four = dataclasses.replace(_spatial(TParams), engine=dataclasses.replace(
        _spatial(TParams).engine, spatial_parts=4))
    with pytest.warns(RuntimeWarning):
        assert tms.MultiStreamRunner(TCAM, 2, params=four,
                                     mesh=[["cpu"] * 4]).spatial


def test_spatial_resume_matches_jax(frames, jax_spatial):
    with pytest.warns(RuntimeWarning, match="not been shown to pay"):
        sp = tms.MultiStreamRunner(TCAM, 2, params=_spatial(TParams),
                                   mesh=[["cpu", "cpu"]])
    sp.load_checkpoint(jax_spatial["ckpt"])
    assert sp._max_frame_id == SAVE_AT - 1 and sp.parts[0] is not None
    loaded = _topology(sp.states, torch.Tensor.numpy)
    for k, ref in jax_spatial["loaded"].items():
        np.testing.assert_array_equal(loaded[k], ref, err_msg=k)
    assert (loaded["topo_frame_id"] == SAVE_AT - 1).all()
    for i in range(SAVE_AT, N_FRAMES):
        assert sp.update(_frames(frames, i, _tse3))
    got, ref = _result(sp, torch.Tensor.numpy), jax_spatial["resumed"]
    _assert_close(got, ref)
    # The reinstall is what makes the resumed run differ from the
    # uninterrupted one: wherever JAX's does beyond a bound, the port's
    # does too.
    bound = {"maps": 1e-4, "x": 1e-5, "q": 1e-5}
    jax_gap, port_gap = _gaps(ref, jax_spatial), _gaps(got, jax_spatial)
    moved = [k for k in bound if jax_gap[k] > bound[k]]
    assert moved, jax_gap
    for k in moved:
        assert port_gap[k] > bound[k], (k, port_gap, jax_gap)
