"""Parity of the port's raster (flame_ros_torch/ops/raster*.py) with the
JAX package's.

The id buffers must agree bit for bit: the plain PyTorch v4 and v2
versions against the Pallas kernels run in interpret mode and against
the XLA formulation, on the cases of tests/test_raster_pallas.py plus a
mesh of slivers and sub-pixel triangles and one whose tile ranges span
several staging chunks of the kernels. The port's v4 has no candidate
budget: where the Pallas v4's budgets overflow and it falls back to v2,
the port's v4 walks the whole range and gives the same ids. Planes and
dense idepth agree to 1e-5 (f32 operation-order noise). The CUDA kernels
themselves are compared with their plain versions on the card (marked
`cuda`; skipped without one).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.ops import raster as jraster
from flame_ros_tpu.ops.raster_pallas import (rasterize_tri_ids_pallas,
                                             rasterize_tri_ids_pallas_v4)
from flame_ros_torch.graph.delaunay import triangulate
from flame_ros_torch.ops import raster as traster
from flame_ros_torch.ops import raster_cuda

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W, T = 96, 128, 256


def _pad(pts, tris, T=T):
    tris_pad = np.zeros((T, 3), np.int32)
    tris_pad[:len(tris)] = tris
    tv = np.zeros(T, bool)
    tv[:len(tris)] = True
    pos = np.zeros((max(256, len(pts)), 2), np.float32)
    pos[:len(pts)] = pts
    return pos, tris_pad, tv


def _ccw(pts, tri):
    """tri ordered so that its edge functions are positive inside."""
    a, b, c = (pts[i].astype(np.float64) for i in tri)
    cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
    return tri if cross > 0 else [tri[0], tri[2], tri[1]]


def _sliver_mesh(rng):
    """A Delaunay mesh with near-collinear and sub-pixel triangles, all
    valid under triangle_planes (|2 x area| > 1e-6). Sub-pixel triangles
    around pixel centres come first, so their low ids win inside the
    mesh; two flat slivers on rows 1 and 2, above the mesh, come last.
    The -1e-3 band of a flat sliver reaches beyond its bounding box along
    its row: 1e-3 / 1.3e-4 ~ 7.7 px for the one on row 1, the whole row
    for the one on row 2 (apex 1 f32 ulp above the row)."""
    pts = rng.uniform(4, [W - 4, H - 4], (120, 2)).astype(np.float32)
    extra, front, back = [], [], []

    def tri(*vs, into):
        i = len(pts) + len(extra)
        extra.extend(vs)
        into.append([i, i + 1, i + 2])

    for cx, cy in ((40, 40), (41, 40), (70, 20), (10, 2), (90.5, 60.5)):
        tri((cx - 0.02, cy - 0.02), (cx + 0.03, cy - 0.01),
            (cx, cy + 0.03), into=front)
    tri((30, 1), (50, 1), (40, np.float32(1) + np.float32(1.3e-4)),
        into=back)
    tri((60, 2), (80, 2), (70, np.nextafter(np.float32(2), np.float32(3))),
        into=back)
    allp = np.concatenate([pts, np.asarray(extra, np.float32)])
    tris = [_ccw(allp, t) for t in front] + triangulate(pts).tolist() \
        + [_ccw(allp, t) for t in back]
    return _pad(allp, np.asarray(tris, np.int32))


def _mesh(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sliver":
        return _sliver_mesh(rng)
    if kind == "multi_chunk":
        # ~500 triangles in rows 4-70: a tile's v4 range and v2's whole
        # range both exceed a staging chunk (STAGE_CHUNK candidates).
        pts = rng.uniform(4, [W - 4, 70], (260, 2)).astype(np.float32)
        return _pad(pts, triangulate(pts), T=512)
    if kind == "empty":
        return (np.zeros((16, 2), np.float32), np.zeros((32, 3), np.int32),
                np.zeros(32, bool))
    if kind == "long":
        pts = rng.uniform(4, [W - 4, H - 4], (40, 2)).astype(np.float32)
        pts[:6, 1] = 2.0
        pts[6:12, 1] = H - 3.0
        return _pad(pts, triangulate(pts))
    pts = rng.uniform(4, [W - 4, H - 4], (120, 2)).astype(np.float32)
    pos, tp, tv = _pad(pts, triangulate(pts))
    if kind == "ysorted":
        ymin = pos[tp, 1].min(axis=1)
        ymin[~tv] = 1e9
        order = np.argsort(ymin, kind="stable")
        tp, tv = tp[order], tv[order]
    return pos, tp, tv


# (mesh kind, Pallas v4 keyword arguments, image height). The port's v4
# takes long_thresh only: it has no candidate budgets.
CASES = {
    "unsorted": ("unsorted", {}, H),
    "ysorted": ("ysorted", {}, H),
    "long_triangles": ("long", {"long_thresh": 24.0}, H),
    "budget_fallback": ("unsorted", {"cand_s": 128, "cand_l": 128,
                                     "long_thresh": 1000.0}, H),
    "empty": ("empty", {}, 32),
    "sliver": ("sliver", {}, H),
    "multi_chunk": ("multi_chunk", {}, H),
}


def _port_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("cand_s", "cand_l")}


def _torch(pos, tp, tv):
    return torch.from_numpy(pos), torch.from_numpy(tp), torch.from_numpy(tv)


def _jax(pos, tp, tv):
    return jnp.asarray(pos), jnp.asarray(tp), jnp.asarray(tv)


# Each test below runs every case of CASES (one test item per function
# keeps the file's item count low, so the parallel test scheduler, which
# orders files by item count, still starts the long acceptance files
# first).

def test_plain_v4_matches_pallas_v4():
    for case, (kind, kw, h) in sorted(CASES.items()):
        mesh = _mesh(kind)
        ref = np.asarray(rasterize_tri_ids_pallas_v4(
            *_jax(*mesh), height=h, width=W, interpret=True, **kw))
        out = raster_cuda.rasterize_tri_ids_v4_ref(
            *_torch(*mesh), height=h, width=W, **_port_kw(kw)).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=case)
        # The wrapper on CPU tensors runs the same plain version.
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v4(
            *_torch(*mesh), height=h, width=W, **_port_kw(kw)).numpy(), ref,
            err_msg=case)
        if kind == "empty":
            assert (out == -1).all()
        else:
            assert (out >= 0).mean() > 0.5, case


def test_plain_v2_matches_pallas_v2():
    for case, (kind, _, h) in sorted(CASES.items()):
        mesh = _mesh(kind)
        ref = np.asarray(rasterize_tri_ids_pallas(
            *_jax(*mesh), height=h, width=W, interpret=True))
        out = raster_cuda.rasterize_tri_ids_v2_ref(
            *_torch(*mesh), height=h, width=W).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v2(
            *_torch(*mesh), height=h, width=W).numpy(), ref, err_msg=case)


def test_plain_raster_matches_xla():
    """The plain formulation (the CPU path) and both plain kernel
    versions against the JAX package's XLA raster."""
    for case, (kind, kw, h) in sorted(CASES.items()):
        mesh = _mesh(kind)
        ref = np.asarray(jraster.rasterize_tri_ids(*_jax(*mesh), height=h,
                                                   width=W))
        tm = _torch(*mesh)
        np.testing.assert_array_equal(
            traster.rasterize_tri_ids(*tm, height=h, width=W).numpy(), ref,
            err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v4_ref(
            *tm, height=h, width=W, **_port_kw(kw)).numpy(), ref,
            err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v2_ref(
            *tm, height=h, width=W).numpy(), ref, err_msg=case)


def test_v4_budget_free():
    """On the budget-fallback mesh the Pallas v4's budgets overflow (a
    tile needs more short candidates than cand_s, or the long ones more
    than cand_l), so it falls back to v2; the port's budget-free plain v4
    equals it and the XLA raster there. The multi-chunk mesh's ranges
    exceed a staging chunk for v4 (a tile's short + long range) and v2 (a
    tile's block range)."""
    kind, kw, h = CASES["budget_fallback"]
    mesh = _mesh(kind)
    tm = _torch(*mesh)
    _, lo, hi, counts = raster_cuda.v4_setup(
        *tm, height=h, row_tile=2, long_thresh=kw["long_thresh"])
    n_short, n_live = counts.tolist()
    assert int((hi - lo).max()) > kw["cand_s"] \
        or n_live - n_short > kw["cand_l"]
    ref = np.asarray(rasterize_tri_ids_pallas_v4(
        *_jax(*mesh), height=h, width=W, interpret=True, **kw))
    out = raster_cuda.rasterize_tri_ids_v4_ref(
        *tm, height=h, width=W, **_port_kw(kw)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.asarray(jraster.rasterize_tri_ids(
        *_jax(*mesh), height=h, width=W)))

    tm = _torch(*_mesh("multi_chunk"))
    _, lo, hi, counts = raster_cuda.v4_setup(*tm, height=H, row_tile=2,
                                             long_thresh=48.0)
    n_short, n_live = counts.tolist()
    assert int((hi - lo).max()) + n_live - n_short \
        > raster_cuda.STAGE_CHUNK
    _, bounds, B = raster_cuda.v2_setup(*tm, height=H, width=W, row_tile=2,
                                        tri_block=512)
    assert int((bounds[:, 1] - bounds[:, 0]).max()) * B \
        > raster_cuda.STAGE_CHUNK


def _planes_inputs(seed=1):
    pos, tp, tv = _mesh("unsorted", seed)
    x = np.random.default_rng(seed).uniform(0.2, 1.5, 256).astype(np.float32)
    return pos, x, tp, tv


def test_planes_and_idepth_match():
    pos, x, tp, tv = _planes_inputs()
    jp, jv = jraster.triangle_planes(jnp.asarray(pos), jnp.asarray(x),
                                     jnp.asarray(tp), jnp.asarray(tv))
    tp_, tv_ = traster.triangle_planes(torch.from_numpy(pos),
                                       torch.from_numpy(x),
                                       torch.from_numpy(tp),
                                       torch.from_numpy(tv))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), atol=1e-5)

    jm, jid = jraster.rasterize_idepth(
        jnp.asarray(pos), jnp.asarray(x), jnp.asarray(tp), jnp.asarray(tv),
        height=H, width=W)
    tm, tid = traster.rasterize_idepth(
        torch.from_numpy(pos), torch.from_numpy(x), torch.from_numpy(tp),
        torch.from_numpy(tv), height=H, width=W)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    # The same products through the kernel dispatch (plain v4 on CPU).
    km, kid = traster.rasterize_idepth(
        torch.from_numpy(pos), torch.from_numpy(x), torch.from_numpy(tp),
        torch.from_numpy(tv), height=H, width=W, use_kernel=True,
        kernel="v4")
    np.testing.assert_array_equal(kid.numpy(), np.asarray(jid))
    assert float(traster.coverage(tm)) == pytest.approx(
        float(jraster.coverage(jm)), abs=1e-7)


def test_sample_idepth_at_matches():
    pos, x, tp, tv = _planes_inputs(2)
    jid, jpl = jraster.rasterize_ids(jnp.asarray(pos), jnp.asarray(x),
                                     jnp.asarray(tp), jnp.asarray(tv),
                                     height=H, width=W)
    uv = np.random.default_rng(3).uniform(-2, [W + 1, H + 1],
                                          (300, 2)).astype(np.float32)
    uv[:20] = np.round(uv[:20]) + 0.5     # exact half-pixel ties
    jx, jok = jraster.sample_idepth_at(jid, jpl, jnp.asarray(uv))
    tx, tok = traster.sample_idepth_at(torch.from_numpy(np.array(jid)),
                                       torch.from_numpy(np.array(jpl)),
                                       torch.from_numpy(uv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: both kernels equal their plain versions bit for bit
    (the chip smoke script repeats this at VGA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (kind, kw, h) in sorted(CASES.items()):
        mesh = [t.cuda() for t in _torch(*_mesh(kind))]
        for kernel, ref, kwk in (
                (raster_cuda.rasterize_tri_ids_v4,
                 raster_cuda.rasterize_tri_ids_v4_ref, _port_kw(kw)),
                (raster_cuda.rasterize_tri_ids_v2,
                 raster_cuda.rasterize_tri_ids_v2_ref, {})):
            out = kernel(*mesh, height=h, width=W, **kwk)
            torch.cuda.synchronize()
            assert torch.equal(out, ref(*mesh, height=h, width=W, **kwk)), \
                case
