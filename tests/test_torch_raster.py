"""Parity of the port's raster (flame_ros_torch/ops/raster*.py) with the
JAX package's.

The id buffers must agree bit for bit: the plain PyTorch v4 and v2
versions against the Pallas kernels run in interpret mode and against
the XLA formulation, on the cases of tests/test_raster_pallas.py. Planes
and dense idepth agree to 1e-5 (f32 operation-order noise). The CUDA
kernels themselves are compared with their plain versions on the card
(marked `cuda`; skipped without one).
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
    pos = np.zeros((256, 2), np.float32)
    pos[:len(pts)] = pts
    return pos, tris_pad, tv


def _mesh(kind, seed=0):
    rng = np.random.default_rng(seed)
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


# (mesh kind, v4 keyword arguments, image height)
CASES = {
    "unsorted": ("unsorted", {}, H),
    "ysorted": ("ysorted", {}, H),
    "long_triangles": ("long", {"long_thresh": 24.0}, H),
    "budget_fallback": ("unsorted", {"cand_s": 128, "cand_l": 128,
                                     "long_thresh": 1000.0}, H),
    "empty": ("empty", {}, 32),
}


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
            *_torch(*mesh), height=h, width=W, **kw).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=case)
        # The wrapper on CPU tensors runs the same plain version.
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v4(
            *_torch(*mesh), height=h, width=W, **kw).numpy(), ref,
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
            *tm, height=h, width=W, **kw).numpy(), ref, err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v2_ref(
            *tm, height=h, width=W).numpy(), ref, err_msg=case)


def test_v4_fallback_flag():
    """The budget-fallback case really trips v4's `fits` flag (so v2 does
    the work) and the default budgets do not."""
    mesh = _torch(*_mesh("unsorted"))
    kw = dict(height=H, row_tile=2, cand_s=128, cand_l=128)
    *_, fits = raster_cuda.v4_setup(*mesh, long_thresh=1000.0, **kw)
    assert not bool(fits)
    *_, fits = raster_cuda.v4_setup(*mesh, long_thresh=48.0,
                                    **{**kw, "cand_s": 384})
    assert bool(fits)


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
                 raster_cuda.rasterize_tri_ids_v4_ref, kw),
                (raster_cuda.rasterize_tri_ids_v2,
                 raster_cuda.rasterize_tri_ids_v2_ref, {})):
            out = kernel(*mesh, height=h, width=W, **kwk)
            torch.cuda.synchronize()
            assert torch.equal(out, ref(*mesh, height=h, width=W, **kwk)), \
                case
