"""The port's v3 raster (flame_ros_torch/ops/raster_cuda.py,
`raster_v3_kernel` in csrc/raster.cu) held against the JAX package's
Pallas v3 kernel.

On the CPU the plain version must equal `rasterize_tri_ids_pallas_v3` run
in interpret mode bit for bit, with the same budget decision (`fits`),
on the cases of tests/test_raster_pallas.py:60-107: an unsorted mesh, a
mesh of tall triangles with long_thresh 24, and budgets so small that v3
falls back to v2. The CUDA kernel is compared with the plain version on
the card (marked `cuda`; skipped without one).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flame_ros_tpu.ops import raster as jraster
from flame_ros_tpu.ops.raster_pallas import rasterize_tri_ids_pallas_v3
from flame_ros_torch.config import FlameParams
from flame_ros_torch.graph.delaunay import triangulate
from flame_ros_torch.ops import raster as traster
from flame_ros_torch.ops import raster_cuda

# Small shapes: one intra-op thread keeps these tests from
# oversubscribing the CPU when the suite runs in parallel workers.
torch.set_num_threads(1)

H, W, T = 96, 128, 256


def _mesh(kind, seed=0):
    rng = np.random.default_rng(seed)
    n = 40 if kind == "long" else 120
    pts = rng.uniform(4, [W - 4, H - 4], (n, 2)).astype(np.float32)
    if kind == "long":
        # Points on the top and bottom rows: very tall triangles.
        pts[:6, 1] = 2.0
        pts[6:12, 1] = H - 3.0
    tris = triangulate(pts)
    tp = np.zeros((T, 3), np.int32)
    tp[:len(tris)] = tris
    tv = np.zeros(T, bool)
    tv[:len(tris)] = True
    pos = np.zeros((256, 2), np.float32)
    pos[:n] = pts
    return pos, tp, tv


# case: (mesh kind, v3 keyword arguments, whether the budgets hold)
CASES = {
    "unsorted": ("unsorted", {}, True),
    "long_triangles": ("long", {"long_thresh": 24.0}, True),
    "budget_fallback": ("unsorted", {"s_blocks": 1, "l_blocks": 1,
                                     "tri_block": 32}, False),
}


def test_plain_v3_matches_pallas_v3():
    """Plain v3 == Pallas v3 (interpret mode) == the XLA raster, bit for
    bit; the wrapper on CPU tensors runs the plain version."""
    for case, (kind, kw, fits) in sorted(CASES.items()):
        pos, tp, tv = _mesh(kind)
        jm = (jnp.asarray(pos), jnp.asarray(tp), jnp.asarray(tv))
        tm = (torch.from_numpy(pos), torch.from_numpy(tp),
              torch.from_numpy(tv))
        ref = np.asarray(rasterize_tri_ids_pallas_v3(
            *jm, height=H, width=W, interpret=True, **kw))
        out = raster_cuda.rasterize_tri_ids_v3_ref(*tm, height=H, width=W,
                                                   **kw).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=case)
        np.testing.assert_array_equal(
            out, np.asarray(jraster.rasterize_tri_ids(*jm, height=H,
                                                      width=W)),
            err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v3(
            *tm, height=H, width=W, **kw).numpy(), ref, err_msg=case)
        assert (out >= 0).mean() > 0.5, case
        setup_kw = dict(tri_block=128, s_blocks=5, l_blocks=4,
                        long_thresh=64.0)
        setup_kw.update(kw)
        *_, got_fits, _ = raster_cuda.v3_setup(*tm, height=H, row_tile=2,
                                               **setup_kw)
        assert bool(got_fits) is fits, case


def test_v3_setup_and_routing():
    """The setup's block ranges cover every short triangle that overlaps
    a tile; an empty mesh rasterizes to -1; the engine's kernel name "v3"
    runs v2, as the JAX package's dispatch does."""
    pos, tp, tv = (torch.from_numpy(a) for a in _mesh("unsorted"))
    C, lo_blk, nblk_s, long2, fits, (B, n_blocks, sb, lb) = \
        raster_cuda.v3_setup(pos, tp, tv, height=H, row_tile=2,
                             tri_block=32, s_blocks=8, l_blocks=8,
                             long_thresh=64.0)
    assert (B, n_blocks, sb, lb) == (32, 8, 8, 8) and bool(fits)
    ids = C[10].to(torch.int64)
    assert sorted(ids.tolist()) == list(range(T))      # a permutation
    ys = pos[tp[ids].long(), 1]
    ymin, ymax = ys.min(-1).values, ys.max(-1).values
    short = C[9] > 0
    short &= (ymax - ymin) <= 64.0
    for i in range(H // 2):
        need = torch.nonzero(short & (ymax >= 2 * i) & (ymin < 2 * i + 2))
        lo, n = int(lo_blk[i]), int(nblk_s[i])
        assert all(lo * B <= int(p) < (lo + n) * B for p in need), i
    empty = (torch.zeros((16, 2)), torch.zeros((64, 3), dtype=torch.int32),
             torch.zeros(64, dtype=torch.bool))
    assert (raster_cuda.rasterize_tri_ids_v3(*empty, height=32,
                                             width=W) == -1).all()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.2, 1.5, 256).astype(np.float32))
    v3, _ = traster.rasterize_ids(pos, x, tp, tv, height=H, width=W,
                                  use_kernel=True, kernel="v3")
    v2, _ = traster.rasterize_ids(pos, x, tp, tv, height=H, width=W,
                                  use_kernel=True, kernel="v2")
    assert torch.equal(v3, v2)
    p = FlameParams.from_dict({"engine": {"pallas_raster_kernel": "v3"}})
    assert p.resolved("cpu").engine.pallas_raster_kernel == "v3"


@pytest.mark.cuda
def test_cuda_v3_matches_plain():
    """On the card: the v3 kernel equals its plain version bit for bit,
    and its work counter shows which kernel did the work (chip_smoke.py
    repeats this at VGA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (kind, kw, fits) in sorted(CASES.items()):
        mesh = [torch.from_numpy(a).cuda() for a in _mesh(kind)]
        raster_cuda.reset_counters()
        out = raster_cuda.rasterize_tri_ids_v3(*mesh, height=H, width=W,
                                               **kw)
        torch.cuda.synchronize()
        work = raster_cuda.work_counters(out.device).tolist()
        assert work == ([0, 0, 1] if fits else [0, 1, 0]), case
        assert torch.equal(out, raster_cuda.rasterize_tri_ids_v3_ref(
            *mesh, height=H, width=W, **kw)), case
