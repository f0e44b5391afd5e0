"""The port's v3 raster (flame_ros_torch/ops/raster_cuda.py,
`raster_v3_kernel` in csrc/raster.cu) held against the JAX package's
Pallas v3 kernel.

The port's v3 has no block budget: each tile walks every block it needs.
On the CPU its plain version must equal `rasterize_tri_ids_pallas_v3` run
in interpret mode, and the XLA raster, bit for bit on the cases of
tests/test_raster_pallas.py:60-107 (an unsorted mesh, a mesh of tall
triangles with long_thresh 24, and budgets so small that the Pallas v3
falls back to v2, where the port's whole block walk must give v2's
answer), plus a mesh whose tiles need more than a staging chunk
(`STAGE_CHUNK` candidates) of blocks. The CUDA kernel is compared with
the plain version on the card (marked `cuda`; skipped without one).
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
    n = {"long": 40, "multi_chunk": 114}.get(kind, 120)
    ymax = 60 if kind == "multi_chunk" else H - 4
    pts = rng.uniform(4, [W - 4, ymax], (n, 2)).astype(np.float32)
    if kind == "long":
        # Points on the top and bottom rows: very tall triangles.
        pts[:6, 1] = 2.0
        pts[6:12, 1] = H - 3.0
    if kind == "multi_chunk":
        # A band of short triangles in rows 4-60 (more than one block of
        # 128) and four points on the bottom row.
        pts[110:, 1] = H - 3.0
    tris = triangulate(pts)
    tp = np.zeros((T, 3), np.int32)
    tp[:len(tris)] = tris
    tv = np.zeros(T, bool)
    tv[:len(tris)] = True
    pos = np.zeros((256, 2), np.float32)
    pos[:n] = pts
    return pos, tp, tv


# case: (mesh kind, Pallas v3 keyword arguments, whether its budgets
# hold). The port's v3 takes tri_block and long_thresh only. On the
# multi-chunk mesh (215 triangles) a tile walks 2 short blocks of 128 and
# the long block, which is the second short block again: 384 candidates,
# more than a staging chunk. Its shapes are the unsorted case's, so the
# JAX compiles are shared.
CASES = {
    "unsorted": ("unsorted", {}, True),
    "long_triangles": ("long", {"long_thresh": 24.0}, True),
    "budget_fallback": ("unsorted", {"s_blocks": 1, "l_blocks": 1,
                                     "tri_block": 32}, False),
    "multi_chunk": ("multi_chunk", {}, True),
}
V3_DEFAULTS = {"tri_block": 128, "s_blocks": 5, "l_blocks": 4,
               "long_thresh": 64.0}


def _port_kw(kw):
    return {k: v for k, v in kw.items() if k not in ("s_blocks", "l_blocks")}


def _budgets(tm, kw):
    """From the port's setup: whether the Pallas v3's block budgets hold
    on this mesh (raster_pallas.py:230-231, :275), and the most
    candidates a tile walks."""
    kw = {**V3_DEFAULTS, **kw}
    _, _, nblk_s, long2, B = raster_cuda.v3_setup(
        *tm, height=H, row_tile=2, tri_block=kw["tri_block"],
        long_thresh=kw["long_thresh"])
    n_blocks = tm[1].shape[0] // B
    n_lblk = int(long2[1])
    fits = (int(nblk_s.max()) <= min(kw["s_blocks"], n_blocks)
            and n_lblk <= min(kw["l_blocks"], n_blocks))
    return fits, (int(nblk_s.max()) + n_lblk) * B


def test_plain_v3_matches_pallas_v3():
    """Plain v3 (no budget) == Pallas v3 (interpret mode, its v2 branch
    where its budgets overflow) == the XLA raster, bit for bit; the
    wrapper on CPU tensors runs the plain version."""
    for case, (kind, kw, fits) in sorted(CASES.items()):
        pos, tp, tv = _mesh(kind)
        jm = (jnp.asarray(pos), jnp.asarray(tp), jnp.asarray(tv))
        tm = (torch.from_numpy(pos), torch.from_numpy(tp),
              torch.from_numpy(tv))
        got_fits, n_cand = _budgets(tm, kw)
        assert got_fits is fits, case
        if case == "multi_chunk":
            assert n_cand > raster_cuda.STAGE_CHUNK, n_cand
        ref = np.asarray(rasterize_tri_ids_pallas_v3(
            *jm, height=H, width=W, interpret=True, **kw))
        out = raster_cuda.rasterize_tri_ids_v3_ref(
            *tm, height=H, width=W, **_port_kw(kw)).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=case)
        np.testing.assert_array_equal(
            out, np.asarray(jraster.rasterize_tri_ids(*jm, height=H,
                                                      width=W)),
            err_msg=case)
        np.testing.assert_array_equal(raster_cuda.rasterize_tri_ids_v3(
            *tm, height=H, width=W, **_port_kw(kw)).numpy(), ref,
            err_msg=case)
        assert (out >= 0).mean() > 0.5, case


def test_v3_setup_and_routing():
    """The setup's block ranges cover every short triangle that overlaps
    a tile; an empty mesh rasterizes to -1; the engine's kernel name "v3"
    runs v2, as the JAX package's dispatch does."""
    pos, tp, tv = (torch.from_numpy(a) for a in _mesh("unsorted"))
    C, lo_blk, nblk_s, long2, B = raster_cuda.v3_setup(
        pos, tp, tv, height=H, row_tile=2, tri_block=32, long_thresh=64.0)
    assert B == 32
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
    """On the card: the v3 kernel equals its plain version bit for bit
    on every case, the Pallas budget-overflow one included, in one launch
    of v3 and none of v2 (chip_smoke.py repeats this at VGA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (kind, kw, _) in sorted(CASES.items()):
        mesh = [torch.from_numpy(a).cuda() for a in _mesh(kind)]
        raster_cuda.reset_counters()
        out = raster_cuda.rasterize_tri_ids_v3(*mesh, height=H, width=W,
                                               **_port_kw(kw))
        torch.cuda.synchronize()
        work = raster_cuda.work_counters(out.device).tolist()
        assert work == [0, 0, 1], case
        assert raster_cuda.rasterize_tri_ids_v3.launches == 1, case
        assert raster_cuda.rasterize_tri_ids_v2.launches == 0, case
        assert torch.equal(out, raster_cuda.rasterize_tri_ids_v3_ref(
            *mesh, height=H, width=W, **_port_kw(kw))), case
