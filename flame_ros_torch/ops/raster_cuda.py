"""Hand-written CUDA triangle-id rasterizers (v4, v3 and v2) and their
plain PyTorch versions.

Counterpart of `flame_ros_tpu/ops/raster_pallas.py`:

- `rasterize_tri_ids_v4` replaces `rasterize_tri_ids_pallas_v4`
  (raster_pallas.py:350-482): device sort by (class, ymin), then per
  tile the exact short-triangle range and the shared long range, walked
  whatever their length. The TPU kernel's candidate budgets (a static
  VMEM slab) and its fallback to v2 have no counterpart: both branches
  of its `lax.cond` compute the same id buffer;
- `rasterize_tri_ids_v3` replaces `rasterize_tri_ids_pallas_v3`
  (raster_pallas.py:180-315): the same device sort in blocks of
  `tri_block`, then per tile all of its short blocks and all the shared
  long blocks. The TPU kernel's block budgets (`s_blocks`, `l_blocks`,
  the static length of a grid axis) and its fallback to v2 have no
  counterpart: where the budgets hold the candidate set is the same, and
  where they overflow the whole block walk gives the id buffer that the
  fallback gives. No engine path reaches it, as in the JAX package
  (`pallas_raster_kernel="v3"` runs v2);
- `rasterize_tri_ids_v2` replaces `rasterize_tri_ids_pallas`
  (raster_pallas.py:27-147): per-tile contiguous triangle-block ranges;
- `rasterize_tri_ids_v4_batched` replaces `rasterize_tri_ids_pallas_v4`
  under `jax.vmap` (the multi-stream engine step vmaps it over a stream
  axis, `flame_ros_tpu/parallel/multi_stream.py:193-210`): v4 for S
  images, its setup batched on the card and one launch of a
  (n_tiles, S) grid.

The kernels are in `csrc/raster.cu` (its header note says what bounds
them on the card and how the design answers it: all three stage their
candidates in chunks of `STAGE_CHUNK` and cull them against the block's
and each warp's pixels before testing). They are compiled with nvcc at
first use into `csrc/build/` and loaded with ctypes; the build is redone
when the source's content hash changes.

Each wrapper runs its plain version (`*_ref`) when given CPU tensors and
launches its kernel when given CUDA tensors; a CUDA tensor never falls
back to the plain version. The plain versions keep the kernels' sort,
range logic and edge-function evaluation order, so the id buffers agree
bit for bit.

Launch counts: each wrapper has a `launches` integer that counts its
kernel launches, one per call (the batched wrapper also counts the images
its launches covered, `images`). The kernels also count their launches on
the device (`work_counters`, one counter per card), so a run shows which
kernel did the raster work without reading the wrappers.

A ctypes launch runs on the calling thread's current CUDA device, so
each wrapper makes the output's card current around its launch
(`torch.cuda.device(out.device)`): a tensor on `cuda:1` while `cuda:0`
is current launches on `cuda:1`, on that card's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "raster.cu")
_BUILD = os.path.join(_CSRC, "build")
_SO = os.path.join(_BUILD, "libflame_raster.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

OFF = 1e7          # class offset of the v4 sort key
EPS = -1e-3        # inside-test tolerance of the edge functions
STAGE_CHUNK = 256  # candidates a kernel stages per pass (CH in raster.cu)

_lock = threading.Lock()
_lib = None
_work = {}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.blake2b(f.read(), digest_size=16).hexdigest()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def build(force: bool = False) -> str:
    """Compile csrc/raster.cu into csrc/build/ unless a library built from
    the current source is already there. Returns the library path."""
    h = _src_hash()
    stamp = _SO + ".srchash"
    if not force and os.path.exists(_SO) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == h:
                return _SO
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, _SO)
    with open(stamp, "w") as f:
        f.write(h)
    return _SO


def load(path: str):
    """The kernel library at `path` with its launch functions typed."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.raster_v4_launch.restype = ci
    lib.raster_v4_launch.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp,
                                     vp]
    lib.raster_v2_launch.restype = ci
    lib.raster_v2_launch.argtypes = [vp, ci, vp, ci, vp, ci, ci, ci, vp, vp]
    lib.raster_v3_launch.restype = ci
    lib.raster_v3_launch.argtypes = [vp, ci, vp, vp, vp, ci, vp, ci, ci, ci,
                                     vp, vp]
    lib.raster_v4_batched_launch.restype = ci
    lib.raster_v4_batched_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci,
                                             ci, ci, vp, vp]
    return lib


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


WORK_SLOTS = ("v4", "v2", "v3", "v4_batched", "v4_batched_images")


def work_counters(device) -> torch.Tensor:
    """Device int32 [5]: launches of (v4, v2, v3, batched v4) and the
    images the batched v4 launches covered, counted by the kernels."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _work:
        _work[dev] = torch.zeros(len(WORK_SLOTS), dtype=torch.int32,
                                 device=dev)
    return _work[dev]


def reset_counters() -> None:
    rasterize_tri_ids_v4.launches = 0
    rasterize_tri_ids_v3.launches = 0
    rasterize_tri_ids_v2.launches = 0
    rasterize_tri_ids_v4_batched.launches = 0
    rasterize_tri_ids_v4_batched.images = 0
    for w in _work.values():
        w.zero_()


# ---------------------------------------------------------------------------
# Shared setup (torch ops; no host sync)
# ---------------------------------------------------------------------------

def edge_coeffs(p0, p1):
    """[..., 3, T] (a, b, c) of E(x, y) = a x + b y + c for the edges
    p0 -> p1 [..., T, 2]."""
    dy = p1[..., 1] - p0[..., 1]
    dx = p1[..., 0] - p0[..., 0]
    return torch.stack([-dy, dx, dy * p0[..., 0] - dx * p0[..., 1]], -2)


def _corners(vtx_pos, tris):
    t = tris.long()
    return vtx_pos[t[:, 0]], vtx_pos[t[:, 1]], vtx_pos[t[:, 2]]


def _check(vtx_pos, tris, tri_valid, height, width, row_tile):
    if vtx_pos.dtype != torch.float32 or vtx_pos.dim() != 2 \
            or vtx_pos.shape[1] != 2:
        raise ValueError(f"vtx_pos must be float32 [N, 2], got "
                         f"{vtx_pos.dtype} {tuple(vtx_pos.shape)}")
    if tris.dtype not in (torch.int32, torch.int64) or tris.dim() != 2 \
            or tris.shape[1] != 3:
        raise ValueError(f"tris must be int [T, 3], got {tris.dtype} "
                         f"{tuple(tris.shape)}")
    if tri_valid.dtype != torch.bool \
            or tuple(tri_valid.shape) != (tris.shape[0],):
        raise ValueError(f"tri_valid must be bool [T], got "
                         f"{tri_valid.dtype} {tuple(tri_valid.shape)}")
    if not (vtx_pos.device == tris.device == tri_valid.device):
        raise ValueError("vtx_pos, tris and tri_valid must share a device")
    if height < row_tile or height % row_tile:
        raise ValueError(f"height {height} must be a positive multiple of "
                         f"row_tile {row_tile}")
    if width <= 1:
        raise ValueError(f"width {width} too small")


def v4_setup_batched(vtx_pos, tris, tri_valid, *, height: int,
                     row_tile: int, long_thresh: float):
    """The v4 wrapper's device-side preparation (raster_pallas.py:397-438,
    without the budgets) for S images at once, vtx_pos [S, N, 2], tris
    [S, T, 3], tri_valid [S, T], with no host sync. It is the device sort
    that v4 and v3 share (raster_pallas.py:241-249, :407-415): triangles
    ordered by key = class * 1e7 + clip(ymin), class 0 for a y-extent <=
    long_thresh, 1 for a longer one, 2 for an invalid one; f32 keys, a
    stable sort (jnp.argsort is stable), and left-side searchsorted as
    jnp.searchsorted, each along an image's own row.

    Returns (C [S, 11, T] sorted slabs = 9 edge coefficients, validity and
    original id as f32; lo_pos [S, n_tiles] int32, hi_pos [S, n_tiles]
    int32, counts [S, 2] int32 = (n_short, n_live)): the sorted positions
    of the short triangles that may overlap each tile of `row_tile` rows
    are [lo_pos, hi_pos), those of the long ones [n_short, n_live)."""
    dev = vtx_pos.device
    S, T = tris.shape[:2]
    n_tiles = height // row_tile
    t = tris.long()
    img = torch.arange(S, device=dev)[:, None]
    a, b, c = (vtx_pos[img, t[..., k]] for k in range(3))   # [S, T, 2]
    ys = torch.stack([a[..., 1], b[..., 1], c[..., 1]], -1)
    ymin = ys.min(-1).values
    ymax = ys.max(-1).values
    extent = ymax - ymin
    klass = torch.where(tri_valid,
                        torch.where(extent <= long_thresh, 0.0, 1.0), 2.0)
    key = klass * OFF + torch.clamp(ymin, 0.0, OFF - 1.0)
    perm = torch.argsort(key, dim=-1, stable=True)
    key_s = torch.gather(key, 1, perm)
    # OFF - 0.5 and 2*OFF - 0.5 in f32 (they round to 1e7 and 2e7).
    thr = torch.full((2,), OFF - 0.5, dtype=torch.float32, device=dev)
    thr[1:].fill_(2 * OFF - 0.5)    # a fill: no copy from the host
    counts = torch.searchsorted(
        key_s, thr.expand(S, 2).contiguous()).to(torch.int32)
    tile_y0 = torch.arange(n_tiles, dtype=torch.float32, device=dev) \
        * row_tile
    lo_pos = torch.searchsorted(
        key_s, torch.clamp(tile_y0 - long_thresh, min=0.0).expand(
            S, n_tiles).contiguous()).to(torch.int32)
    hi_pos = torch.minimum(
        torch.searchsorted(key_s, (tile_y0 + row_tile).expand(
            S, n_tiles).contiguous()).to(torch.int32), counts[:, :1])
    # Columns in sorted order; the last row holds each column's original
    # id (the permutation itself).
    coef = torch.cat([edge_coeffs(a, b), edge_coeffs(b, c),
                      edge_coeffs(c, a),
                      tri_valid.to(torch.float32)[:, None, :]], 1)
    C = torch.cat([torch.gather(coef, 2, perm[:, None, :].expand(S, 10, T)),
                   perm.to(torch.float32)[:, None, :]], 1).contiguous()
    return C, lo_pos, hi_pos.contiguous(), counts


def v4_setup(vtx_pos, tris, tri_valid, *, height: int, row_tile: int,
             long_thresh: float):
    """`v4_setup_batched` of one image: (C [11, T] sorted slab, lo_pos
    [n_tiles] int32, hi_pos [n_tiles] int32, counts [2] int32 =
    (n_short, n_live))."""
    return tuple(x[0] for x in v4_setup_batched(
        vtx_pos[None], tris[None], tri_valid[None], height=height,
        row_tile=row_tile, long_thresh=long_thresh))


def v3_setup(vtx_pos, tris, tri_valid, *, height: int, row_tile: int,
             tri_block: int, long_thresh: float):
    """The v3 wrapper's device-side preparation (raster_pallas.py:225-273,
    without the budgets).

    Returns (C [11, T] sorted slab = 9 edge coefficients, validity and
    original id as f32; lo_blk [n_tiles] int32, the tile's first short
    block; nblk_s [n_tiles] int32, its number of short blocks; long2 [2]
    int32 = (long_lo, n_lblk), the shared long blocks; B, the block size,
    which divides T)."""
    T = tris.shape[0]
    B = min(tri_block, T)
    if T % B:
        B = T
    C, lo_pos, hi_pos, counts = v4_setup(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        long_thresh=long_thresh)
    n_short, n_live = counts
    lo_blk = torch.div(lo_pos, B, rounding_mode="floor")
    nblk_s = torch.clamp(torch.div(hi_pos + B - 1, B, rounding_mode="floor")
                         - lo_blk, min=0).to(torch.int32)
    long_lo = torch.div(n_short, B, rounding_mode="floor")
    n_lblk = torch.clamp(torch.div(n_live + B - 1, B, rounding_mode="floor")
                         - long_lo, min=0)
    long2 = torch.stack([long_lo, n_lblk]).to(torch.int32).contiguous()
    return (C, lo_blk.to(torch.int32).contiguous(), nblk_s.contiguous(),
            long2, B)


def v2_setup(vtx_pos, tris, tri_valid, *, height: int, width: int,
             row_tile: int, tri_block: int):
    """The v2 wrapper's device-side preparation (raster_pallas.py:78-124).

    Returns (C [10, T] = 9 edge coefficients + validity in original order,
    bounds [n_tiles, 2] int32 block ranges [lo, hi), block size B)."""
    T = tris.shape[0]
    dev = vtx_pos.device
    B = min(tri_block, T)
    if T % B:
        B = T
    n_blocks = T // B
    a, b, c = _corners(vtx_pos, tris)
    C = torch.cat([edge_coeffs(a, b), edge_coeffs(b, c), edge_coeffs(c, a),
                   tri_valid.to(torch.float32)[None, :]], 0).contiguous()
    ys = torch.stack([a[:, 1], b[:, 1], c[:, 1]], -1)
    inf = float("inf")
    y_min = torch.where(tri_valid, ys.min(-1).values, inf).reshape(
        n_blocks, B)
    y_max = torch.where(tri_valid, ys.max(-1).values, -inf).reshape(
        n_blocks, B)
    blk_ymin = y_min.min(-1).values
    blk_ymax = y_max.max(-1).values
    px_tile = row_tile * width
    n_tiles = (height * width) // px_tile
    tile_y0 = torch.arange(n_tiles, dtype=torch.float32, device=dev) \
        * row_tile
    tile_y1 = tile_y0 + row_tile
    ext = blk_ymax - blk_ymin
    span = torch.max(torch.where(torch.isfinite(ext), ext,
                                 torch.zeros_like(ext)))
    mono = torch.all(blk_ymin[1:] >= blk_ymin[:-1])
    his = torch.where(mono,
                      torch.searchsorted(blk_ymin, tile_y1, right=True),
                      n_blocks)
    los = torch.where(mono, torch.searchsorted(blk_ymin, tile_y0 - span),
                      0)
    bounds = torch.stack([los, his], -1).to(torch.int32).contiguous()
    return C, bounds, B


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the oracle for the kernels)
# ---------------------------------------------------------------------------

def _v4_eval(C, lo_pos, hi_pos, counts, *, T, height, width, row_tile):
    """Plain v4 evaluation given the setup; [H, W] int32 with -1 uncovered
    (the kernel's arithmetic: x*a + (y*b + c), min over original ids).
    Each tile tests its whole short range [lo_pos, hi_pos) and the whole
    long range [n_short, n_live), padded to the longest short range with
    columns masked invalid."""
    dev = C.device
    n_tiles = height // row_tile
    n_short, n_live = counts.tolist()
    n_s = torch.clamp(hi_pos - lo_pos, min=0).long()       # [n_tiles]
    cs = int(n_s.max())
    if cs + n_live - n_short <= 0:
        return torch.full((height, width), -1, dtype=torch.int32,
                          device=dev)
    k = torch.arange(cs, device=dev)[None, :]
    idx = torch.clamp(lo_pos[:, None].long() + k, 0, T - 1)
    G = C[:, idx].permute(1, 0, 2).clone()             # [n_tiles, 11, cs]
    G[:, 9] = G[:, 9] * (k < n_s[:, None]).to(torch.float32)
    L = C[:, n_short:n_live]                           # [11, n_long]
    S = torch.cat([G, L[None].expand(n_tiles, *L.shape)], 2)  # [nt, 11, nc]
    big = float(T + 1)
    ux = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    rows = []
    for r in range(row_tile):
        uy = (torch.arange(n_tiles, device=dev) * row_tile + r).to(
            torch.float32)[:, None, None]              # [nt, 1, 1]
        inside = None
        for e in range(3):
            a = S[:, 3 * e:3 * e + 1, :]               # [nt, 1, nc]
            b = S[:, 3 * e + 1:3 * e + 2, :]
            c = S[:, 3 * e + 2:3 * e + 3, :]
            d = uy * b + c
            E = ux * a + d                             # [nt, W, nc]
            cond = E >= EPS
            inside = cond if inside is None else (inside & cond)
        inside = inside & (S[:, 9:10, :] > 0.0)
        cand = torch.where(inside, S[:, 10:11, :], big).min(-1).values
        rows.append(cand)                              # [nt, W]
    out = torch.stack(rows, 1).reshape(height, width).to(torch.int32)
    return torch.where(out > T, -1, out)


def _v2_eval(C, bounds, B, *, T, height, width, row_tile):
    """Plain v2 evaluation given the setup: per tile, its contiguous block
    range [lo, hi) evaluated as (x*a + y*b) + c; the lowest id wins."""
    dev = C.device
    px_tile = row_tile * width
    n_tiles = (height * width) // px_tile
    out = torch.full((n_tiles, px_tile), -1, dtype=torch.int32, device=dev)
    pidx = torch.arange(px_tile, device=dev)
    for i, (lo, hi) in enumerate(bounds.tolist()):
        t0, t1 = lo * B, min(hi * B, T)
        if t1 <= t0:
            continue
        idx = pidx + i * px_tile
        ux = (idx % width).to(torch.float32)[:, None]
        uy = (idx // width).to(torch.float32)[:, None]
        Ct = C[:, t0:t1]
        inside = Ct[9:10] > 0
        for e in range(3):
            E = (ux * Ct[3 * e:3 * e + 1] + uy * Ct[3 * e + 1:3 * e + 2]) \
                + Ct[3 * e + 2:3 * e + 3]
            inside = inside & (E >= EPS)
        ids = torch.arange(t0, t1, device=dev, dtype=torch.int32)[None, :]
        best = torch.where(inside, ids, T + 1).min(-1).values
        out[i] = torch.where(best < T + 1, best, -1)
    return out.reshape(height, width)


def rasterize_tri_ids_v2_ref(vtx_pos, tris, tri_valid, *, height: int,
                             width: int, row_tile: int = 2,
                             tri_block: int = 512):
    """Plain PyTorch version of the v2 kernel."""
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    C, bounds, B = v2_setup(vtx_pos, tris, tri_valid, height=height,
                            width=width, row_tile=row_tile,
                            tri_block=tri_block)
    return _v2_eval(C, bounds, B, T=tris.shape[0], height=height,
                    width=width, row_tile=row_tile)


def _v3_eval(C, lo_blk, nblk_s, long2, B, *, T, height, width, row_tile):
    """Plain v3 evaluation given the setup: per tile, all of its short
    blocks lo_blk + k (k < nblk_s) and all the shared long blocks
    long_lo + k (k < n_lblk), block indices clipped to the block range as
    the Pallas index map does; (x*a + y*b) + c, the lowest original id
    wins."""
    n_blocks = T // B
    dev = C.device
    px_tile = row_tile * width
    n_tiles = (height * width) // px_tile
    long_lo, n_lblk = long2.tolist()
    lblks = [min(max(long_lo + k, 0), n_blocks - 1) for k in range(n_lblk)]
    out = torch.full((n_tiles, px_tile), -1, dtype=torch.int32, device=dev)
    pidx = torch.arange(px_tile, device=dev)
    for i, (lo, ns) in enumerate(zip(lo_blk.tolist(), nblk_s.tolist())):
        blks = [min(max(lo + k, 0), n_blocks - 1)
                for k in range(ns)] + lblks
        if not blks:
            continue
        cols = torch.cat([torch.arange(k * B, (k + 1) * B, device=dev)
                          for k in blks])
        idx = pidx + i * px_tile
        ux = (idx % width).to(torch.float32)[:, None]
        uy = (idx // width).to(torch.float32)[:, None]
        Ct = C[:, cols]
        inside = Ct[9:10] > 0
        for e in range(3):
            E = (ux * Ct[3 * e:3 * e + 1] + uy * Ct[3 * e + 1:3 * e + 2]) \
                + Ct[3 * e + 2:3 * e + 3]
            inside = inside & (E >= EPS)
        ids = Ct[10:11].to(torch.int32)
        best = torch.where(inside, ids, T + 1).min(-1).values
        out[i] = torch.where(best > T, -1, best)
    return out.reshape(height, width)


def rasterize_tri_ids_v3_ref(vtx_pos, tris, tri_valid, *, height: int,
                             width: int, row_tile: int = 2,
                             tri_block: int = 128, long_thresh: float = 64.0):
    """Plain PyTorch version of the v3 kernel: every block a tile needs,
    no budget, no fallback."""
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    C, lo_blk, nblk_s, long2, B = v3_setup(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        tri_block=tri_block, long_thresh=long_thresh)
    return _v3_eval(C, lo_blk, nblk_s, long2, B, T=tris.shape[0],
                    height=height, width=width, row_tile=row_tile)


def rasterize_tri_ids_v4_ref(vtx_pos, tris, tri_valid, *, height: int,
                             width: int, row_tile: int = 2,
                             long_thresh: float = 48.0):
    """Plain PyTorch version of the v4 kernel: exact candidate ranges,
    no budget, no fallback."""
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    C, lo_pos, hi_pos, counts = v4_setup(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        long_thresh=long_thresh)
    return _v4_eval(C, lo_pos, hi_pos, counts, T=tris.shape[0],
                    height=height, width=width, row_tile=row_tile)


def rasterize_tri_ids_v4_batched_ref(vtx_pos, tris, tri_valid, *,
                                     height: int, width: int,
                                     row_tile: int = 2,
                                     long_thresh: float = 48.0):
    """Plain PyTorch version of the batched v4 kernel: the plain v4
    version of each image in turn; [S, H, W] int32."""
    _check_batched(vtx_pos, tris, tri_valid)
    return torch.stack([rasterize_tri_ids_v4_ref(
        vtx_pos[s], tris[s], tri_valid[s], height=height, width=width,
        row_tile=row_tile, long_thresh=long_thresh)
        for s in range(tris.shape[0])])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_batched(vtx_pos, tris, tri_valid):
    if vtx_pos.dim() != 3 or tris.dim() != 3 or tri_valid.dim() != 2 \
            or not (vtx_pos.shape[0] == tris.shape[0]
                    == tri_valid.shape[0] >= 1):
        raise ValueError(
            f"expected vtx_pos [S, N, 2], tris [S, T, 3], tri_valid [S, T] "
            f"with S >= 1, got {tuple(vtx_pos.shape)}, {tuple(tris.shape)}, "
            f"{tuple(tri_valid.shape)}")

def _contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_cuda(vtx_pos, height, width, row_tile):
    # Threads per block: one warp per 2 rows x 64 pixels, at most 1024.
    threads = 32 * -(-row_tile // 2) * -(-width // 64)
    if threads > 1024:
        raise ValueError(f"tile of {row_tile}x{width} pixels needs "
                         f"{threads} threads a block, over 1024")
    if vtx_pos.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {vtx_pos.device}")


def rasterize_tri_ids_v2(vtx_pos, tris, tri_valid, *, height: int,
                         width: int, row_tile: int = 2,
                         tri_block: int = 512):
    """Triangle-id buffer [H, W] int32 by the v2 kernel (block-range
    culling). CPU tensors run the plain version."""
    if vtx_pos.device.type == "cpu":
        return rasterize_tri_ids_v2_ref(
            vtx_pos, tris, tri_valid, height=height, width=width,
            row_tile=row_tile, tri_block=tri_block)
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    _check_cuda(vtx_pos, height, width, row_tile)
    C, bounds, B = v2_setup(vtx_pos, tris, tri_valid, height=height,
                            width=width, row_tile=row_tile,
                            tri_block=tri_block)
    out = torch.empty(height * width, dtype=torch.int32,
                      device=vtx_pos.device)
    _contiguous(C=C, bounds=bounds)
    lib = _get_lib()
    work = work_counters(out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.raster_v2_launch(
            C.data_ptr(), tris.shape[0], bounds.data_ptr(), B, out.data_ptr(),
            height, width, row_tile, work.data_ptr(), stream)
    rasterize_tri_ids_v2.launches += 1
    if err != 0:
        raise RuntimeError(f"raster_v2 launch failed: cudaError {err}")
    return out.reshape(height, width)


def rasterize_tri_ids_v4(vtx_pos, tris, tri_valid, *, height: int,
                         width: int, row_tile: int = 2,
                         long_thresh: float = 48.0):
    """Triangle-id buffer [H, W] int32 by the v4 kernel (exact per-tile
    candidate ranges of any length). CPU tensors run the plain version."""
    if vtx_pos.device.type == "cpu":
        return rasterize_tri_ids_v4_ref(
            vtx_pos, tris, tri_valid, height=height, width=width,
            row_tile=row_tile, long_thresh=long_thresh)
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    _check_cuda(vtx_pos, height, width, row_tile)
    C, lo_pos, hi_pos, counts = v4_setup(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        long_thresh=long_thresh)
    out = torch.empty(height * width, dtype=torch.int32,
                      device=vtx_pos.device)
    _contiguous(C=C, lo_pos=lo_pos, hi_pos=hi_pos, counts=counts)
    lib = _get_lib()
    work = work_counters(out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.raster_v4_launch(
            C.data_ptr(), tris.shape[0], lo_pos.data_ptr(), hi_pos.data_ptr(),
            counts.data_ptr(), out.data_ptr(), height, width, row_tile,
            work.data_ptr(), stream)
    rasterize_tri_ids_v4.launches += 1
    if err != 0:
        raise RuntimeError(f"raster_v4 launch failed: cudaError {err}")
    return out.reshape(height, width)


def rasterize_tri_ids_v4_batched(vtx_pos, tris, tri_valid, *, height: int,
                                 width: int, row_tile: int = 2,
                                 long_thresh: float = 48.0):
    """Triangle-id buffers [S, H, W] int32 of S images (vtx_pos [S, N, 2],
    tris [S, T, 3], tri_valid [S, T]) by one launch of the batched v4
    kernel; image s gets what rasterize_tri_ids_v4 gives it alone. CPU
    tensors run the plain version."""
    if vtx_pos.device.type == "cpu":
        return rasterize_tri_ids_v4_batched_ref(
            vtx_pos, tris, tri_valid, height=height, width=width,
            row_tile=row_tile, long_thresh=long_thresh)
    _check_batched(vtx_pos, tris, tri_valid)
    _check(vtx_pos[0], tris[0], tri_valid[0], height, width, row_tile)
    _check_cuda(vtx_pos, height, width, row_tile)
    C, lo_pos, hi_pos, counts = v4_setup_batched(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        long_thresh=long_thresh)
    S, T = tris.shape[:2]
    out = torch.empty((S, height * width), dtype=torch.int32,
                      device=vtx_pos.device)
    _contiguous(C=C, lo_pos=lo_pos, hi_pos=hi_pos, counts=counts)
    lib = _get_lib()
    work = work_counters(out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.raster_v4_batched_launch(
            C.data_ptr(), S, T, lo_pos.data_ptr(), hi_pos.data_ptr(),
            counts.data_ptr(), out.data_ptr(), height, width, row_tile,
            work.data_ptr(), stream)
    rasterize_tri_ids_v4_batched.launches += 1
    rasterize_tri_ids_v4_batched.images += S
    if err != 0:
        raise RuntimeError(f"raster_v4_batched launch failed: cudaError {err}")
    return out.reshape(S, height, width)


def rasterize_tri_ids_v3(vtx_pos, tris, tri_valid, *, height: int,
                         width: int, row_tile: int = 2, tri_block: int = 128,
                         long_thresh: float = 64.0):
    """Triangle-id buffer [H, W] int32 by the v3 kernel (every block of
    `tri_block` sorted columns that a tile needs, no budget). CPU tensors
    run the plain version."""
    if vtx_pos.device.type == "cpu":
        return rasterize_tri_ids_v3_ref(
            vtx_pos, tris, tri_valid, height=height, width=width,
            row_tile=row_tile, tri_block=tri_block, long_thresh=long_thresh)
    _check(vtx_pos, tris, tri_valid, height, width, row_tile)
    _check_cuda(vtx_pos, height, width, row_tile)
    C, lo_blk, nblk_s, long2, B = v3_setup(
        vtx_pos, tris, tri_valid, height=height, row_tile=row_tile,
        tri_block=tri_block, long_thresh=long_thresh)
    out = torch.empty(height * width, dtype=torch.int32,
                      device=vtx_pos.device)
    _contiguous(C=C, lo_blk=lo_blk, nblk_s=nblk_s, long2=long2)
    lib = _get_lib()
    work = work_counters(out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.raster_v3_launch(
            C.data_ptr(), tris.shape[0], lo_blk.data_ptr(), nblk_s.data_ptr(),
            long2.data_ptr(), B, out.data_ptr(), height, width, row_tile,
            work.data_ptr(), stream)
    rasterize_tri_ids_v3.launches += 1
    if err != 0:
        raise RuntimeError(f"raster_v3 launch failed: cudaError {err}")
    return out.reshape(height, width)


rasterize_tri_ids_v4.launches = 0
rasterize_tri_ids_v3.launches = 0
rasterize_tri_ids_v2.launches = 0
rasterize_tri_ids_v4_batched.launches = 0
rasterize_tri_ids_v4_batched.images = 0
