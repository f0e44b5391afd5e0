"""Peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W) and the
least time of the batched v4 raster kernel on its own inputs: the larger
of its bytes (inputs and output, each once) over the HBM3 rate and its
inside tests over the f32 instruction rate.

The kernel is built with -fmad=false, so a multiply and an add issue as
two instructions: 132 SMs x 128 f32 lanes x the 1.98 GHz boost clock
that the data sheet's 67 TFLOP/s (an FMA counted as two flops) implies.
An inside test costs 6 f32 instructions (x*a + d per edge, the per-row
term hoisted). The tests the id buffer needs are the (pixel, valid
triangle) pairs whose pixel lies in the triangle's bounding box.
(Frozen from the repository's `chip_smoke.py`, `bbox_pairs` and the
phase 10 bound.)"""
from __future__ import annotations

F32_INSTR_RATE = 132 * 128 * 1.98e9     # f32 instructions/s
PEAK_BYTES = 3.35e12                    # HBM3 bytes/s
INSTR_PER_TEST_V4 = 6
ROW_TILE = 2                            # rows per v4 tile
SLAB_ROWS = 11                          # 9 edge coefficients, validity, id


def bbox_pairs(pos, tris, tv, height: int, width: int) -> int:
    """(pixel, valid triangle) pairs whose pixel lies in the triangle's
    bounding box, for one image (pos [N, 2], tris [T, 3], tv [T])."""
    import torch
    t = tris.long()[tv]
    p = pos[t]                                   # [n, 3, 2]
    lo = torch.ceil(p.min(1).values).clamp(min=0)
    hi = torch.floor(p.max(1).values)
    hi = torch.minimum(hi, torch.tensor([width - 1.0, height - 1.0],
                                        device=pos.device))
    n = (hi - lo + 1).clamp(min=0)
    return int((n[:, 0] * n[:, 1]).sum())


def v4_batched_bytes(S: int, T: int, height: int, width: int) -> int:
    """Bytes the batched v4 launch must move: its sorted slabs [S, 11, T]
    f32, tile ranges lo/hi [S, H / 2] int32 and counts [S, 2] int32 in,
    the id buffers [S, H, W] int32 out."""
    slab = S * (SLAB_ROWS * T * 4 + 2 * (height // ROW_TILE) * 4 + 2 * 4)
    return slab + S * height * width * 4


def v4_batched_bound_s(vtx_pos, tris, tri_valid, height: int,
                       width: int) -> tuple:
    """(least seconds, "operations" or "bytes") of one batched v4 launch
    on vtx_pos [S, N, 2], tris [S, T, 3], tri_valid [S, T]."""
    S, T = tris.shape[:2]
    pairs = sum(bbox_pairs(vtx_pos[k], tris[k], tri_valid[k], height, width)
                for k in range(S))
    ops_s = pairs * INSTR_PER_TEST_V4 / F32_INSTR_RATE
    bytes_s = v4_batched_bytes(S, T, height, width) / PEAK_BYTES
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")
