"""Image pyramids stored as a single padded [L, H, W] tensor.

A frozen copy of the port's module, whose counterpart is `flame_ros_tpu/ops/pyramid.py`, with the same layout so
pyramid leaves compare directly against the JAX package: level l is a
2^l-downsampled (2x2 mean-pooled) image stored row-major flat at the
start of plane l (its own row stride W>>l, zero padding after). Level 0
fills its plane, so `pyr[0]` is the full-resolution image. One fixed
shape for all levels makes per-feature level selection pure index math:
one gather serves every scale.

The 2x2 mean is a pooling op here (the JAX package used banded matrix
products, a TPU layout workaround).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from flamebench.reference.interp import take_clip

# A CPU scalar operand: it joins a tensor on any device with no copy.
_ZERO = torch.tensor(0.0)


def build_pyramid(img, num_levels: int = 3):
    """img [H, W] -> [L, H, W] padded pyramid (2x2 mean pooling). Built
    out of place, so that it also runs under torch.func.vmap."""
    H, W = img.shape
    if H % (1 << (num_levels - 1)) or W % (1 << (num_levels - 1)):
        raise ValueError(f"image {H}x{W} not divisible by "
                         f"2^{num_levels - 1}")
    levels = [img.reshape(-1)]
    cur = img
    for _ in range(1, num_levels):
        cur = F.avg_pool2d(cur[None, None], 2)[0, 0]
        levels.append(F.pad(cur.reshape(-1), (0, H * W - cur.numel())))
    return torch.stack(levels).reshape(num_levels, H, W)


def level_view(pyr, lvl: int):
    """2D [H>>l, W>>l] view of level l (host/debug use)."""
    L, H, W = pyr.shape
    h, w = H >> lvl, W >> lvl
    return pyr[lvl].reshape(-1)[:h * w].reshape(h, w)


def _level_coords(uv, level_f):
    """Level-0 pixel coords -> level-l coords (pixel-center aligned)."""
    scale = torch.exp2(-level_f)
    u = (uv[..., 0] + 0.5) * scale - 0.5
    v = (uv[..., 1] + 0.5) * scale - 0.5
    return u, v, scale


def _sample(flat, base, H, W, uv, level, out_of_bounds):
    level = torch.broadcast_to(level, uv[..., 0].shape)
    level_f = level.to(torch.float32)
    u, v, scale = _level_coords(uv, level_f)
    Wl = W * scale
    Hl = H * scale
    valid = (u >= 0) & (u <= Wl - 1) & (v >= 0) & (v <= Hl - 1)
    # maximum/minimum (not clamp) so that forward mode splits a tie
    # 0.5/0.5, as jnp.clip does (bundle adjustment differentiates here).
    u = torch.minimum(torch.maximum(u, _ZERO),
                      torch.clamp(Wl - 1.000001, min=0.0))
    v = torch.minimum(torch.maximum(v, _ZERO),
                      torch.clamp(Hl - 1.000001, min=0.0))
    u0 = torch.clamp(torch.minimum(torch.floor(u).to(torch.int32),
                                   (Wl - 2).to(torch.int32)), min=0)
    v0 = torch.clamp(torch.minimum(torch.floor(v).to(torch.int32),
                                   (Hl - 2).to(torch.int32)), min=0)
    au = u - u0
    av = v - v0
    # Levels are raveled with their own row stride W>>l.
    Wl_i = torch.round(Wl).to(torch.int64)
    idx = base + level.to(torch.int64) * (H * W) + v0 * Wl_i + u0
    i00 = take_clip(flat, idx)
    i01 = take_clip(flat, idx + 1)
    i10 = take_clip(flat, idx + Wl_i)
    i11 = take_clip(flat, idx + Wl_i + 1)
    val = ((i00 * (1 - au) + i01 * au) * (1 - av)
           + (i10 * (1 - au) + i11 * au) * av)
    return torch.where(valid, val, torch.full_like(val, out_of_bounds)), valid


def bilinear_pyramid(pyr, uv, level, *, out_of_bounds: float = 0.0):
    """Bilinear sample pyramid [L, H, W] at level-0 coords `uv` from
    `level` (int, broadcastable to uv[..., 0]). Returns (values, valid)."""
    L, H, W = pyr.shape
    return _sample(pyr.reshape(-1), 0, H, W, uv, level, out_of_bounds)


def bilinear_pyramid_batched(pyrs_flat, row_idx, shape, uv, level,
                             *, out_of_bounds: float = 0.0):
    """Like bilinear_pyramid over a batch of pyramids.

    pyrs_flat: [K, L*H*W] flattened pyramids; row_idx: [N] int selecting
    a pyramid per leading element of uv [N, ..., 2]; shape: (L, H, W).
    The pyramid id folds into the flat index: one gather."""
    L, H, W = shape
    shape_suffix = (1,) * (uv.dim() - 2)
    base = row_idx.to(torch.int64).reshape(row_idx.shape + shape_suffix) \
        * (L * H * W)
    return _sample(pyrs_flat.reshape(-1), base, H, W, uv, level,
                   out_of_bounds)
