"""Bilinear and nearest image sampling on torch tensors.

A frozen copy of the port's module, whose counterpart is `flame_ros_tpu/ops/interp.py`: the gather primitive behind
dense warping (reference `interpolate` stage, msg/FlameStats.msg:34).
Indices are clamped into range before every gather, as `jnp.take(...,
mode="clip")` does.
"""
from __future__ import annotations

import torch


def take_clip(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[idx] with idx clamped to [0, numel-1]."""
    return flat[idx.clamp(0, flat.numel() - 1)]


def bilinear(img, uv, *, out_of_bounds: float = 0.0):
    """Sample img [H, W] at uv [..., 2] (u=x=col, v=y=row), bilinear.

    Returns (values [...], valid [...]); out-of-bounds samples give
    `out_of_bounds`."""
    H, W = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    valid = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.clamp(u, 0.0, W - 1.000001)
    v = torch.clamp(v, 0.0, H - 1.000001)
    u0 = torch.clamp(torch.floor(u).to(torch.int32), max=W - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int32), max=H - 2)
    au = u - u0
    av = v - v0
    flat = img.reshape(-1)
    idx = (v0 * W + u0).long()
    i00 = take_clip(flat, idx)
    i01 = take_clip(flat, idx + 1)
    i10 = take_clip(flat, idx + W)
    i11 = take_clip(flat, idx + W + 1)
    val = ((i00 * (1 - au) + i01 * au) * (1 - av)
           + (i10 * (1 - au) + i11 * au) * av)
    return torch.where(valid, val, torch.full_like(val, out_of_bounds)), valid


def nearest(img, uv, *, out_of_bounds: float = 0.0):
    """Nearest-neighbor sample img [H, W] at uv [..., 2]."""
    H, W = img.shape
    u = torch.round(uv[..., 0]).to(torch.int32)
    v = torch.round(uv[..., 1]).to(torch.int32)
    valid = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    idx = (v.clamp(0, H - 1) * W + u.clamp(0, W - 1)).long()
    val = take_clip(img.reshape(-1), idx)
    return torch.where(valid, val, torch.full_like(val, out_of_bounds)), valid
