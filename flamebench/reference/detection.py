"""Grid-based feature detection.

A frozen copy of the port's module, whose counterpart is `flame_ros_tpu/ops/detection.py`: partition the image into
win_size x win_size cells and select the best trackable pixel per cell —
highest gradient magnitude above `min_grad_mag` (the first maximum in
row-major cell order, as `jnp.argmax` picks) — skipping cells already
covered by live features. `do_letterbox` restricts detection to the
middle third of cell rows (reference cfg features/detection).
"""
from __future__ import annotations

import torch

from flamebench.reference.gradients import gradient_magnitude


def cell_grid_shape(height: int, width: int, win_size: int):
    return height // win_size, width // win_size


def detect_features(img, occupied_cells, *, win_size: int,
                    min_grad_mag: float, do_letterbox: bool = False):
    """One candidate feature per free grid cell.

    img [H, W] float32; occupied_cells [nCy, nCx] bool. Returns
    (uv [n_cells, 2] float32, score [n_cells], valid [n_cells] bool)."""
    H, W = img.shape
    dev = img.device
    nCy, nCx = cell_grid_shape(H, W, win_size)
    Hc, Wc = nCy * win_size, nCx * win_size

    mag = gradient_magnitude(img)
    border = 2   # patch sampling needs margin
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    interior = ((row >= border) & (row < H - border)
                & (col >= border) & (col < W - border))
    mag = torch.where(interior, mag, torch.full_like(mag, -1.0))

    cells = mag[:Hc, :Wc].reshape(nCy, win_size, nCx, win_size)
    cells = cells.permute(0, 2, 1, 3).reshape(nCy, nCx, win_size * win_size)
    best = torch.argmax(cells, dim=-1)           # first maximum
    score = torch.take_along_dim(cells, best[..., None], dim=-1)[..., 0]
    dy = best // win_size
    dx = best % win_size
    cy = torch.arange(nCy, device=dev)[:, None].expand(nCy, nCx)
    cx = torch.arange(nCx, device=dev)[None, :].expand(nCy, nCx)
    u = (cx * win_size + dx).to(torch.float32)
    v = (cy * win_size + dy).to(torch.float32)

    valid = (score >= min_grad_mag) & ~occupied_cells
    if do_letterbox:
        valid = valid & (cy >= nCy // 3) & (cy < (2 * nCy) // 3)

    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    return uv, score.reshape(-1), valid.reshape(-1)


def occupancy_from_features(feat_uv, feat_valid, height: int, width: int,
                            win_size: int):
    """Mark cells containing a live feature as occupied: a plain scatter
    (invalid features scatter into a dummy cell that is dropped).

    feat_uv [N, 2] current-frame positions; feat_valid [N] bool.
    Returns [nCy, nCx] bool."""
    nCy, nCx = cell_grid_shape(height, width, win_size)
    cx = torch.clamp(torch.floor(feat_uv[:, 0] / win_size).to(torch.int32),
                     0, nCx - 1)
    cy = torch.clamp(torch.floor(feat_uv[:, 1] / win_size).to(torch.int32),
                     0, nCy - 1)
    C = nCy * nCx
    cell = torch.where(feat_valid, cy * nCx + cx, C).long()
    occ = torch.zeros(C + 1, dtype=torch.bool,
                      device=feat_uv.device).index_fill(0, cell, True)
    return occ[:C].reshape(nCy, nCx)
