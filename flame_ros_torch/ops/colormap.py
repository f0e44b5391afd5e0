"""Jet colormap (device + host).

Counterpart of `flame_ros_tpu/ops/colormap.py`: parity with
flame::utils::jet / applyColorMap<T> (reference usage:
src/flame_offline_tum.cc:336-342 — error images; debug idepth maps are
colored by scene_color_scale * idepth before mapping, cfg
output/scene_color_scale). `jet` runs on tensors; `jet_u8` and
`apply_colormap_over` are host (numpy) code.
"""
from __future__ import annotations

import numpy as np
import torch


def jet(v, vmin: float = 0.0, vmax: float = 1.0) -> torch.Tensor:
    """Map values [...] (a tensor, or anything torch.as_tensor takes) ->
    RGB float [..., 3] in [0, 1] (classic jet)."""
    t = torch.clamp((torch.as_tensor(v) - vmin) / max(vmax - vmin, 1e-12),
                    0.0, 1.0)
    r = torch.clamp(1.5 - torch.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(4.0 * t - 1.0), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def jet_u8(v: np.ndarray, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """Host variant returning uint8 RGB."""
    t = np.clip((np.asarray(v, np.float64) - vmin) / max(vmax - vmin, 1e-12),
                0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * t - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def apply_colormap_over(base_rgb: np.ndarray, values: np.ndarray,
                        vmin: float, vmax: float) -> np.ndarray:
    """Overlay jet-colored `values` (NaN = keep base) onto an RGB image
    (reference applyColorMap semantics)."""
    out = base_rgb.copy()
    m = np.isfinite(values)
    out[m] = jet_u8(values[m], vmin, vmax)
    return out
