"""Image gradients: central differences + magnitude (the trackability
signal behind feature detection). The benchmark's frozen copy of the port's module, whose counterpart is
`flame_ros_tpu/ops/gradients.py`."""
from __future__ import annotations

import torch


def central_gradients(img):
    """Central differences. img [H, W] -> (gx, gy) each [H, W].

    Border pixels use one-sided differences."""
    gx_mid = 0.5 * (img[:, 2:] - img[:, :-2])
    gx = torch.cat([img[:, 1:2] - img[:, 0:1], gx_mid,
                    img[:, -1:] - img[:, -2:-1]], dim=1)
    gy_mid = 0.5 * (img[2:, :] - img[:-2, :])
    gy = torch.cat([img[1:2, :] - img[0:1, :], gy_mid,
                    img[-1:, :] - img[-2:-1, :]], dim=0)
    return gx, gy


def gradient_magnitude(img):
    gx, gy = central_gradients(img)
    return torch.sqrt(gx * gx + gy * gy)
