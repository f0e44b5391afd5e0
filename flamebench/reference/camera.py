"""Pinhole camera: the tensor ops of the port's
`flame_ros_torch/geometry/camera.py`, frozen for the benchmark's
reference."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], dtype=np.float32)

    @property
    def Kinv(self) -> np.ndarray:
        return np.linalg.inv(self.K).astype(np.float32)

    def project(self, pts):
        """Camera-frame 3D points [..., 3] -> pixel coords [..., 2] (u, v)."""
        z = pts[..., 2]
        u = self.fx * pts[..., 0] / z + self.cx
        v = self.fy * pts[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def backproject(self, uv, idepth):
        """Pixels [..., 2] + inverse depth [...] -> camera-frame 3D [..., 3]."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        d = 1.0 / idepth
        return torch.stack([x * d, y * d, d], dim=-1)

    def ray(self, uv):
        """Unit-depth ray Kinv @ (u, v, 1): [..., 3] with z == 1."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def in_bounds(self, uv, margin: float = 0.0):
        u, v = uv[..., 0], uv[..., 1]
        return ((u >= margin) & (u <= self.width - 1 - margin)
                & (v >= margin) & (v <= self.height - 1 - margin))
