"""Pinhole camera model: intrinsics, projection, backprojection,
undistortion.

Counterpart of `flame_ros_tpu/geometry/camera.py`. The camera is a small
frozen dataclass whose ops take torch tensors and broadcast over batches
of points. The dataset rectification (`undistort_maps`,
`remap_bilinear`) is host numpy, as in the JAX package.
"""
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

    @staticmethod
    def from_K(K, width: int, height: int) -> "Pinhole":
        K = np.asarray(K)
        return Pinhole(float(K[0, 0]), float(K[1, 1]),
                       float(K[0, 2]), float(K[1, 2]), int(width), int(height))

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx],
                         [0, self.fy, self.cy],
                         [0, 0, 1]], dtype=np.float32)

    @property
    def Kinv(self) -> np.ndarray:
        return np.linalg.inv(self.K).astype(np.float32)

    def scaled(self, factor: float) -> "Pinhole":
        """Camera for an image resized by 1/factor (reference
        resize_factor)."""
        s = 1.0 / factor
        return Pinhole(self.fx * s, self.fy * s, self.cx * s, self.cy * s,
                       int(round(self.width * s)), int(round(self.height * s)))

    # ---- tensor ops ---------------------------------------------------
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


def undistort_maps(cam: Pinhole, dist_coeffs,
                   raw_K=None) -> tuple[np.ndarray, np.ndarray]:
    """Plumb-bob (radtan: k1, k2, p1, p2[, k3]) undistortion maps, host
    numpy (reference: image_geometry's rectifyImage,
    tum_rgbd_offline_stream.cc:197-200).

    Returns (map_u, map_v) [H, W]: for each rectified pixel, its source
    pixel in the distorted image (for `remap_bilinear`). A rectified pixel
    is normalized by the rectified intrinsics `cam` (the P-matrix side),
    distorted, and mapped to pixels by `raw_K` (the CameraInfo
    camera_matrix side); with raw_K None the two are taken as equal."""
    d = np.zeros(5, np.float64)
    dc = np.asarray(dist_coeffs, np.float64).ravel()
    d[:dc.size] = dc
    k1, k2, p1, p2, k3 = d
    if raw_K is None:
        rfx, rfy, rcx, rcy = cam.fx, cam.fy, cam.cx, cam.cy
    else:
        rK = np.asarray(raw_K, np.float64)
        rfx, rfy, rcx, rcy = rK[0, 0], rK[1, 1], rK[0, 2], rK[1, 2]
    vs, us = np.meshgrid(np.arange(cam.height), np.arange(cam.width),
                         indexing="ij")
    x = (us - cam.cx) / cam.fx
    y = (vs - cam.cy) / cam.fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_u = (xd * rfx + rcx).astype(np.float32)
    map_v = (yd * rfy + rcy).astype(np.float32)
    return map_u, map_v


def remap_bilinear(img: np.ndarray, map_u: np.ndarray,
                   map_v: np.ndarray) -> np.ndarray:
    """Host bilinear remap (numpy) for dataset rectification; integer
    images come back in their own dtype."""
    h, w = img.shape[:2]
    u0 = np.clip(np.floor(map_u).astype(np.int32), 0, w - 2)
    v0 = np.clip(np.floor(map_v).astype(np.int32), 0, h - 2)
    au = np.clip(map_u - u0, 0.0, 1.0)
    av = np.clip(map_v - v0, 0.0, 1.0)
    if img.ndim == 3:
        au, av = au[..., None], av[..., None]
    f = img.astype(np.float32)
    out = ((f[v0, u0] * (1 - au) + f[v0, u0 + 1] * au) * (1 - av)
           + (f[v0 + 1, u0] * (1 - au) + f[v0 + 1, u0 + 1] * au) * av)
    return (out.astype(img.dtype) if np.issubdtype(img.dtype, np.integer)
            else out)
