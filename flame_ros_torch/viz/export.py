"""Mesh / depth-map / point-cloud serialization.

Counterpart of `flame_ros_tpu/viz/export.py` (host numpy code, the same
bytes).

Replaces the reference's ROS publishers (publishDepthMesh src/utils.cc:163,
publishDepthMap :239, publishPointCloud :275): vertices arrive as pixel
coords + inverse depth and are backprojected through Kinv at export time
exactly like the reference (utils.cc:184-209: xyz = Kinv (u, v, 1) / xi),
carrying per-vertex normals and texture coordinates (the reference's
PointNormalUV layout, utils.h:47-57). Output formats: binary-little PLY
(mesh + cloud) and NPZ.
"""
from __future__ import annotations

import struct

import numpy as np


def backproject_mesh(vertices_px: np.ndarray, idepths: np.ndarray,
                     K: np.ndarray, width: int = None, height: int = None):
    """Pixel-space vertices -> 3D camera-frame points + uv texcoords."""
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    uv1 = np.concatenate(
        [vertices_px, np.ones((len(vertices_px), 1))], -1)
    rays = uv1 @ Kinv.T
    xyz = rays / np.maximum(idepths, 1e-9)[:, None]
    w = width or (vertices_px[:, 0].max() + 1 if len(vertices_px) else 1)
    h = height or (vertices_px[:, 1].max() + 1 if len(vertices_px) else 1)
    tex = np.stack([vertices_px[:, 0] / w, vertices_px[:, 1] / h], -1)
    return xyz.astype(np.float32), tex.astype(np.float32)


def write_ply_mesh(path: str, vertices_px, idepths, normals, tris,
                   tri_keep, K, *, rgb: np.ndarray = None,
                   width: int = None, height: int = None):
    """Binary PLY with xyz + normal + uv (+ optional per-vertex color
    sampled from the frame), faces filtered by tri_keep (the reference's
    display filters applied at publish time)."""
    xyz, tex = backproject_mesh(vertices_px, idepths, K, width, height)
    n = len(xyz)
    faces = np.asarray(tris)[np.asarray(tri_keep, bool)]
    colors = None
    if rgb is not None:
        u = np.clip(np.round(vertices_px[:, 0]).astype(int), 0,
                    rgb.shape[1] - 1)
        v = np.clip(np.round(vertices_px[:, 1]).astype(int), 0,
                    rgb.shape[0] - 1)
        colors = np.asarray(rgb)[v, u].astype(np.uint8)
        if colors.ndim == 1:
            colors = np.stack([colors] * 3, -1)

    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z",
               "property float nx", "property float ny", "property float nz",
               "property float u", "property float v"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        norm = np.asarray(normals, np.float32)
        for i in range(n):
            f.write(struct.pack("<8f", *xyz[i], *norm[i], *tex[i]))
            if colors is not None:
                f.write(struct.pack("<3B", *colors[i]))
        for face in faces:
            f.write(struct.pack("<B3i", 3, *[int(x) for x in face]))


def depthmap_to_cloud(idepth_map: np.ndarray, K: np.ndarray,
                      min_depth: float = 0.0,
                      max_depth: float = np.inf) -> np.ndarray:
    """Dense idepth map -> [M, 3] camera-frame points (reference
    publishPointCloud semantics incl. min/max depth gates)."""
    H, W = idepth_map.shape
    v, u = np.mgrid[0:H, 0:W]
    xi = np.asarray(idepth_map)
    ok = np.isfinite(xi) & (xi > 0)
    depth = np.where(ok, 1.0 / np.maximum(xi, 1e-9), 0.0)
    ok &= (depth > min_depth) & (depth < max_depth)
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    pts = np.stack([u[ok], v[ok], np.ones(ok.sum())], -1) @ Kinv.T
    return (pts * depth[ok][:, None]).astype(np.float32)


def write_ply_cloud(path: str, points: np.ndarray):
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(points)}",
               "property float x", "property float y", "property float z",
               "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(np.asarray(points, "<f4").tobytes())
