"""The benchmark's frozen copy of the port's synthetic room renderer
(`flame_ros_torch/datasets/synthetic.py`, scene "room"), batched over
poses: bounded textured planes ray-cast analytically, textures of
multi-octave value noise from numpy generators seeded per plane. Frames
come out as uint8 [B, H, W], the truncation the runner applies to a float
image. Depth is not kept: no ground truth is sent.

The planes, their extents and their noise tables are put on the device
once (`_scene`), so a chunk of frames makes no copy from the host, and a
plane's texture is worked out only where that plane is the nearest so
far."""
from __future__ import annotations

import functools

import numpy as np
import torch

# (point, normal, tangent_u, tangent_v, half_u, half_v, texture seed)
ROOM = (
    ((0, 0, 4.0), (0, 0, -1), (1, 0, 0), (0, 1, 0), 3.0, 2.0, 1),
    ((-2.5, 0, 2.0), (1, 0, 0), (0, 0, 1), (0, 1, 0), 3.0, 2.0, 2),
    ((2.5, 0, 2.0), (-1, 0, 0), (0, 0, 1), (0, 1, 0), 3.0, 2.0, 3),
    ((0, 1.5, 2.0), (0, -1, 0), (1, 0, 0), (0, 0, 1), 3.0, 3.0, 4),
    ((0, -1.5, 2.0), (0, 1, 0), (1, 0, 0), (0, 0, 1), 3.0, 3.0, 5),
    ((0.6, 0.9, 2.2), (0, 0, -1), (1, 0, 0), (0, 1, 0), 0.6, 0.6, 6),
    ((0.6, 0.3, 2.5), (0, -1, 0), (1, 0, 0), (0, 0, 1), 0.6, 0.3, 7),
    ((-1.0, -0.2, 2.8), (0.5547, 0, -0.83205), (0.83205, 0, 0.5547),
     (0, 1, 0), 0.7, 0.7, 8),
)
OCTAVES = ((12, 1.0), (48, 0.65), (192, 0.45))    # (table size, amplitude)


@functools.lru_cache(maxsize=None)
def _scene(device: str) -> list:
    """The room's planes on `device`: vectors, the extents and the
    octave sum as 0-dim tensors (true divisions on every device), the
    noise tables."""
    dev = torch.device(device)

    def const(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    planes = []
    for p0, n, tu_ax, tv_ax, eu, ev, seed in ROOM:
        rng = np.random.default_rng(seed)
        tables = [(torch.from_numpy(rng.uniform(-1.0, 1.0, (size, size))
                                    .astype(np.float32)).to(dev), amp)
                  for size, amp in OCTAVES]
        planes.append({
            "p0": const(p0), "n": const(n), "tu": const(tu_ax),
            "tv": const(tv_ax), "half_u": float(eu), "half_v": float(ev),
            "eu": const(float(eu)), "ev": const(float(ev)),
            "total": const(sum(a for _, a in OCTAVES)), "tables": tables})
    return planes


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _noise_octave(u, v, table):
    S = table.shape[0]
    u = torch.clamp(u, 0.0, S - 1.001)
    v = torch.clamp(v, 0.0, S - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    i00 = table[v0, u0]
    i01 = table[v0, u0 + 1]
    i10 = table[v0 + 1, u0]
    i11 = table[v0 + 1, u0 + 1]
    return ((i00 * (1 - fu) + i01 * fu) * (1 - fv)
            + (i10 * (1 - fu) + i11 * fu) * fv)


def _texture(tu, tv, plane):
    val = torch.zeros_like(tu)
    for table, amp in plane["tables"]:
        size = table.shape[0]
        u = (tu / plane["eu"] * 0.5 + 0.5) * (size - 1)
        v = (tv / plane["ev"] * 0.5 + 0.5) * (size - 1)
        val = val + amp * _noise_octave(u, v, table)
    val = val / plane["total"]
    return torch.clamp(val * 0.5 + 0.5, 0.0, 1.0) * 215.0 + 20.0


def _quat_rotate(q, v):
    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                           -1)
    qv = q[..., 1:]
    uv = 2.0 * cross(qv, v)
    return v + q[..., :1] * uv + cross(qv, uv)


def render_room(cam, q, t) -> torch.Tensor:
    """Gray frames uint8 [B, H, W] of the room seen from camera-to-world
    poses q [B, 4] (w, x, y, z), t [B, 3] (RDF world), on q's device."""
    dev = q.device
    H, W = cam["height"], cam["width"]
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    f = torch.tensor([cam["fx"], cam["fy"]], dtype=torch.float32,
                     device=dev)
    rays = torch.stack([(u - cam["cx"]) / f[0], (v - cam["cy"]) / f[1],
                        torch.ones_like(u)], -1)
    d_w = _quat_rotate(q[:, None, None, :], rays[None])      # [B, H, W, 3]
    o_w = t[:, None, None, :]
    best_depth = torch.full(d_w.shape[:3], float("inf"), device=dev)
    best_val = torch.zeros(d_w.shape[:3], device=dev)
    for pl in _scene(str(dev)):
        p0, n = pl["p0"], pl["n"]
        denom = _dot(d_w, n)
        s = _dot(p0 - o_w, n) / torch.where(
            torch.abs(denom) < 1e-9, float("inf"), denom)
        rel = o_w + s[..., None] * d_w - p0
        tu = _dot(rel, pl["tu"])
        tv = _dot(rel, pl["tv"])
        inside = ((torch.abs(tu) <= pl["half_u"])
                  & (torch.abs(tv) <= pl["half_v"]) & (s > 0.05))
        depth = torch.where(inside, s, float("inf"))
        closer = depth < best_depth
        best_val[closer] = _texture(tu[closer], tv[closer], pl)
        best_depth = torch.minimum(best_depth, depth)
    gray = torch.where(torch.isfinite(best_depth), best_val,
                       torch.zeros_like(best_val))
    return torch.clamp(gray, 0.0, 255.0).to(torch.uint8)
