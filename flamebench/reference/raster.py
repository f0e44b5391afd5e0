"""Plain triangle rasterization: the id buffer of the v4 kernel's plain
PyTorch version (`flame_ros_torch/ops/raster_cuda.py::
rasterize_tri_ids_v4_ref`), affine idepth planes and the dense map of
`flame_ros_torch/ops/raster.py`, frozen for the benchmark's reference.

One image at a time, no kernel and no batching: the candidate ranges
come from a stable sort of the triangles by (class, ymin) and every tile
of two rows tests its whole short range and the whole long range, the
lowest original id winning."""
from __future__ import annotations

import torch

OFF = 1e7          # class offset of the sort key
EPS = -1e-3        # inside-test tolerance of the edge functions
ROW_TILE = 2
LONG_THRESH = 48.0


def triangle_planes(vtx_pos, vtx_x, tris, tri_valid):
    """(g [T, 3] with idepth(u, v) = g0 + g1*u + g2*v, valid [T]);
    degenerate triangles are invalidated."""
    t = tris.long()
    a = vtx_pos[t[:, 0]]
    b = vtx_pos[t[:, 1]]
    c = vtx_pos[t[:, 2]]
    xa, xb, xc = vtx_x[t[:, 0]], vtx_x[t[:, 1]], vtx_x[t[:, 2]]
    d = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
         - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    ok = torch.abs(d) > 1e-6
    dd = torch.where(ok, d, torch.ones_like(d))
    g1 = ((xb - xa) * (c[:, 1] - a[:, 1])
          - (xc - xa) * (b[:, 1] - a[:, 1])) / dd
    g2 = ((xc - xa) * (b[:, 0] - a[:, 0])
          - (xb - xa) * (c[:, 0] - a[:, 0])) / dd
    g0 = xa - g1 * a[:, 0] - g2 * a[:, 1]
    return torch.stack([g0, g1, g2], -1), tri_valid & ok


def edge_coeffs(p0, p1):
    """[..., 3, T] (a, b, c) of E(x, y) = a x + b y + c for the edges
    p0 -> p1 [..., T, 2]."""
    dy = p1[..., 1] - p0[..., 1]
    dx = p1[..., 0] - p0[..., 0]
    return torch.stack([-dy, dx, dy * p0[..., 0] - dx * p0[..., 1]], -2)


def _setup(vtx_pos, tris, tri_valid, height):
    """(C [11, T] sorted slab = 9 edge coefficients, validity, original
    id; lo_pos, hi_pos [n_tiles]; counts [2] = (n_short, n_live))."""
    dev = vtx_pos.device
    n_tiles = height // ROW_TILE
    t = tris.long()
    a, b, c = (vtx_pos[t[:, k]] for k in range(3))
    ys = torch.stack([a[:, 1], b[:, 1], c[:, 1]], -1)
    ymin = ys.min(-1).values
    extent = ys.max(-1).values - ymin
    klass = torch.where(tri_valid,
                        torch.where(extent <= LONG_THRESH, 0.0, 1.0), 2.0)
    key = klass * OFF + torch.clamp(ymin, 0.0, OFF - 1.0)
    perm = torch.argsort(key, stable=True)
    key_s = key[perm]
    thr = torch.tensor([OFF - 0.5, 2 * OFF - 0.5], dtype=torch.float32,
                       device=dev)
    counts = torch.searchsorted(key_s, thr).to(torch.int32)
    tile_y0 = torch.arange(n_tiles, dtype=torch.float32,
                           device=dev) * ROW_TILE
    lo_pos = torch.searchsorted(
        key_s, torch.clamp(tile_y0 - LONG_THRESH, min=0.0)).to(torch.int32)
    hi_pos = torch.minimum(torch.searchsorted(
        key_s, tile_y0 + ROW_TILE).to(torch.int32), counts[:1])
    coef = torch.cat([edge_coeffs(a, b), edge_coeffs(b, c),
                      edge_coeffs(c, a),
                      tri_valid.to(torch.float32)[None, :]], 0)
    C = torch.cat([coef[:, perm], perm.to(torch.float32)[None, :]], 0)
    return C, lo_pos, hi_pos, counts


def rasterize_tri_ids(vtx_pos, tris, tri_valid, *, height: int, width: int):
    """Triangle-id buffer [H, W] int32, -1 where uncovered (the v4
    arithmetic: x*a + (y*b + c), the min original id over the triangles
    whose three edge functions are >= -1e-3)."""
    dev = vtx_pos.device
    T = tris.shape[0]
    C, lo_pos, hi_pos, counts = _setup(vtx_pos, tris, tri_valid, height)
    n_tiles = height // ROW_TILE
    n_short, n_live = counts.tolist()
    n_s = torch.clamp(hi_pos - lo_pos, min=0).long()
    cs = int(n_s.max())
    if cs + n_live - n_short <= 0:
        return torch.full((height, width), -1, dtype=torch.int32,
                          device=dev)
    k = torch.arange(cs, device=dev)[None, :]
    idx = torch.clamp(lo_pos[:, None].long() + k, 0, T - 1)
    G = C[:, idx].permute(1, 0, 2).clone()             # [n_tiles, 11, cs]
    G[:, 9] = G[:, 9] * (k < n_s[:, None]).to(torch.float32)
    L = C[:, n_short:n_live]                           # [11, n_long]
    S = torch.cat([G, L[None].expand(n_tiles, *L.shape)], 2)
    big = float(T + 1)
    ux = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    rows = []
    for r in range(ROW_TILE):
        uy = (torch.arange(n_tiles, device=dev) * ROW_TILE + r).to(
            torch.float32)[:, None, None]
        inside = None
        for e in range(3):
            a = S[:, 3 * e:3 * e + 1, :]
            b = S[:, 3 * e + 1:3 * e + 2, :]
            c = S[:, 3 * e + 2:3 * e + 3, :]
            cond = ux * a + (uy * b + c) >= EPS
            inside = cond if inside is None else (inside & cond)
        inside = inside & (S[:, 9:10, :] > 0.0)
        rows.append(torch.where(inside, S[:, 10:11, :], big).min(-1).values)
    out = torch.stack(rows, 1).reshape(height, width).to(torch.int32)
    return torch.where(out > T, -1, out)


def rasterize_ids(vtx_pos, vtx_x, tris, tri_valid, *, height: int,
                  width: int):
    """(triangle-id buffer [H, W], affine idepth planes [T, 3])."""
    planes, pvalid = triangle_planes(vtx_pos, vtx_x, tris, tri_valid)
    return rasterize_tri_ids(vtx_pos, tris, pvalid, height=height,
                             width=width), planes


def idepth_from_ids(idmap, planes):
    """Dense idepth map [H, W] (NaN outside the mesh)."""
    height, width = idmap.shape
    covered = idmap >= 0
    g = planes[idmap.clamp(min=0).long()]
    u = torch.arange(width, dtype=torch.float32,
                     device=idmap.device)[None, :].expand(height, width)
    v = torch.arange(height, dtype=torch.float32,
                     device=idmap.device)[:, None].expand(height, width)
    idepth = g[..., 0] + g[..., 1] * u + g[..., 2] * v
    return torch.where(covered, idepth, torch.full_like(idepth, float("nan")))


def sample_idepth_at(idmap, planes, uv):
    """(xi [...], ok [...]): the plane of the nearest pixel's triangle,
    evaluated at uv [..., 2]."""
    height, width = idmap.shape
    ui = torch.round(uv[..., 0]).to(torch.int32).clamp(0, width - 1).long()
    vi = torch.round(uv[..., 1]).to(torch.int32).clamp(0, height - 1).long()
    ids = idmap[vi, ui]
    ok = ids >= 0
    g = planes[ids.clamp(min=0).long()]
    xi = g[..., 0] + g[..., 1] * uv[..., 0] + g[..., 2] * uv[..., 1]
    return torch.where(ok, xi, torch.full_like(xi, float("nan"))), ok
