"""Mesh rasterization: triangle-id buffers, affine idepth planes, dense
inverse-depth maps.

Counterpart of `flame_ros_tpu/ops/raster.py`: the per-frame raster
products, and the getters' normals and display filters. The Delaunay
graph's per-vertex smoothed inverse depth defines an affine idepth
function over each triangle, so the dense map is an id-buffer
rasterization followed by one affine evaluation. Invalid pixels are NaN
(reference getDepthConfusionMatrix keys on isnan, utils.cc:326-368).

`rasterize_tri_ids` is the plain formulation (the CPU path and the
oracle). `rasterize_ids(..., use_kernel=True)` dispatches to the
hand-written kernels of `ops/raster_cuda.py`.

The id buffer is one custom operator, `flame_torch::raster_ids`, so that
the engine step can run under `torch.func.vmap` over a stream axis (the
multi-stream runner, `parallel/multi_stream.py`). Its vmap rule runs the
batched v4 kernel (one launch for every image) on CUDA tensors, and on CPU
tensors the unbatched operator's own code once per image (the CPU oracle).
An unbatched call runs the single-image code as before.
"""
from __future__ import annotations

import torch

from flame_ros_torch.ops import raster_cuda

EPS = -1e-3


def triangle_planes(vtx_pos, vtx_x, tris, tri_valid):
    """Affine idepth coefficients per triangle.

    Solves [1 u v] @ g = x for the 3 corners. Returns (g [T, 3] with
    idepth(u, v) = g0 + g1*u + g2*v, valid [T] — degenerate triangles are
    invalidated)."""
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


def rasterize_tri_ids(vtx_pos, tris, tri_valid, *, height: int, width: int,
                      row_tile: int = 8, tri_block: int = 256):
    """Triangle-id buffer [H, W] (int32, -1 where uncovered): the plain
    formulation of raster.py:50-126. For each tile of `row_tile` rows,
    only the triangle blocks whose valid y-interval overlaps the tile are
    tested; the lowest id of a triangle whose three CCW edge functions
    are >= -1e-3 wins. Runs on any device (the block culling reads the
    block bounds on the host)."""
    dev = vtx_pos.device
    T = tris.shape[0]
    B = min(tri_block, T)
    if T % B:
        B = T
    n_blocks = T // B
    t = tris.long()
    a, b, c = vtx_pos[t[:, 0]], vtx_pos[t[:, 1]], vtx_pos[t[:, 2]]
    C = torch.cat([raster_cuda.edge_coeffs(a, b),
                   raster_cuda.edge_coeffs(b, c),
                   raster_cuda.edge_coeffs(c, a)], 0)       # [9, T]
    ys = torch.stack([a[:, 1], b[:, 1], c[:, 1]], -1)
    inf = float("inf")
    blk_ymin = torch.where(tri_valid, ys.min(-1).values, inf).reshape(
        n_blocks, B).min(-1).values.tolist()
    blk_ymax = torch.where(tri_valid, ys.max(-1).values, -inf).reshape(
        n_blocks, B).max(-1).values.tolist()
    n_tiles = height // row_tile
    px_tile = row_tile * width
    ux = torch.arange(width, dtype=torch.float32, device=dev).repeat(
        row_tile)[:, None]
    uy0 = torch.arange(row_tile, dtype=torch.float32,
                       device=dev).repeat_interleave(width)[:, None]
    big = T + 1
    out = torch.full((n_tiles, px_tile), -1, dtype=torch.int32, device=dev)
    for i in range(n_tiles):
        y_lo = float(i * row_tile)
        blocks = [k for k in range(n_blocks)
                  if blk_ymax[k] >= y_lo and blk_ymin[k] < y_lo + row_tile]
        if not blocks:
            continue
        cols = torch.cat([torch.arange(k * B, (k + 1) * B, device=dev)
                          for k in blocks])
        uy = uy0 + y_lo
        Cb = C[:, cols]
        inside = tri_valid[cols][None, :]
        for e in range(3):
            E = (ux * Cb[3 * e:3 * e + 1] + uy * Cb[3 * e + 1:3 * e + 2]) \
                + Cb[3 * e + 2:3 * e + 3]
            inside = inside & (E >= EPS)
        ids = cols.to(torch.int32)[None, :]
        best = torch.where(inside, ids, big).min(-1).values
        out[i] = torch.where(best < big, best, -1)
    return out.reshape(height, width)


def _id_buffer(vtx_pos, tris, tri_valid, height, width, use_kernel,
               kernel):
    """The single-image id buffer of `rasterize_ids`."""
    if use_kernel and kernel == "v4":
        return raster_cuda.rasterize_tri_ids_v4(
            vtx_pos, tris, tri_valid, height=height, width=width)
    if use_kernel:
        return raster_cuda.rasterize_tri_ids_v2(
            vtx_pos, tris, tri_valid, height=height, width=width)
    return rasterize_tri_ids(vtx_pos, tris, tri_valid, height=height,
                             width=width)


@torch.library.custom_op("flame_torch::raster_ids", mutates_args=())
def raster_ids_op(vtx_pos: torch.Tensor, tris: torch.Tensor,
                  tri_valid: torch.Tensor, height: int, width: int,
                  use_kernel: bool, kernel: str) -> torch.Tensor:
    """Triangle-id buffer [H, W] int32 (`rasterize_ids`'s dispatch)."""
    return _id_buffer(vtx_pos, tris, tri_valid, height, width, use_kernel,
                      kernel)


@raster_ids_op.register_fake
def _(vtx_pos, tris, tri_valid, height, width, use_kernel, kernel):
    return vtx_pos.new_empty((height, width), dtype=torch.int32)


def _raster_ids_vmap(info, in_dims, vtx_pos, tris, tri_valid, height,
                     width, use_kernel, kernel):
    """The id buffers of a batch of images [S, H, W]: one launch of the
    batched v4 kernel on the card; on the CPU the single-image code once
    per image. No other kernel has a batched form, so another choice on
    the card raises (never a loop of single launches)."""
    S = info.batch_size
    vtx_pos, tris, tri_valid = (
        x.movedim(d, 0) if d is not None else x.expand(S, *x.shape)
        for x, d in zip((vtx_pos, tris, tri_valid), in_dims[:3]))
    if vtx_pos.device.type == "cpu":
        out = torch.stack([_id_buffer(vtx_pos[s], tris[s], tri_valid[s],
                                      height, width, use_kernel, kernel)
                           for s in range(S)])
    elif use_kernel and kernel == "v4":
        out = raster_cuda.rasterize_tri_ids_v4_batched(
            vtx_pos, tris, tri_valid, height=height, width=width)
    else:
        raise ValueError(
            "a batched raster on the card needs the v4 kernel "
            "(engine.use_pallas_raster=True, pallas_raster_kernel='v4')")
    return out, 0


torch.library.register_vmap("flame_torch::raster_ids", _raster_ids_vmap)


def rasterize_ids(vtx_pos, vtx_x, tris, tri_valid, *, height: int,
                  width: int, use_kernel: bool = False,
                  kernel: str = "v2"):
    """Triangle-id buffer [H, W] + affine idepth planes [T, 3] — the
    per-frame raster products; the dense idepth evaluation is deferred
    (idepth_from_ids / sample_idepth_at).

    use_kernel=True runs the hand-written raster: "v4", any other name
    v2, as the JAX package's dispatch does (its v3 is reached only by
    direct calls): the CUDA kernels on CUDA tensors, their plain versions
    on CPU tensors. Under torch.func.vmap the id buffer comes from the
    operator's vmap rule (`_raster_ids_vmap`)."""
    planes, pvalid = triangle_planes(vtx_pos, vtx_x, tris, tri_valid)
    idmap = raster_ids_op(vtx_pos, tris, pvalid, height, width,
                          bool(use_kernel), kernel)
    return idmap, planes


def rasterize_idepth(vtx_pos, vtx_x, tris, tri_valid, *, height: int,
                     width: int, use_kernel: bool = False,
                     kernel: str = "v2"):
    """Dense inverse-depth map [H, W] (NaN outside the mesh) + id buffer."""
    idmap, planes = rasterize_ids(
        vtx_pos, vtx_x, tris, tri_valid, height=height, width=width,
        use_kernel=use_kernel, kernel=kernel)
    return idepth_from_ids(idmap, planes), idmap


def idepth_from_ids(idmap, planes):
    """Dense idepth map [H, W] (NaN outside) from a triangle-id buffer +
    per-triangle affine planes."""
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
    """Sparse idepth at pixel coords uv [..., 2] from (idmap, planes):
    nearest-pixel triangle id, affine plane evaluated AT uv. Returns
    (xi [...], ok [...])."""
    height, width = idmap.shape
    ui = torch.round(uv[..., 0]).to(torch.int32).clamp(0, width - 1).long()
    vi = torch.round(uv[..., 1]).to(torch.int32).clamp(0, height - 1).long()
    ids = idmap[vi, ui]
    ok = ids >= 0
    g = planes[ids.clamp(min=0).long()]
    xi = g[..., 0] + g[..., 1] * uv[..., 0] + g[..., 2] * uv[..., 1]
    return torch.where(ok, xi, torch.full_like(xi, float("nan"))), ok


def _face_normals(g, cam):
    """Unit normals of the planes idepth(u, v) = g0 + g1 u + g2 v, [..., 3]
    (a plane n.X = d has n ∝ (fx g1, fy g2, g0 + g1 cx + g2 cy))."""
    n = torch.stack([cam.fx * g[..., 1], cam.fy * g[..., 2],
                     g[..., 0] + g[..., 1] * cam.cx + g[..., 2] * cam.cy], -1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)


def rasterize_normal_map(vtx_pos, vtx_x, tris, tri_valid, cam):
    """Dense per-pixel surface normals [H, W, 3] from the mesh's face
    planes, oriented toward the camera; NaN outside the mesh (the
    reference's debug/normals image). Uses the plain raster, as the JAX
    package's getter uses its XLA raster."""
    planes, pvalid = triangle_planes(vtx_pos, vtx_x, tris, tri_valid)
    idmap = rasterize_tri_ids(vtx_pos, tris, pvalid, height=cam.height,
                              width=cam.width)
    n = _face_normals(planes[idmap.clamp(min=0).long()], cam)
    dev = vtx_pos.device
    u = torch.arange(cam.width, dtype=torch.float32,
                     device=dev)[None, :].expand(cam.height, cam.width)
    v = torch.arange(cam.height, dtype=torch.float32,
                     device=dev)[:, None].expand(cam.height, cam.width)
    ray = cam.ray(torch.stack([u, v], -1))
    n = torch.where(((n * ray).sum(-1) > 0)[..., None], -n, n)
    return torch.where((idmap >= 0)[..., None], n,
                       torch.full_like(n, float("nan")))


def vertex_normals(vtx_pos, x, w, cam):
    """Per-vertex unit surface normals [N, 3] from the regularizer's plane
    gradients (reference getInverseDepthMesh normals): with idepth
    xi = x + w.(p - p_i), n ∝ (fx w1, fy w2, x - w.(p - principal
    point)), flipped so that n . view_ray < 0."""
    n = torch.stack([
        cam.fx * w[:, 0], cam.fy * w[:, 1],
        x - w[:, 0] * (vtx_pos[:, 0] - cam.cx)
        - w[:, 1] * (vtx_pos[:, 1] - cam.cy)], -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    flip = (n * cam.ray(vtx_pos)).sum(-1) > 0
    return torch.where(flip[:, None], -n, n)


def mesh_display_filters(vtx_pos, x, w, tris, tri_valid, cam, *,
                         filter_oblique: bool = True,
                         oblique_normal_thresh: float = 1.57,
                         oblique_idepth_diff_factor: float = 0.35,
                         oblique_idepth_diff_abs: float = 0.1,
                         filter_long_edges: bool = True,
                         edge_length_thresh: float = 0.333,
                         filter_by_idepth: bool = True,
                         min_triangle_idepth: float = 0.01):
    """Display-only triangle validity [T] (reference output/* filters:
    oblique faces, long edges, minimum idepth). They change what is
    published, never the graph."""
    t = tris.long()
    a, b, c = (vtx_pos[t[:, k]] for k in range(3))
    xa, xb, xc = (x[t[:, k]] for k in range(3))
    keep = tri_valid
    if filter_long_edges:
        max_len = torch.maximum(torch.maximum(
            torch.linalg.norm(a - b, dim=-1),
            torch.linalg.norm(b - c, dim=-1)),
            torch.linalg.norm(c - a, dim=-1))
        keep = keep & (max_len <= edge_length_thresh * cam.width)
    xi_max = torch.maximum(torch.maximum(xa, xb), xc)
    xi_min = torch.minimum(torch.minimum(xa, xb), xc)
    if filter_by_idepth:
        keep = keep & (xi_min >= min_triangle_idepth)
    if filter_oblique:
        # View-grazing faces: angle between the face normal and the view
        # ray through the centroid, plus the idepth spread over the face.
        g, gok = triangle_planes(vtx_pos, x, tris, tri_valid)
        n = _face_normals(g, cam)
        ray = cam.ray((a + b + c) / 3.0)
        ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                                min=1e-12)
        angle = torch.arccos(torch.clamp(torch.abs((n * ray).sum(-1)),
                                         -1.0, 1.0))
        spread = xi_max - xi_min
        oblique = ((angle > oblique_normal_thresh)
                   | ((spread > oblique_idepth_diff_factor * xi_max)
                      & (spread > oblique_idepth_diff_abs)))
        keep = keep & ~oblique & gok
    return keep


def coverage(idepth_map):
    """Fraction of pixels with a valid (non-NaN) idepth (reference
    FlameStats.coverage)."""
    return torch.mean(torch.isfinite(idepth_map).to(torch.float32))
