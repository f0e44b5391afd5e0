"""NLTGV2-L1 variational smoothing over the Delaunay graph.

A frozen copy of the port's module, whose counterpart is `flame_ros_tpu/ops/nltgv2.py` (see its docstring for the
model): per-vertex inverse depth x_i and plane gradient w_i, per-edge
dual q_ij in R^3, minimized by diagonally preconditioned Chambolle–Pock
primal-dual sweeps with an L1 data term.

The adjoint K^T runs as a gather over per-vertex incidence lists
(`build_incidence`, host numpy): exact f32 and deterministic — no
scatter-adds. `engine.nltgv2_adjoint="matmul"` runs it instead as one
product per sweep with the [V, 2E] 0/1 incidence matrix of `build_gcat`
over the per-edge tail/head contributions rounded to bf16, as the JAX
package's matrix-unit formulation does (a ~1e-3 perturbation of the
converged primal). torch's bf16 product would round its output to bf16,
where JAX accumulates and returns f32: here the bf16-rounded
contributions are multiplied as f32 (0/1 and bf16 values are exact in
f32, and TF32 is off), which is JAX's product up to the order of the f32
sums.

`pd_iterate` with `gate_tol > 0` stays free of host syncs: it always runs
`num_iters` sweeps and freezes the iterate with a device flag once the
sweep's max primal change falls below `gate_tol` — the same result as the
JAX package's early-exit while loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GraphState(NamedTuple):
    """Primal/dual variables. Vertex arrays [V]-shaped, edge arrays [E]."""
    x: torch.Tensor        # [V] smoothed inverse depth
    w: torch.Tensor        # [V, 2] plane gradients
    q: torch.Tensor        # [E, 3] duals
    x_bar: torch.Tensor    # [V] extragradient iterate
    w_bar: torch.Tensor    # [V, 2]


class GraphTopology(NamedTuple):
    """Static-shape graph: padded edge list + per-edge geometry, and the
    vertex -> edge incidence lists (D incident edge ids per vertex with
    +1 tail / -1 head / 0 padding signs)."""
    edges: torch.Tensor       # [E, 2] int (i, j); padding rows point at 0
    edge_valid: torch.Tensor  # [E] bool
    dp: torch.Tensor          # [E, 2] p_i - p_j (pixels)
    alpha: torch.Tensor       # [E] first-order weight (0 on padding)
    beta: torch.Tensor        # [E] second-order weight
    inc_edges: Optional[torch.Tensor] = None  # [V, D] int
    inc_sign: Optional[torch.Tensor] = None   # [V, D] float32


def build_incidence(edges: np.ndarray, edge_valid: np.ndarray,
                    num_vertices: int, max_degree: int = 16):
    """Host-side incidence lists (numpy; built at triangulation rate).

    Returns (inc_edges [V, D], inc_sign [V, D], keep_edge [E]): edges
    beyond a vertex's degree budget are reported in keep_edge=False so the
    caller can invalidate them — K and K^T must see the same edge set."""
    E = len(edges)
    inc_e = np.zeros((num_vertices, max_degree), np.int32)
    inc_s = np.zeros((num_vertices, max_degree), np.float32)
    deg = np.zeros(num_vertices, np.int32)
    keep = np.asarray(edge_valid, bool).copy()
    for e in range(E):
        if not keep[e]:
            continue
        i, j = int(edges[e, 0]), int(edges[e, 1])
        if deg[i] >= max_degree or deg[j] >= max_degree:
            keep[e] = False
            continue
        inc_e[i, deg[i]] = e
        inc_s[i, deg[i]] = 1.0
        deg[i] += 1
        inc_e[j, deg[j]] = e
        inc_s[j, deg[j]] = -1.0
        deg[j] += 1
    return inc_e, inc_s, keep


def build_topology(edges, edge_valid, vtx_pos, inc_edges=None,
                   inc_sign=None):
    """Per-edge geometry/weights from vertex positions (alpha = beta =
    1/max(|p_i - p_j|, 1) on valid edges, 0 on padding)."""
    e = edges.long()
    dp = vtx_pos[e[:, 0]] - vtx_pos[e[:, 1]]
    dist = torch.linalg.vector_norm(dp, dim=-1)
    inv = torch.where(edge_valid, 1.0 / torch.clamp(dist, min=1.0),
                      torch.zeros_like(dist))
    return GraphTopology(edges=edges, edge_valid=edge_valid, dp=dp,
                         alpha=inv, beta=inv, inc_edges=inc_edges,
                         inc_sign=inc_sign)


def build_gcat(edges, edge_valid, num_vertices: int):
    """The incidence matrix of the matmul adjoint: [V, 2E] f32 with
    G[v, e] = 1 where v is edge e's tail and G[v, E + e] = 1 where v is
    its head (invalid edges all 0). Built by comparison, out of place, so
    that it runs under torch.func.vmap; the entries equal the JAX
    package's bf16 matrix exactly."""
    v = torch.arange(num_vertices, device=edges.device)[:, None]
    ev = edge_valid[None, :]
    tail = (edges[:, 0][None, :] == v) & ev
    head = (edges[:, 1][None, :] == v) & ev
    return torch.cat([tail, head], 1).to(torch.float32)


def _K_apply(top: GraphTopology, x, w):
    """Edge operator K(x, w) -> [E, 3]."""
    i, j = top.edges[:, 0].long(), top.edges[:, 1].long()
    k1 = top.alpha * (x[i] - x[j]
                      - w[i, 0] * top.dp[:, 0] - w[i, 1] * top.dp[:, 1])
    k2 = top.beta * (w[i, 0] - w[j, 0])
    k3 = top.beta * (w[i, 1] - w[j, 1])
    return torch.stack([k1, k2, k3], dim=-1)


def _precond_steps(top: GraphTopology):
    """Pock-Chambolle diagonal preconditioners (a=1):
    sigma_row = 1/sum|K_row|, tau_col = 1/sum|K_col| (column sums by
    gathers over the incidence lists)."""
    absa = torch.abs(top.alpha)
    absb = torch.abs(top.beta)
    adp1 = torch.abs(top.alpha * top.dp[:, 0])
    adp2 = torch.abs(top.alpha * top.dp[:, 1])
    row1 = absa + absa + adp1 + adp2
    row2 = absb + absb
    sigma = 1.0 / torch.clamp(torch.stack([row1, row2, row2], -1), min=1e-6)
    e = top.inc_edges.long()
    s = top.inc_sign
    live = (s != 0).to(torch.float32)
    tail = (s > 0).to(torch.float32)
    col_x = torch.sum(live * absa[e], -1)
    col_w1 = torch.sum(live * (tail * (adp1[e] + absb[e])
                               + (1 - tail) * absb[e]), -1)
    col_w2 = torch.sum(live * (tail * (adp2[e] + absb[e])
                               + (1 - tail) * absb[e]), -1)
    tau_x = 1.0 / torch.clamp(col_x, min=1e-6)
    tau_w = 1.0 / torch.clamp(torch.stack([col_w1, col_w2], -1), min=1e-6)
    return sigma, tau_x, tau_w


class _SweepConsts(NamedTuple):
    """Loop-invariant operands of one primal-dual sweep (`_sweep`)."""
    i: torch.Tensor          # [E] tail vertex of each edge (gather index)
    j: torch.Tensor          # [E] head vertex
    ev: torch.Tensor         # [E, 1] edge mask
    e: torch.Tensor          # [V, D] incident edge ids
    sigma: torch.Tensor      # [E, 3] dual steps
    tau_xw: torch.Tensor     # [V, 3] primal steps (x, w1, w2)
    thr: torch.Tensor        # [V] L1 prox threshold tau_x * lam
    vm3: torch.Tensor        # [V, 1] vertex mask
    live_sgn: torch.Tensor   # [V, D] incidence sign on live lanes
    tail: torch.Tensor       # [V, D] 1 where the vertex is the tail
    head: torch.Tensor       # [V, D, 1] 1 where the vertex is the head
    dp_inc: torch.Tensor     # [V, D, 2] dp of each incident edge
    edge_k1w: torch.Tensor   # [E, 3] (alpha, alpha * dp)
    beta: torch.Tensor       # [E]
    dp: torch.Tensor         # [E, 2] p_i - p_j (the matmul adjoint's)
    z: torch.Tensor          # [V] data anchors


def _sweep_consts(top: GraphTopology, z, lam, vtx_valid, dt) -> _SweepConsts:
    """The sweep's loop-invariant operands from a topology whose
    incidence lists cover the vertices being updated (all of them, or a
    part's owned vertices in `parallel/spatial_pd.py`)."""
    if top.inc_edges is None:
        raise ValueError("pd_iterate needs the incidence lists "
                         "(GraphTopology.inc_edges / inc_sign)")
    sigma, tau_x, tau_w = _precond_steps(top)
    e = top.inc_edges.long()
    sgn = top.inc_sign
    live = (sgn != 0).to(dt)
    tail = (sgn > 0).to(dt)
    return _SweepConsts(
        i=top.edges[:, 0].long(), j=top.edges[:, 1].long(),
        ev=top.edge_valid[:, None].to(dt), e=e, sigma=sigma,
        tau_xw=torch.cat([tau_x[:, None], tau_w], -1), thr=tau_x * lam,
        vm3=vtx_valid.to(dt)[:, None], live_sgn=live * sgn, tail=tail,
        head=(live - tail)[..., None], dp_inc=top.dp[e] * live[..., None],
        edge_k1w=torch.cat([top.alpha[:, None],
                            top.alpha[:, None] * top.dp], -1),
        beta=top.beta, dp=top.dp, z=z)


def _rows(x, idx):
    """x[idx] along x's row axis: x [..., R, C], idx [..., *I] with x's
    leading dimensions; returns [..., *I, C]. One gather, so the halves
    of a sweep below take stream-batched operands directly (the
    feature-axis layout calls them without vmap)."""
    lead = idx.shape[:x.dim() - 2]
    flat = idx.reshape(*lead, -1)
    rows = torch.gather(x, -2, flat[..., None].expand(*flat.shape,
                                                      x.shape[-1]))
    return rows.reshape(*idx.shape, x.shape[-1])


def _sweep_dual(c: _SweepConsts, xwb_src, q):
    """The edge half of a sweep: dual ascent from the extragradient
    iterate `xwb_src` (the rows `c.i`/`c.j` index), the projection, and
    the per-edge adjoint contributions Pe = (alpha q1, beta q2, beta q3).
    Returns (q, Pe), both [..., E, 3]."""
    pi = _rows(xwb_src, c.i)
    pj = _rows(xwb_src, c.j)
    k1 = (c.edge_k1w[..., 0] * (pi[..., 0] - pj[..., 0])
          - c.edge_k1w[..., 1] * pi[..., 1] - c.edge_k1w[..., 2] * pi[..., 2])
    kw = c.beta[..., None] * (pi[..., 1:] - pj[..., 1:])
    Kx = torch.cat([k1[..., None], kw], -1)
    q = torch.clamp(q + c.sigma * Kx, -1.0, 1.0) * c.ev
    Pe = torch.cat([(c.edge_k1w[..., 0] * q[..., 0])[..., None],
                    c.beta[..., None] * q[..., 1:]], -1)
    return q, Pe


def _adjoint(c: _SweepConsts, Pe, gcat=None):
    """K^T q [..., V, 3] of the updated vertices from the contributions
    Pe of every edge their incidence lists (or gcat's columns) name: one
    packed vertex gather, or with gcat ([..., V, 2E], `build_gcat`) one
    product over the tail/head contributions rounded to bf16."""
    if gcat is not None:
        a_q1 = Pe[..., 0:1]
        bq = Pe[..., 1:]
        t_tail = torch.cat([a_q1, -a_q1 * c.dp + bq], -1)
        t_head = torch.cat([-a_q1, -bq], -1)
        tcat = torch.cat([t_tail, t_head], -2)           # [..., 2E, 3]
        return gcat @ tcat.to(torch.bfloat16).to(torch.float32)
    Pv = _rows(Pe, c.e)                           # [..., V, D, 3]
    gx = torch.sum(c.live_sgn * Pv[..., 0], -1)
    gw = torch.sum(c.tail[..., None] * (-Pv[..., 0:1] * c.dp_inc
                                        + Pv[..., 1:])
                   - c.head * Pv[..., 1:], dim=-2)
    return torch.cat([gx[..., None], gw], -1)


def _sweep_primal(c: _SweepConsts, theta: float, xw, g):
    """The vertex half of a sweep: primal descent by the adjoint g, the
    L1 prox toward z, frozen vertices kept, and the extragradient step.
    Returns (xw, xwb)."""
    xw_desc = xw - c.tau_xw * g
    r = xw_desc[..., 0] - c.z
    x_new = c.z + torch.sign(r) * torch.clamp(torch.abs(r) - c.thr, min=0.0)
    xw_new = torch.cat([x_new[..., None], xw_desc[..., 1:]], -1)
    xw_new = c.vm3 * xw_new + (1 - c.vm3) * xw
    xwb = xw_new + theta * (xw_new - xw)
    return xw_new, xwb


def _sweep(c: _SweepConsts, theta: float, xw, xwb_src, q, gcat=None):
    """One preconditioned primal-dual sweep (packed incidence-gather
    formulation of nltgv2.py:252-341): `_sweep_dual`, `_adjoint`,
    `_sweep_primal`. xw [V, 3] packed (x, w1, w2) of the updated
    vertices; xwb_src the extragradient iterate the edges gather from
    (xwb itself, or a part's owned vertices followed by its halo); q
    [E, 3]; gcat the matmul adjoint's incidence matrix or None. Returns
    (xw, xwb, q)."""
    q, Pe = _sweep_dual(c, xwb_src, q)
    xw_new, xwb = _sweep_primal(c, theta, xw, _adjoint(c, Pe, gcat))
    return xw_new, xwb, q


def pd_iterate(state: GraphState, top: GraphTopology, z, lam, vtx_valid,
               gcat=None, *, num_iters: int = 10, theta: float = 1.0,
               gate_tol: float = 0.0):
    """Run up to `num_iters` primal-dual sweeps (`_sweep`).

    Steps are the diagonal preconditioners of `_precond_steps` (the
    engine's only mode; the JAX package's fixed step_x/step_q mode is not
    ported). z: [V] data anchors; lam: [V] per-vertex data weights;
    vtx_valid: [V] bool — frozen vertices pass through unchanged.
    gcat: None (the incidence gather) or `build_gcat`'s [V, 2E] matrix
    (the matmul adjoint). gate_tol > 0 stops
    updating once a sweep's max |x change| falls below it (no host sync:
    the remaining sweeps run and are discarded by a device flag)."""
    dt = state.x.dtype
    c = _sweep_consts(top, z, lam, vtx_valid, dt)
    xw = torch.cat([state.x[:, None], state.w], -1)
    xwb = torch.cat([state.x_bar[:, None], state.w_bar], -1)
    q = state.q
    if gate_tol > 0.0:
        delta = torch.full((), float("inf"), dtype=dt,
                           device=state.x.device)
        for _ in range(num_iters):
            active = delta > gate_tol
            xw_n, xwb_n, q_n = _sweep(c, theta, xw, xwb, q, gcat)
            d_n = torch.max(torch.abs(xw_n[:, 0] - xw[:, 0]))
            xw = torch.where(active, xw_n, xw)
            xwb = torch.where(active, xwb_n, xwb)
            q = torch.where(active, q_n, q)
            delta = torch.where(active, d_n, delta)
    else:
        for _ in range(num_iters):
            xw, xwb, q = _sweep(c, theta, xw, xwb, q, gcat)
    return GraphState(x=xw[:, 0], w=xw[:, 1:], q=q, x_bar=xwb[:, 0],
                      w_bar=xwb[:, 1:])


def nltgv2_costs(state: GraphState, top: GraphTopology, z, lam, vtx_valid):
    """Smoothness/data costs for telemetry (reference FlameStats fields
    nltgv2_total/avg_smoothness_cost, nltgv2_total/avg_data_cost)."""
    K = _K_apply(top, state.x, state.w)
    smooth = torch.sum(torch.abs(K) * top.edge_valid[:, None])
    data = torch.sum(torch.abs(state.x - z) * lam * vtx_valid)
    n = torch.clamp(torch.sum(vtx_valid.to(torch.float32)), min=1.0)
    return {
        "nltgv2_total_smoothness_cost": smooth,
        "nltgv2_avg_smoothness_cost": smooth / n,
        "nltgv2_total_data_cost": data,
        "nltgv2_avg_data_cost": data / n,
    }


def data_weights(var, valid, *, data_factor: float, adaptive: bool,
                 rescale: bool):
    """Per-vertex lambda_i (adaptive -> weight by inverse posterior
    variance; rescale -> normalize weights to mean 1 over valid
    vertices)."""
    one = torch.ones_like(var)
    zero = torch.zeros_like(var)
    base = torch.where(valid, one, zero)
    if adaptive:
        base = torch.where(valid, 1.0 / torch.clamp(var, min=1e-4), zero)
    if rescale:
        mean = torch.sum(base) / torch.clamp(
            torch.sum(valid.to(torch.float32)), min=1.0)
        base = base / torch.clamp(mean, min=1e-6)
    return data_factor * base


def graph_median(x, inc_edges, inc_sign, edges, vtx_valid):
    """Median filter over graph neighborhoods (reference
    do_median_filter): x_i <- median(x_i, neighbors), from the incidence
    lists; dead lanes pad with +inf so the (deg+1)-element median sits at
    sorted index deg//2."""
    e = inc_edges.long()
    other = torch.where(inc_sign > 0, edges[e, 1], edges[e, 0]).long()
    vals = x[other]
    live = inc_sign != 0
    vals = torch.where(live, vals, torch.full_like(vals, float("inf")))
    allv = torch.cat([vals, x[:, None]], dim=1)
    s = torch.sort(allv, dim=1).values
    deg = torch.sum(live.to(torch.int64), dim=1)
    med = torch.take_along_dim(s, (deg // 2)[:, None], dim=1)[:, 0]
    return torch.where(vtx_valid & (deg > 0), med, x)


def graph_lowpass(x, inc_edges, inc_sign, edges, edge_valid, vtx_valid,
                  alpha: float = 0.5):
    """Neighborhood lowpass over the graph (reference do_lowpass_filter):
    x_i <- (1-alpha) x_i + alpha * mean of valid neighbors. Sums gather
    over the incidence lists (deterministic; the JAX package scatter-adds
    over the edge list, which sums the same terms)."""
    e = inc_edges.long()
    other = torch.where(inc_sign > 0, edges[e, 1], edges[e, 0]).long()
    ew = (edge_valid[e] & (inc_sign != 0)).to(x.dtype)
    ssum = torch.sum(ew * x[other], dim=1)
    scnt = torch.sum(ew, dim=1)
    mean = ssum / torch.clamp(scnt, min=1.0)
    has_nb = scnt > 0
    return torch.where(vtx_valid & has_nb, (1 - alpha) * x + alpha * mean, x)
