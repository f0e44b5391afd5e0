"""Windowed pose-graph optimization over keyframe poses.

Counterpart of `flame_ros_tpu/models/pose_graph.py`: relative-pose
constraints (from direct tracking, odometry or loop closures) over the
keyframe window are refined by Gauss-Newton on SE(3) on the device of
the graph's tensors. The Jacobian is forward-mode autodiff of the
boxplus-perturbed residual (`torch.func.jacfwd`, as the JAX package uses
`jax.jacfwd`); the normal system of a <= 16-keyframe window is a small
dense solve (`solve_ex` without its error check: no host sync, and a
singular system gives non-finite values as `jnp.linalg.solve` does).

Residual per constraint (i, j):
    r_ij = log( T_meas^-1 o (T_i^-1 o T_j) )   in R^6
with node 0 gauge-fixed by a large prior.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from flame_ros_torch.geometry.se3 import SE3, quat_conj, quat_mul, quat_rotate


class PoseGraph(NamedTuple):
    q: torch.Tensor          # [K, 4] node rotations (camera-to-world)
    t: torch.Tensor          # [K, 3]
    edges: torch.Tensor      # [M, 2] int64 (i, j)
    meas_q: torch.Tensor     # [M, 4] measured T_ij = T_i^-1 T_j
    meas_t: torch.Tensor     # [M, 3]
    weight: torch.Tensor     # [M] scalar information weight
    edge_valid: torch.Tensor  # [M] bool


def _residuals(taus, graph: PoseGraph):
    """All constraint residuals [M, 6] with nodes perturbed by taus
    [K, 6] (right perturbation T exp(tau))."""
    dT = SE3.exp(taus)
    q = quat_mul(graph.q, dT.q)
    t = quat_rotate(graph.q, dT.t) + graph.t
    i = graph.edges[:, 0]
    j = graph.edges[:, 1]
    # T_i^-1 o T_j
    qi_inv = quat_conj(q[i])
    q_ij = quat_mul(qi_inv, q[j])
    t_ij = quat_rotate(qi_inv, t[j] - t[i])
    # T_meas^-1 o T_ij
    qm_inv = quat_conj(graph.meas_q)
    q_err = quat_mul(qm_inv, q_ij)
    t_err = quat_rotate(qm_inv, t_ij - graph.meas_t)
    r = SE3(q_err, t_err).log()
    w = (graph.weight * graph.edge_valid)[:, None]
    return r * torch.sqrt(torch.clamp(w, min=0.0))


def optimize_pose_graph(graph: PoseGraph, *, num_iters: int = 10,
                        damping: float = 1e-6):
    """Gauss-Newton with node 0 fixed. Returns (q, t, final_cost) on the
    graph's device."""
    K = graph.q.shape[0]
    dev = graph.q.device
    eye = torch.eye(K * 6, dtype=torch.float32, device=dev)
    # Gauge fix: clamp node 0 by a large prior instead of slicing (keeps
    # the system's shape fixed).
    prior = torch.zeros(K * 6, dtype=torch.float32, device=dev)
    prior[:6] = 1e8
    taus0 = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    g = graph
    for _ in range(num_iters):
        r0 = _residuals(taus0, g)
        J = jacfwd(lambda x, g=g: _residuals(x, g))(taus0)   # [M,6,K,6]
        M = r0.shape[0]
        J = J.reshape(M * 6, K * 6)
        r = r0.reshape(M * 6)
        H = J.T @ J + damping * eye
        b = J.T @ r
        H = H + torch.diag(prior)
        tau = -torch.linalg.solve_ex(H, b, check_errors=False)[0]
        tau = torch.clamp(tau.reshape(K, 6), -1.0, 1.0)
        dT = SE3.exp(tau)
        g = g._replace(q=quat_mul(g.q, dT.q),
                       t=quat_rotate(g.q, dT.t) + g.t)
    final = _residuals(taus0, g)
    return g.q, g.t, torch.sum(final * final)


def make_graph(poses: SE3, edges, meas: SE3, weight=None,
               edge_valid=None, device=None) -> PoseGraph:
    """A PoseGraph on `device` (default: the device of poses.q)."""
    dev = poses.q.device if device is None else torch.device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    edges = torch.as_tensor(np.asarray(edges, np.int64)).to(dev)
    M = edges.shape[0]
    return PoseGraph(
        q=f32(poses.q), t=f32(poses.t), edges=edges,
        meas_q=f32(meas.q), meas_t=f32(meas.t),
        weight=(torch.ones(M, dtype=torch.float32, device=dev)
                if weight is None else f32(weight)),
        edge_valid=(torch.ones(M, dtype=torch.bool, device=dev)
                    if edge_valid is None else
                    torch.as_tensor(np.asarray(edge_valid, bool)).to(dev)))
