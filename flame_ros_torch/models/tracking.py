"""Direct image-alignment pose tracking (the visual odometry front end).

Counterpart of `flame_ros_tpu/models/tracking.py`: coarse-to-fine
Gauss-Newton photometric alignment of the current frame against a
reference keyframe with dense inverse depth (the LSD-SLAM-style direct
formulation), and the keyframe-ring re-search that recovers a lost track.

    min_xi  sum_p w_p * ( I_cur( pi( T(xi) * pi^-1(p, d_ref(p)) ) )
                          - I_ref(p) )^2

with Huber weights, analytic Jacobians through the warp, and a fixed
number of iterations per pyramid level (no early exit, as in the JAX
package). Both functions are plain tensor code on the device of their
inputs. They read nothing back to the host: a call is a fixed sequence of
launches (the solves use `solve_ex` without its error check, so a
singular system gives non-finite values, as `jnp.linalg.solve` does,
instead of a host sync). The JAX package's HIGHEST-precision matmuls are
f32 matmuls here (the package turns TF32 off).

Point selection ranks by a stable descending sort, which keeps the lower
index first among equal scores as `jax.lax.top_k` does (`torch.topk`
promises no tie order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import (SE3, quat_conj, quat_mul,
                                          quat_rotate)
from flame_ros_torch.ops.pyramid import (bilinear_pyramid,
                                         bilinear_pyramid_batched)


class TrackResult(NamedTuple):
    q: torch.Tensor           # [4] refined pose T_ref_cur rotation
    t: torch.Tensor           # [3]
    final_cost: torch.Tensor  # scalar mean Huber cost
    n_inliers: torch.Tensor   # scalar
    gain: torch.Tensor        # scalar affine exposure gain (cur vs ref)
    offset: torch.Tensor      # scalar affine exposure offset
    # Points that were observable at all (textured in ref, in view, in
    # front): the denominator the failure gate judges n_inliers against.
    # A near-zero n_valid with cost ~0 is the degenerate failure
    # signature (a textureless reference), not a good track.
    n_valid: torch.Tensor     # scalar

    def to_host(self) -> "TrackResult":
        """The result on the host, read in one device-to-host copy."""
        packed = torch.cat([
            self.q.reshape(4), self.t.reshape(3),
            torch.stack([self.final_cost, self.n_inliers.to(torch.float32),
                         self.gain, self.offset,
                         self.n_valid.to(torch.float32)])]).cpu()
        return TrackResult(q=packed[:4], t=packed[4:7],
                           final_cost=packed[7],
                           n_inliers=packed[8].to(torch.int32),
                           gain=packed[9], offset=packed[10],
                           n_valid=packed[11].to(torch.int32))


def _se3_exp_qt(tau):
    T = SE3.exp(tau)
    return T.q, T.t


def _top_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, the lower
    index first among equal scores (jax.lax.top_k's order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def _project(cam: Pinhole, Xc, zs):
    return torch.stack([cam.fx * Xc[..., 0] / zs + cam.cx,
                        cam.fy * Xc[..., 1] / zs + cam.cy], -1)


def _select_ref_points(ref_pyr, ref_idepth, cam: Pinhole, num_points: int,
                       min_grad: float):
    """Pick `num_points` trackable reference points: grid-strided
    candidates scored by central-difference gradient magnitude, gated on
    a finite positive inverse depth. Returns (uv [P,2], xi [P],
    valid [P], iref [P], X_ref [P,3])."""
    H, W = cam.height, cam.width
    dev = ref_pyr.device
    idx = (torch.arange(num_points * 4, dtype=torch.int32, device=dev)
           * 97) % (H * W)                          # strided coverage
    py = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    px = (idx % W).to(torch.float32)
    uv = torch.stack([px, py], -1)
    lvl0 = torch.zeros(num_points * 4, dtype=torch.int32, device=dev)
    # The four neighbours in one gather: +x, -x, +y, -y.
    e = torch.eye(2, dtype=torch.float32, device=dev)
    offs = torch.stack([e[0], -e[0], e[1], -e[1]])[:, None, :]
    nb, _ = bilinear_pyramid(ref_pyr, uv[None] + offs, lvl0)
    grad = torch.abs(nb[0] - nb[1]) * 0.5 + torch.abs(nb[2] - nb[3]) * 0.5
    xi_ref = ref_idepth[py.to(torch.int64), px.to(torch.int64)]
    ok = torch.isfinite(xi_ref) & (xi_ref > 1e-3) & (grad >= min_grad)
    score = torch.where(ok, grad, torch.full_like(grad, -1.0))
    top = _top_stable(score, num_points)
    uv = uv[top]
    xi = torch.nan_to_num(xi_ref, nan=1.0)[top]
    valid0 = ok[top]
    iref0, _ = bilinear_pyramid(
        ref_pyr, uv, torch.zeros(num_points, dtype=torch.int32, device=dev))
    X_ref = cam.backproject(uv, torch.clamp(xi, min=1e-3))
    return uv, xi, valid0, iref0, X_ref


def track_frame(ref_pyr, ref_idepth, cur_pyr, init_q, init_t, *,
                cam: Pinhole, num_points: int = 2048,
                iters_per_level: int = 10, num_levels: int = 3,
                huber_delta: float = 8.0, min_grad: float = 4.0,
                estimate_affine: bool = True) -> TrackResult:
    """Estimate T_rc, the transform taking ref-camera coordinates to
    cur-camera coordinates.

    ref_pyr/cur_pyr: [L, H, W] pyramids; ref_idepth: [H, W] (NaN
    invalid); init_q/init_t: initial guess for T_rc (identity or a motion
    model; host or device tensors). Runs on ref_pyr's device and returns
    a TrackResult of tensors there.

    estimate_affine: jointly estimate a per-frame affine exposure model
    (DSO-style): r = I_cur(warp(p)) - (gain * I_ref(p) + offset). On
    constant-exposure input the solve returns gain=1, offset=0.
    """
    H, W = cam.height, cam.width
    dev = ref_pyr.device
    f32 = torch.float32
    q = torch.as_tensor(init_q, dtype=f32).to(dev, non_blocking=True)
    t = torch.as_tensor(init_t, dtype=f32).to(dev, non_blocking=True)

    uv, xi, valid0, iref0, X_ref = _select_ref_points(
        ref_pyr, ref_idepth, cam, num_points, min_grad)
    # fx / z as one division (a Python number over a tensor would be a
    # reciprocal and a product in torch).
    fx = torch.full((), cam.fx, dtype=f32, device=dev)
    fy = torch.full((), cam.fy, dtype=f32, device=dev)
    e = torch.eye(2, dtype=f32, device=dev)
    # Sample offsets of the warped point and its central differences:
    # centre, +u, -u, +v, -v (one gather per iteration).
    unit_offs = torch.stack([torch.zeros_like(e[0]), e[0], -e[0], e[1],
                             -e[1]])[:, None, :]
    if estimate_affine:
        reg = torch.diag(torch.cat([torch.full((6,), 1e-4, dtype=f32,
                                               device=dev),
                                    torch.full((2,), 1e-2, dtype=f32,
                                               device=dev)]))
        ones = torch.ones_like(iref0)
        # Pose-independent exposure seed from global image statistics
        # (coarsest level, padding excluded): g0 = std ratio, o0 = mean
        # residual. Constant exposure -> (1, 0).
        lc = num_levels - 1
        npx = (H >> lc) * (W >> lc)
        a = ref_pyr[lc].reshape(-1)[:npx]
        c = cur_pyr[lc].reshape(-1)[:npx]
        g = torch.clamp(torch.std(c, correction=0)
                        / torch.clamp(torch.std(a, correction=0), min=1e-3),
                        0.5, 2.0)
        o = torch.clamp(torch.mean(c) - g * torch.mean(a), -96.0, 96.0)
    else:
        reg = 1e-4 * torch.eye(6, dtype=f32, device=dev)
        g = torch.ones((), dtype=f32, device=dev)
        o = torch.zeros((), dtype=f32, device=dev)

    for level in range(num_levels - 1, -1, -1):
        lvl = torch.full((num_points,), level, dtype=torch.int32, device=dev)
        step = float(2 ** level)
        offs = unit_offs * step
        # Affine columns take part at fine levels only (zeroed when
        # coarse, so the pose step there is the pure 6-DoF solve).
        fine = 1.0 if level < 2 else 0.0
        for _ in range(iters_per_level):
            Xc = quat_rotate(q[None, :], X_ref) + t[None, :]
            z = Xc[..., 2]
            front = z > 1e-3
            zs = torch.where(front, z, torch.ones_like(z))
            uvc = _project(cam, Xc, zs)
            smp, inb5 = bilinear_pyramid(cur_pyr, uvc[None] + offs, lvl)
            icur, inb = smp[0], inb5[0]
            gIu = (smp[1] - smp[2]) / (2 * step)
            gIv = (smp[3] - smp[4]) / (2 * step)

            r = icur - (g * iref0 + o)
            ar = torch.abs(r)
            w_h = torch.where(ar <= huber_delta, torch.ones_like(r),
                              huber_delta / torch.clamp(ar, min=1e-6))
            m = (valid0 & front & inb).to(f32) * w_h

            # d(pixel)/d(Xc) chained with the image gradient; the
            # Jacobian's zero entries contribute nothing.
            gX0 = gIu * (fx / zs)
            gX1 = gIv * (fy / zs)
            gX2 = (gIu * (-cam.fx * Xc[..., 0] / (zs * zs))
                   + gIv * (-cam.fy * Xc[..., 1] / (zs * zs)))
            # d(Xc)/d(twist): [I | -[Xc]x] for tau = (v, omega).
            cols = [gX0, gX1, gX2,
                    -gX1 * Xc[:, 2] + gX2 * Xc[:, 1],
                    gX0 * Xc[:, 2] - gX2 * Xc[:, 0],
                    -gX0 * Xc[:, 1] + gX1 * Xc[:, 0]]
            if estimate_affine:
                # dr/d(gain) = -iref, dr/d(offset) = -1. Column
                # magnitudes span ~1 to ~1e3, so the 8x8 system is
                # Jacobi-normalized before the solve.
                cols += [-fine * iref0, -fine * ones]
            Jx = torch.stack(cols, -1)                      # [P, 6|8]
            Wt = (Jx * m[:, None]).T
            A = Wt @ Jx + reg
            b = Wt @ r
            if estimate_affine:
                s = torch.rsqrt(torch.diagonal(A) + 1e-12)
                An = s[:, None] * A * s[None, :]
                upd = -s * torch.linalg.solve_ex(An, s * b,
                                                 check_errors=False)[0]
                tau = torch.clamp(upd[:6], -0.5, 0.5)
                g = torch.clamp(g + fine * torch.clamp(upd[6], -0.2, 0.2),
                                0.5, 2.0)
                o = torch.clamp(o + fine * torch.clamp(upd[7], -16.0, 16.0),
                                -96.0, 96.0)
            else:
                tau = torch.clamp(
                    -torch.linalg.solve_ex(A, b, check_errors=False)[0],
                    -0.5, 0.5)
            dq, dt = _se3_exp_qt(tau)
            # Left-compose the increment: T <- dT * T.
            q, t = quat_mul(dq, q), quat_rotate(dq, t) + dt

    # Final diagnostics at level 0.
    Xc = quat_rotate(q[None, :], X_ref) + t[None, :]
    z = torch.clamp(Xc[..., 2], min=1e-3)
    icur, inb = bilinear_pyramid(
        cur_pyr, _project(cam, Xc, z),
        torch.zeros(num_points, dtype=torch.int32, device=dev))
    r = torch.abs(icur - (g * iref0 + o))
    m = valid0 & inb & (Xc[..., 2] > 1e-3)
    inl = m & (r < 2 * huber_delta)
    cost = (torch.sum(torch.where(m, torch.clamp(r, max=3 * huber_delta),
                                  torch.zeros_like(r)))
            / torch.clamp(torch.sum(m.to(f32)), min=1.0))
    return TrackResult(q=q, t=t, final_cost=cost,
                       n_inliers=torch.sum(inl.to(torch.int32)),
                       gain=g, offset=o,
                       n_valid=torch.sum(m.to(torch.int32)))


def _twist_grid(step: float, n_steps: int, device) -> torch.Tensor:
    """[6*2*n_steps + 1, 6] candidate twists: identity first, then
    +-{1..n_steps}*step along each axis."""
    steps = torch.arange(1, n_steps + 1, dtype=torch.float32,
                         device=device) * step
    signed = torch.cat([steps, -steps])
    cand = torch.zeros((6 * 2 * n_steps + 1, 6), dtype=torch.float32,
                       device=device)
    for a in range(6):
        cand[1 + a * 2 * n_steps:1 + (a + 1) * 2 * n_steps, a] = signed
    return cand


def ring_relocalize(kf_pyrs, kf_q, kf_t, kf_valid,
                    feat_uv, feat_mu, feat_valid, feat_kfidx,
                    cur_pyr, guess_q, guess_t, *, cam: Pinhole,
                    pts_per_kf: int = 256, level: int = 2,
                    step: float = 0.05, n_steps: int = 3, iters: int = 4):
    """Relocalize the current frame against the keyframe ring.

    Recovery path for a lost tracker: for every keyframe slot j, take up
    to `pts_per_kf` depth-filter features owned by j (uv in j's image,
    posterior inverse depth in j's frame), seed T_jc from the coasted
    world-pose guess (or identity, whichever is cheaper), and run an
    annealed coordinate descent over the twist grid +-{1..n_steps}*step
    per axis at a coarse pyramid level. The K slots are one batch (the
    JAX package's vmap); the caller picks the best (valid, enough points,
    cost-gated) slot.

    Returns (q_jc [K,4], t_jc [K,3], cost [K], n_pts [K]) where T_jc maps
    keyframe-j camera coords to current camera coords; cost = mean
    |residual| at `level` (inf where the candidate loses visibility),
    n_pts = features owned by each slot.
    """
    K = kf_q.shape[0]
    dev = cur_pyr.device
    f32 = torch.float32
    P = pts_per_kf
    guess_q = torch.as_tensor(guess_q, dtype=f32).to(dev, non_blocking=True)
    guess_t = torch.as_tensor(guess_t, dtype=f32).to(dev, non_blocking=True)

    # Per-keyframe point selection: top-P owned live features, index
    # order by a tiny ramp (ties among the unowned: lower index first).
    F = feat_uv.shape[0]
    ramp = torch.arange(F, dtype=f32, device=dev) * (1.0 / (F + 1))
    slots = torch.arange(K, dtype=feat_kfidx.dtype, device=dev)
    owned = feat_valid[None, :] & (feat_kfidx[None, :] == slots[:, None])
    score = torch.where(owned, 1.0 - ramp[None, :],
                        torch.full_like(ramp, -1.0)[None, :])
    top = _top_stable(score, P)                           # [K, P]
    uv_k, d_k = feat_uv[top], feat_mu[top]
    pv = torch.gather(owned, 1, top).to(f32)              # [K, P]
    n_k = torch.sum(owned.to(torch.int32), dim=1)

    cand = _twist_grid(step, n_steps, dev)               # [C, 6]
    kf_flat = kf_pyrs.reshape(K, -1)
    rows = torch.arange(K, device=dev)
    iref, _ = bilinear_pyramid_batched(
        kf_flat, rows, tuple(kf_pyrs.shape[1:]), uv_k,
        torch.full((K, P), level, dtype=torch.int32, device=dev))
    X_j = cam.backproject(uv_k, torch.clamp(d_k, min=1e-3))   # [K, P, 3]
    need = 0.5 * torch.clamp(torch.sum(pv, dim=1), min=1.0)    # [K]
    lvl = torch.full((1,), level, dtype=torch.int32, device=dev)

    def cost_of(q_jc, t_jc, taus):
        """Costs [K, n] of candidate twists taus [K|1, n, 6] left-composed
        onto T_jc [K]."""
        dq, dt = _se3_exp_qt(taus)
        qq = quat_mul(dq, q_jc[:, None, :])
        tt = quat_rotate(dq, t_jc[:, None, :]) + dt
        Xc = quat_rotate(qq[:, :, None, :], X_j[:, None]) + tt[:, :, None, :]
        z = Xc[..., 2]
        front = z > 1e-3
        zs = torch.where(front, z, torch.ones_like(z))
        val, inb = bilinear_pyramid(cur_pyr, _project(cam, Xc, zs), lvl)
        w = (front & inb).to(f32) * pv[:, None, :]
        n = torch.sum(w, dim=-1)
        c = (torch.sum(torch.clamp(torch.abs(val - iref[:, None, :]),
                                   max=24.0) * w, dim=-1)
             / torch.clamp(n, min=1.0))
        # Out-of-view "solutions" zero their residuals: require the
        # candidate to keep most points visible.
        return torch.where(n >= need[:, None], c,
                           torch.full_like(c, float("inf")))

    # Seed T_jc = T_wc_guess^-1 o T_wj, or identity ("back near keyframe
    # j") where that is cheaper.
    qg_inv = quat_conj(guess_q)
    q0 = quat_mul(qg_inv[None, :], kf_q)
    t0 = quat_rotate(qg_inv[None, :], kf_t - guess_t[None, :])
    zero = torch.zeros((1, 1, 6), dtype=f32, device=dev)
    q_id = torch.zeros_like(q0)
    q_id[:, 0] = 1.0
    t_id = torch.zeros_like(t0)
    c_guess = cost_of(q0, t0, zero)[:, 0]
    c_id = cost_of(q_id, t_id, zero)[:, 0]
    use_id = (c_id < c_guess)[:, None]
    q_jc = torch.where(use_id, q_id, q0)
    t_jc = torch.where(use_id, t_id, t0)

    for i in range(iters):
        # Annealed coordinate descent: the grid shrinks 2x per round; the
        # identity candidate keeps the discrete cost non-increasing.
        s = float(2 ** (iters - 1 - i))
        costs = cost_of(q_jc, t_jc, (s * cand)[None])         # [K, C]
        best = s * cand[torch.argmin(costs, dim=1)]            # [K, 6]
        dq, dt = _se3_exp_qt(best)
        q_jc, t_jc = quat_mul(dq, q_jc), quat_rotate(dq, t_jc) + dt

    cost = cost_of(q_jc, t_jc, zero)[:, 0]
    cost = torch.where(kf_valid, cost, torch.full_like(cost, float("inf")))
    return q_jc, t_jc, cost, n_k
