"""Batched multi-scale epipolar inverse-depth search + Bayesian filtering.

A frozen copy of the port's module, whose counterpart is `flame_ros_tpu/ops/epipolar.py` (see its module docstring
for the method): all N feature slots advance together over an image
pyramid. The epipolar curve is parameterized linearly in inverse depth
(p(xi) = A + xi*B), a pyramid level is picked per feature, NS candidate
inverse depths are scored by SSD along the line, refined by a parabola
fit, gated by the reference's failure taxonomy (msg/FlameStats.msg:13-18)
and fused into each feature's Gaussian posterior.

Both candidate samplings are ported: `mode="line"` (the product default,
one sliding-window sweep along the epipolar curve) and `mode="patch"`
(each candidate patch the exact warp of the reference patch's rays).

The reference gathers in float32 only: the port's bfloat16 gathers are
the benchmark's control, never its reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from flamebench.reference.camera import Pinhole
from flamebench.reference.se3 import quat_conj, quat_mul, quat_rotate
from flamebench.reference.pyramid import (bilinear_pyramid,
                                         bilinear_pyramid_batched)

# Status codes for per-feature update outcome.
STATUS_SKIPPED = 0       # invalid slot or no-parallax frame
STATUS_OK = 1
STATUS_REF_GRAD = 2      # reference patch gradient too low
STATUS_AMBIGUOUS = 3     # second-best match too close (or chi-square reject)
STATUS_MAX_COST = 4      # best cost above threshold
STATUS_OOB = 5           # epipolar segment out of image bounds
STATUS_BOUNDARY = 6      # censored: best match on search-window edge


class FeatureFilterState(NamedTuple):
    """Per-feature posterior + bookkeeping. All [N]-shaped (or [N, k])."""
    uv_ref: torch.Tensor     # [N, 2] pixel in reference keyframe
    kf_idx: torch.Tensor     # [N] int32 keyframe ring slot
    mu: torch.Tensor         # [N] inverse-depth posterior mean (ref frame)
    var: torch.Tensor        # [N] posterior variance
    dropouts: torch.Tensor   # [N] int32 consecutive failed updates
    valid: torch.Tensor      # [N] bool live-slot mask
    frame_id: torch.Tensor   # [N] int32 frame id at creation


class EpipolarResult(NamedTuple):
    state: FeatureFilterState
    status: torch.Tensor       # [N] int32 status codes
    xi_meas: torch.Tensor      # [N] measured inverse depth (where OK)
    uv_match: torch.Tensor     # [N, 2] matched pixel in current image
    counts: dict               # failure-taxonomy counters (device scalars)


def _matT(x, K):
    """x @ K.T for [..., 3] rows and a 3x3 K, as plain f32 products."""
    return torch.stack([x[..., 0] * K[i][0] + x[..., 1] * K[i][1]
                        + x[..., 2] * K[i][2] for i in range(3)], -1)


def relative_poses(kf_q, kf_t, cur_q, cur_t):
    """For each keyframe slot: T_cr = T_cur^-1 ∘ T_kf (ref cam -> cur cam)
    and t_rc (position of cur camera in ref frame). Leading KF axis."""
    cur_qi = quat_conj(cur_q)
    q_cr = quat_mul(cur_qi[None, :], kf_q)
    t_cr = quat_rotate(cur_qi[None, :], kf_t - cur_t[None, :])
    kf_qi = quat_conj(kf_q)
    t_rc = quat_rotate(kf_qi, cur_t[None, :] - kf_t)
    return q_cr, t_cr, t_rc


def unit_z_like(x):
    """(0, 0, 1) in x's dtype and device, made without a host copy (a
    fill, not an item assignment, which copies its value from the
    host)."""
    z = torch.zeros(3, dtype=x.dtype, device=x.device)
    z[2:].fill_(1.0)
    return z


def _gather1(x, idx):
    return torch.take_along_dim(x, idx[:, None], 1)[:, 0]


def epipolar_update(
    state: FeatureFilterState,
    kf_pyrs,            # [K, L, H, W] keyframe pyramids
    kf_q, kf_t,         # [K, 4], [K, 3] keyframe poses (camera-to-world)
    img_pyr,            # [L, H, W] current-frame pyramid
    cur_q, cur_t,       # [4], [3] current pose
    *,
    cam: Pinhole,
    num_samples: int = 32,
    patch_size: int = 5,
    num_levels: int = 3,
    sigma_window: float = 2.0,
    idepth_min: float = 1e-3,
    idepth_max: float = 4.0,
    epipolar_line_var: float = 4.0,
    min_ref_patch_grad: float = 1.0,
    ambiguous_match_ratio: float = 0.85,
    max_cost: float = 800.0,
    max_dropouts: int = 5,
    max_idepth_var: float = 1.0,
    process_noise: float = 1e-4,
    min_baseline: float = 1e-3,
    min_var_ratio: float = 0.25,
    mode: str = "line",
    zero_mean_ssd: bool = False,
) -> EpipolarResult:
    if mode not in ("line", "patch"):
        raise ValueError(f"unknown epipolar mode {mode!r}")
    N = state.mu.shape[0]
    P = patch_size
    half = P // 2
    S = num_samples
    f32 = torch.float32
    dev = state.mu.device
    L, H, W = img_pyr.shape
    kf_idx = state.kf_idx.long()

    # --- per-feature relative geometry --------------------------------
    q_cr_k, t_cr_k, t_rc_k = relative_poses(kf_q, kf_t, cur_q, cur_t)
    q_cr = q_cr_k[kf_idx]
    t_cr = t_cr_k[kf_idx]
    t_rc = t_rc_k[kf_idx]

    ray = cam.ray(state.uv_ref)
    K = cam.K.tolist()
    A = _matT(quat_rotate(q_cr, ray), K)                 # [N, 3]
    B = _matT(t_cr, K)                                   # [N, 3]

    baseline = torch.linalg.vector_norm(t_cr, dim=-1)
    has_parallax = baseline > min_baseline

    # --- search range + pyramid level ---------------------------------
    sigma = torch.sqrt(torch.clamp(state.var, min=1e-12))
    xi_lo = torch.clamp(state.mu - sigma_window * sigma, min=idepth_min)
    xi_hi = torch.clamp(state.mu + sigma_window * sigma, max=idepth_max)
    xi_hi = torch.maximum(xi_hi, xi_lo + 1e-6)

    hom_mu = A + state.mu[:, None] * B
    zmu = torch.clamp(hom_mu[..., 2], min=1e-6)
    dp_mu = (B[:, :2] * zmu[:, None]
             - hom_mu[:, :2] * B[:, 2:3]) / (zmu[:, None] ** 2)
    dpdxi = torch.linalg.vector_norm(dp_mu, dim=-1)

    uv_pred = hom_mu[:, :2] / zmu[:, None]
    visible = ((hom_mu[..., 2] > 1e-6)
               & (uv_pred[:, 0] >= 2) & (uv_pred[:, 0] <= cam.width - 3)
               & (uv_pred[:, 1] >= 2) & (uv_pred[:, 1] <= cam.height - 3))

    arc_px = (xi_hi - xi_lo) * dpdxi
    level = torch.ceil(torch.log2(torch.clamp(arc_px / num_samples,
                                              min=1.0)))
    level = torch.clamp(level, 0, num_levels - 1).to(torch.int32)
    lscale = torch.exp2(level.to(f32))
    max_halfwidth = (0.5 * num_samples * lscale) / torch.clamp(dpdxi,
                                                               min=1e-3)
    center = torch.minimum(torch.maximum(state.mu, xi_lo), xi_hi)
    capped = ((center - xi_lo > max_halfwidth)
              | (xi_hi - center > max_halfwidth))
    xi_lo_2s, xi_hi_2s = xi_lo, xi_hi
    if mode == "line":
        # Samples exactly one level-pixel apart along the line, centered
        # on the posterior; only the +/- sigma_window*sigma band is
        # scored (masked below).
        width = 2.0 * max_halfwidth
        xi_lo = center - 0.5 * width
        xi_hi = xi_lo + torch.clamp(width, min=1e-6)
    else:
        # Patch mode: the band itself, cut to the arc the level covers.
        xi_lo = torch.maximum(xi_lo, center - max_halfwidth)
        xi_hi = torch.minimum(xi_hi, center + max_halfwidth)
        xi_hi = torch.maximum(xi_hi, xi_lo + 1e-6)

    # jnp.linspace(0, 1, S) as XLA computes it: i * (1/(S-1)), last = 1.
    step = float(np.float32(1.0) / np.float32(S - 1))
    alphas = torch.arange(S, dtype=f32, device=dev) * step
    alphas[-1:].fill_(1.0)          # a fill: no copy from the host
    xis = xi_lo[:, None] + (xi_hi - xi_lo)[:, None] * alphas[None, :]

    # --- reference patch ----------------------------------------------
    e_hom = _matT(t_rc, K)
    d_ref = state.uv_ref * e_hom[..., 2:3] - e_hom[..., :2]
    d_ref = d_ref / torch.clamp(
        torch.linalg.vector_norm(d_ref, dim=-1, keepdim=True), min=1e-12)

    offs = torch.arange(P, dtype=f32, device=dev) - half
    dxi_step = (xi_hi - xi_lo) / (S - 1)
    tap_step = lscale[:, None, None] * d_ref[:, None, :]
    ref_uv = state.uv_ref[:, None, :] + offs[None, :, None] * tap_step

    kf_flat = kf_pyrs.reshape(kf_pyrs.shape[0], -1)
    ref_patch, ref_ok = bilinear_pyramid_batched(
        kf_flat, state.kf_idx, (L, H, W), ref_uv, level[:, None])
    ref_grad = torch.abs(torch.diff(ref_patch, dim=-1)).mean(dim=-1)
    ref_grad_ok = (ref_grad >= min_ref_patch_grad) & ref_ok.all(dim=-1)

    if mode == "line":
        # --- sliding line sweep ---------------------------------------
        # One gather of S+P-1 points along the epipolar curve; adjacent
        # candidates share P-1 taps.
        ext = torch.arange(S + P - 1, dtype=f32, device=dev) - half
        xi_ext = xis[:, :1] + ext[None, :] * dxi_step[:, None]
        hom = A[:, None, :] + xi_ext[..., None] * B[:, None, :]
        in_front = hom[..., 2] > 1e-6
        zc = torch.where(in_front, hom[..., 2], torch.ones_like(hom[..., 2]))
        uv_ext = hom[..., :2] / zc[..., None]
        line_vals, line_ok = bilinear_pyramid(img_pyr, uv_ext,
                                              level[:, None])
        lok = line_ok & in_front
        cand_vals = torch.stack([line_vals[:, p:p + S] for p in range(P)],
                                -1)
        allow = ((xis >= idepth_min) & (xis <= idepth_max)
                 & (xis >= (xi_lo_2s - 0.5 * dxi_step)[:, None])
                 & (xis <= (xi_hi_2s + 0.5 * dxi_step)[:, None]))
        cand_ok = torch.stack([lok[:, p:p + S] for p in range(P)],
                              -1).all(-1) & allow
        cand_uv_center = uv_ext[:, half:half + S, :]
    else:
        # --- candidate patches: exact warp of the ref-patch rays ------
        A_taps = _matT(quat_rotate(q_cr[:, None, :], cam.ray(ref_uv)), K)
        hom = (A_taps[:, None, :, :]
               + xis[:, :, None, None] * B[:, None, None, :])  # [N,S,P,3]
        in_front = hom[..., 2] > 1e-6
        zc = torch.where(in_front, hom[..., 2], torch.ones_like(hom[..., 2]))
        cand_uv = hom[..., :2] / zc[..., None]                 # [N,S,P,2]
        cand_vals, cand_ok = bilinear_pyramid(img_pyr, cand_uv,
                                              level[:, None, None])
        cand_ok = (cand_ok & in_front).all(dim=-1)             # [N, S]
        cand_uv_center = cand_uv[:, :, half, :]
        allow = torch.ones_like(cand_ok)

    if zero_mean_ssd:
        ref_patch_c = ref_patch - ref_patch.mean(-1, keepdim=True)
        diff = (cand_vals - cand_vals.mean(-1, keepdim=True)
                - ref_patch_c[:, None, :])
    else:
        diff = cand_vals - ref_patch[:, None, :]
    cost = torch.sum(diff * diff, dim=-1)
    BIG = 1e12
    cost = torch.where(cand_ok, cost, torch.full_like(cost, BIG))

    any_ok = cand_ok.any(dim=-1)
    best = torch.argmin(cost, dim=-1)          # first minimum, as jnp
    best_cost = _gather1(cost, best)

    px_per_step = dxi_step * torch.clamp(dpdxi, min=1e-3)
    s_idx = torch.arange(S, device=dev)[None, :]
    dist_px = torch.abs(s_idx - best[:, None]).to(f32) \
        * px_per_step[:, None]
    nearby = dist_px <= 2.0 * lscale[:, None]
    cost2 = torch.where(nearby, torch.full_like(cost, BIG), cost)
    second_cost = torch.min(cost2, dim=-1).values
    has_second = second_cost < BIG
    ambiguous = has_second & (second_cost * ambiguous_match_ratio
                              < best_cost)

    # --- subpixel refinement (parabola in xi) -------------------------
    bm1 = torch.clamp(best - 1, 0, S - 1)
    bp1 = torch.clamp(best + 1, 0, S - 1)
    cm = _gather1(cost, bm1)
    cp = _gather1(cost, bp1)
    c0 = best_cost
    denom = cm - 2 * c0 + cp
    interior = (best > 0) & (best < S - 1) & (cm < BIG) & (cp < BIG)
    delta = torch.where((denom > 1e-9) & interior,
                        0.5 * (cm - cp) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    xi_hat = _gather1(xis, best) + delta * dxi_step
    xi_hat = torch.clamp(xi_hat, idepth_min, idepth_max)

    uv_match = torch.take_along_dim(
        cand_uv_center, best[:, None, None].expand(N, 1, 2), 1)[:, 0, :]

    # --- observation variance -----------------------------------------
    g_along = torch.abs(torch.diff(cand_vals, dim=-1)).mean(dim=-1)
    g_best = _gather1(g_along, best)
    sigma_px2 = epipolar_line_var / torch.clamp(g_best * g_best,
                                                min=1e-2) + 0.25
    sigma_px2 = sigma_px2 * lscale * lscale
    var_obs = sigma_px2 / torch.clamp(dpdxi * dpdxi, min=1e-8)
    var_obs = torch.clamp(var_obs, min=1e-8)

    # --- gates + taxonomy ---------------------------------------------
    attempted = state.valid & has_parallax & visible
    fail_ref_grad = attempted & ~ref_grad_ok
    searched = attempted & ref_grad_ok
    fail_oob = searched & ~any_ok
    matched = searched & any_ok
    at_boundary = ((best == 0) | (best == S - 1)
                   | ~_gather1(allow, bm1) | ~_gather1(allow, bp1))
    fail_cost = matched & (best_cost > max_cost)
    good_cost = matched & (best_cost <= max_cost)
    boundary = good_cost & at_boundary & capped
    fail_amb = good_cost & ~boundary & ambiguous
    success = good_cost & ~boundary & ~ambiguous
    var_pred = state.var + process_noise
    consistent = ((xi_hat - state.mu) ** 2) <= 9.0 * (var_pred + var_obs)
    fail_amb = fail_amb | (success & ~consistent)
    success = success & consistent

    # --- posterior fusion ---------------------------------------------
    denom_f = var_pred + var_obs
    mu_new = torch.where(success,
                         (var_obs * state.mu + var_pred * xi_hat) / denom_f,
                         torch.where(boundary, xi_hat, state.mu))
    var_fused = torch.maximum(var_pred * var_obs / denom_f,
                              var_pred * min_var_ratio)
    var_new = torch.where(success, var_fused,
                          torch.where(attempted, var_pred, state.var))
    mu_new = torch.clamp(mu_new, idepth_min, idepth_max)

    hard_fail = fail_oob | fail_cost | fail_amb
    zero_i = torch.zeros_like(state.dropouts)
    dropouts = torch.where(success | boundary, zero_i,
                           torch.where(hard_fail, state.dropouts + 1,
                                       state.dropouts))
    kill_dropout = state.valid & (dropouts > max_dropouts)
    kill_var = state.valid & (var_new > max_idepth_var)
    valid_new = state.valid & ~kill_dropout & ~kill_var

    status = torch.full((N,), STATUS_SKIPPED, dtype=torch.int32, device=dev)
    for mask, code in ((fail_ref_grad, STATUS_REF_GRAD),
                       (fail_oob, STATUS_OOB),
                       (fail_cost, STATUS_MAX_COST),
                       (fail_amb, STATUS_AMBIGUOUS),
                       (boundary, STATUS_BOUNDARY),
                       (success, STATUS_OK)):
        status = torch.where(mask, code, status)

    def count(m):
        return torch.sum(m.to(torch.int32))

    counts = {
        "num_idepth_updates": count(success),
        "num_fail_ref_patch_grad": count(fail_ref_grad),
        "num_fail_ambiguous_match": count(fail_amb),
        "num_fail_max_cost": count(fail_cost),
        "num_fail_max_dropouts": count(kill_dropout),
        "num_fail_max_var": count(kill_var),
    }

    new_state = FeatureFilterState(
        uv_ref=state.uv_ref, kf_idx=state.kf_idx,
        mu=mu_new, var=var_new, dropouts=dropouts, valid=valid_new,
        frame_id=state.frame_id)
    return EpipolarResult(state=new_state, status=status, xi_meas=xi_hat,
                          uv_match=uv_match, counts=counts)


def project_features(state: FeatureFilterState, kf_q, kf_t, cur_q, cur_t,
                     cam: Pinhole):
    """Project features (ref pixel + posterior idepth) into the current
    frame (reference `project_features` stage). Returns (uv_cur [N,2],
    idepth_cur [N], in_bounds [N])."""
    q_cr_k, t_cr_k, _ = relative_poses(kf_q, kf_t, cur_q, cur_t)
    kf_idx = state.kf_idx.long()
    q_cr = q_cr_k[kf_idx]
    t_cr = t_cr_k[kf_idx]
    ray = cam.ray(state.uv_ref)
    mu = torch.clamp(state.mu, min=1e-6)
    X_cur = quat_rotate(q_cr, ray) / mu[:, None] + t_cr
    z = X_cur[..., 2]
    ok = z > 1e-6
    uv = cam.project(torch.where(ok[:, None], X_cur, unit_z_like(X_cur)))
    idepth_cur = torch.where(ok, 1.0 / torch.clamp(z, min=1e-6),
                             torch.zeros_like(z))
    inb = ok & cam.in_bounds(uv)
    return uv, idepth_cur, inb
