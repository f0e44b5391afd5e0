"""Windowed photometric bundle adjustment with Schur-complement depth
elimination.

Counterpart of `flame_ros_tpu/models/ba.py`: jointly refine the keyframe
window's poses and per-point inverse depths by Gauss-Newton on
photometric (plus gradient-magnitude and reprojection) residuals,

    r_{p,j} = I_j( pi( T_j^-1 T_ref pi^-1(p, d_p) ) ) - I_ref(p)

with one pose perturbation tau_j (6 DoF, +2 affine exposure) per
non-reference keyframe and one inverse depth d_p per point. The depth
block is diagonal, so it is eliminated by the Schur complement and the
reduced system is [K*D, K*D] over the poses.

The JAX package writes the residuals per (point, frame) pair inside two
nested vmaps and takes each pair's Jacobian with `jax.jacfwd`. Here the
residual channels are one batched function of tau [K, D] and d [P] on a
[K, P] layout; since r[k, p] depends only on tau_k and d_p, its
Jacobians come out exactly by forward mode with D + 1 one-hot tangents
(`torch.func.jvp` under `torch.func.vmap`): no finite differences and no
loop over pairs. The sampler's clamps use `torch.maximum`/`minimum`,
which split a tie 0.5/0.5 in forward mode as JAX's do.

Nothing in `bundle_adjust_window` reads back to the host: the level
schedule is a Python loop over Python ints, the [K*D, K*D] solve is
`solve_ex` without its error check, and the accept/reject and adaptive
damping are `torch.where`. The JAX package's HIGHEST-precision
contractions are f32 here (the package turns TF32 off).

The point-sharded solver (`bundle_adjust_window_sharded`,
`hybrid_bundle_adjust_sharded`) splits the points over a device list:
each block builds its Schur partial sums on its device, one sum per
iteration onto the first device assembles the pose system, and every
block back-substitutes its depths from the one solve (the JAX package's
psums over a ("feat",) mesh). The unsharded solve is the same code on one
block.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.geometry.se3 import (SE3, quat_conj, quat_mul,
                                          quat_rotate)
from flame_ros_torch.models.tracking import _twist_grid
from flame_ros_torch.ops import epipolar as ep
from flame_ros_torch.ops.pyramid import (bilinear_pyramid,
                                         bilinear_pyramid_batched)
from flame_ros_torch.utils.device import resolve_devices

# jnp.maximum(d, 1e-6) as a tensor operand, so that forward mode splits a
# tie as JAX does (a CPU scalar joins a tensor on any device).
_MIN_IDEPTH = torch.tensor(1e-6, dtype=torch.float32)


class BAResult(NamedTuple):
    q: torch.Tensor           # [K, 4] refined keyframe rotations
    t: torch.Tensor           # [K, 3]
    idepths: torch.Tensor     # [P] refined point inverse depths (ref frame)
    final_cost: torch.Tensor
    n_valid: torch.Tensor
    gains: torch.Tensor       # [K] per-frame affine exposure gain vs ref
    offsets: torch.Tensor     # [K] per-frame affine exposure offset


def _level(l: int, device) -> torch.Tensor:
    return torch.full((), l, dtype=torch.int32, device=device)


def gather_ba_inputs(kf_valid, kf_ids, feat_valid, feat_kf_idx, feat_uv,
                     feat_mu, *, budget: int = 256, anchor: str = "newest"):
    """Select the reference keyframe and up to `budget` of its features
    on the device, packed into one f32 vector so the host reads the whole
    BA input set in one copy. Layout:

        [ K kf_valid | K kf_ids | ref_slot | n_sel
          | budget*2 uv | budget d0 | budget point_valid ]

    anchor: the keyframe that parameterizes the points (the BA gauge).
    "newest" picks the newest valid keyframe, which owns the freshest
    detections; "most_owned" the slot owning the most live features (a
    saturated dense pool anchors nearly all features in the first-filled
    keyframe, where "newest" would select none). Feature slots whose
    keyframe index lies outside [0, K) after negative indices wrap (as
    numpy indexing wraps them) count for no slot, as the JAX scatter's
    mode="drop" does."""
    K = kf_valid.shape[0]
    f32 = torch.float32
    if anchor == "most_owned":
        idx = feat_kf_idx.long()
        idx = torch.where(idx < 0, idx + K, idx)
        inside = (idx >= 0) & (idx < K)
        counts = torch.zeros(K + 1, dtype=f32, device=kf_valid.device)
        counts.index_add_(0, torch.where(inside, idx, torch.full_like(idx, K)),
                          feat_valid.to(f32))
        ref_slot = torch.argmax(torch.where(kf_valid, counts[:K],
                                            torch.full_like(counts[:K], -1.0)))
    elif anchor == "newest":
        ref_slot = torch.argmax(torch.where(kf_valid, kf_ids,
                                            torch.full_like(kf_ids, -1)))
    else:
        raise ValueError(f"unknown BA anchor {anchor!r}")
    fv = feat_valid & (feat_kf_idx == ref_slot)
    # Stable sort of an integer key: the selected features keep their
    # index order (np.flatnonzero(fv)[:budget]).
    order = torch.argsort((~fv).to(torch.int32), stable=True)[:budget]
    pv = fv[order]
    uv = torch.where(pv[:, None], feat_uv[order],
                     torch.zeros_like(feat_uv[:1]))
    d0 = torch.where(pv, feat_mu[order], torch.full_like(feat_mu[:1], 0.5))
    return torch.cat([
        kf_valid.to(f32), kf_ids.to(f32),
        torch.stack([ref_slot.to(f32), fv.sum().to(f32)]),
        uv.to(f32).reshape(-1), d0.to(f32), pv.to(f32)])


def match_window_points(ref_pyr, ref_q, ref_t, kf_pyrs, kf_q, kf_t, uv, d0,
                        pv, *, cam: Pinhole):
    """Epipolar pixel matches of the BA points into every window frame:
    `epipolar_update` with its default settings, a tight prior (var
    0.0025) around the supplied depths and the reference pyramid as the
    only keyframe, once per frame. Feeds bundle_adjust_window's
    reprojection channels. Returns (uv_obs [P, K, 2], valid [P, K]).

    The search line assumes the current frame poses, so the matches
    carry a second-order bias when those poses are wrong
    (`refine_matches_2d` removes it)."""
    P = uv.shape[0]
    dev = uv.device
    i32 = torch.int32
    state = ep.FeatureFilterState(
        uv_ref=uv, kf_idx=torch.zeros(P, dtype=i32, device=dev), mu=d0,
        var=torch.full((P,), 0.0025, dtype=torch.float32, device=dev),
        dropouts=torch.zeros(P, dtype=i32, device=dev), valid=pv,
        frame_id=torch.zeros(P, dtype=i32, device=dev))
    uvm, ok = [], []
    for j in range(kf_pyrs.shape[0]):
        res = ep.epipolar_update(state, ref_pyr[None], ref_q[None],
                                 ref_t[None], kf_pyrs[j], kf_q[j], kf_t[j],
                                 cam=cam)
        uvm.append(res.uv_match)
        ok.append(res.status == ep.STATUS_OK)
    return torch.stack(uvm, 1), torch.stack(ok, 1)


def _grid(radius: int, device) -> torch.Tensor:
    """[(2r+1)^2, 2] integer offsets, u fastest (meshgrid 'xy')."""
    a = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(a, a, indexing="xy"),
                       -1).reshape(-1, 2)


def refine_matches_2d(ref_pyr, uv_ref, kf_pyrs, uv_obs, obs_valid, *,
                      iters: int = 3, start_level: int = 2, radius: int = 2,
                      search_radius: int = 3, max_shift: float = 24.0):
    """Unconstrained 2-D refinement of per-frame pixel matches, all
    (frame, point) pairs as one [K, P] batch.

    Frees each match from the epipolar line of the current (possibly
    wrong) poses: a discrete zero-mean-SSD pre-search over a
    (2*search_radius+1)^2 offset grid at the coarsest level (the first
    grid index wins a tie, as jnp.argmin), then zero-mean inverse-
    compositional Lucas-Kanade on 2-D translation over a (2r+1)^2 patch,
    coarse to fine (batched 2x2 `solve_ex`).

    ref_pyr [L,H,W]; uv_ref [P,2] template pixels in the reference frame;
    kf_pyrs [K,L,H,W]; uv_obs [P,K,2] initial matches; obs_valid [P,K].
    Returns (uv_refined [P,K,2], valid [P,K]): matches that move more
    than max_shift px or leave the image are invalidated."""
    K = kf_pyrs.shape[0]
    L, H, W = ref_pyr.shape
    dev = ref_pyr.device
    base = _grid(radius, dev)                           # [n, 2]
    kf_flat = kf_pyrs.reshape(K, -1)
    rows = torch.arange(K, device=dev)

    def sample_kf(uv, lv):
        return bilinear_pyramid_batched(kf_flat, rows, (L, H, W), uv, lv)

    uv = uv_obs.transpose(0, 1)                         # [K, P, 2]
    if search_radius > 0:
        lv = _level(start_level, dev)
        step = 2.0 ** start_level
        offs = base * step
        T = bilinear_pyramid(ref_pyr, uv_ref[:, None, :] + offs, lv)[0]
        Tz = T - torch.mean(T, dim=-1, keepdim=True)    # [P, n]
        grid = _grid(search_radius, dev)                # [S, 2]
        cand = ((uv[:, :, None, :] + grid * step)[:, :, :, None, :]
                + offs)                                 # [K, P, S, n, 2]
        I, iok = sample_kf(cand, lv)
        Iz = I - torch.mean(I, dim=-1, keepdim=True)
        ssd = torch.sum((Iz - Tz[None, :, None, :]) ** 2, dim=-1)
        ssd = torch.where(iok.all(-1), ssd, torch.full_like(ssd, float("inf")))
        best = torch.argmin(ssd, dim=-1)                # [K, P]
        hit = torch.isfinite(torch.gather(ssd, -1, best[..., None]))
        # Keep the initial match where no candidate fit.
        uv = torch.where(hit, uv + grid[best] * step, uv)

    eye2 = 1e-3 * torch.eye(2, dtype=torch.float32, device=dev)
    for l in range(start_level, -1, -1):
        lv = _level(l, dev)
        step = 2.0 ** l
        offs = base * step
        e = torch.eye(2, dtype=torch.float32, device=dev) * step
        tuv = uv_ref[:, None, :] + offs                 # [P, n, 2]
        smp = bilinear_pyramid(
            ref_pyr, torch.stack([tuv, tuv + e[0], tuv - e[0], tuv + e[1],
                                  tuv - e[1]]), lv)[0]
        T = smp[0]
        gx = (smp[1] - smp[2]) / (2 * step)
        gy = (smp[3] - smp[4]) / (2 * step)
        Tz = T - torch.mean(T, dim=-1, keepdim=True)
        J = torch.stack([gx, gy], -1)                   # [P, n, 2]
        Jz = J - torch.mean(J, dim=1, keepdim=True)     # zero-mean proj
        Hm = (Jz.transpose(1, 2) @ Jz + eye2).expand(K, -1, -1, -1)
        for _ in range(iters):
            I, iok = sample_kf(uv[:, :, None, :] + offs, lv)
            Iz = I - torch.mean(I, dim=-1, keepdim=True)
            r = (Iz - Tz) * iok.to(torch.float32)       # [K, P, n]
            g = torch.sum(Jz * r[..., None], dim=2)     # [K, P, 2]
            delta = torch.linalg.solve_ex(Hm, g[..., None],
                                          check_errors=False)[0][..., 0]
            # Stay within the level's basin per iteration.
            delta = torch.clamp(delta, -radius * step, radius * step)
            uv = uv - delta

    uv_new = uv.transpose(0, 1)                         # [P, K, 2]
    inb = ((uv_new[..., 0] >= radius) & (uv_new[..., 0] <= W - 1 - radius)
           & (uv_new[..., 1] >= radius) & (uv_new[..., 1] <= H - 1 - radius))
    shift_ok = torch.linalg.vector_norm(uv_new - uv_obs, dim=-1) <= max_shift
    ok = obs_valid & inb & shift_ok & torch.isfinite(uv_new).all(-1)
    return torch.where(ok[..., None], uv_new, uv_obs), ok


def hybrid_bundle_adjust(kf_pyrs, kf_q, kf_t, kf_valid, uv_ref, idepth0,
                         point_valid, *, cam: Pinhole, rounds: int = 3,
                         num_iters: int = 12, coarse_iters: int = 10,
                         level: int = 1, pre_search: bool = True,
                         **ba_kwargs) -> BAResult:
    """Hybrid windowed BA with match re-estimation between rounds.

    One round = epipolar matches under the current pose estimates
    (`match_window_points`) -> 2-D LK line-bias removal
    (`refine_matches_2d`) -> joint pose+depth Gauss-Newton with
    reprojection channels (`bundle_adjust_window`). Round 1 searches
    tight (radius 3, 24 px cap), round 2 wide (radius 8, 64 px) from
    round 1's best, later rounds tight again. Rounds hill-climb on the
    final cost: each starts from the best result so far and is kept only
    if its cost improves on it (one host read of the cost per round, as
    in the JAX package). With pre_search and rounds > 1, a tight round
    from the original poses seeds the climb and `discrete_pose_presearch`
    starts the scheduled rounds. rounds=1 is the live path: one round,
    no host read.

    The reference keyframe must sit at index 0 (callers roll the ring)."""
    WIDE = (8, 64.0)
    TIGHT = (3, 24.0)
    best_cost = float("inf")
    best_res = None

    def one_round(q, t, d, wide):
        sr, ms = WIDE if wide else TIGHT
        uv_obs, obs_ok = match_window_points(
            kf_pyrs[0], q[0], t[0], kf_pyrs, q, t, uv_ref, d, point_valid,
            cam=cam)
        uv_obs, obs_ok = refine_matches_2d(
            kf_pyrs[0], uv_ref, kf_pyrs, uv_obs, obs_ok, search_radius=sr,
            max_shift=ms)
        return bundle_adjust_window(
            kf_pyrs, q, t, kf_valid, uv_ref, d, point_valid, ref_index=0,
            cam=cam, num_iters=num_iters, coarse_iters=coarse_iters,
            level=level, uv_obs=uv_obs, obs_valid=obs_ok, **ba_kwargs)

    q, t, d = kf_q, kf_t, idepth0
    if pre_search and rounds > 1:
        # A tight round from the original poses first, so a coarse-level
        # aliasing jump of the discrete search cannot make the result
        # worse than not searching.
        best_res = one_round(q, t, d, wide=False)
        best_cost = float(best_res.final_cost)
        q, t = discrete_pose_presearch(kf_pyrs, q, t, kf_valid, uv_ref, d,
                                       point_valid, cam=cam)
    for r in range(max(rounds, 1)):
        res = one_round(q, t, d, wide=(r == 1))
        if best_res is None or float(res.final_cost) < best_cost:
            best_cost = float(res.final_cost)
            best_res = res
        q, t, d = best_res.q, best_res.t, best_res.idepths
    return best_res


def discrete_pose_presearch(kf_pyrs, kf_q, kf_t, kf_valid, uv_ref, idepth,
                            point_valid, *, cam: Pinhole, ref_index: int = 0,
                            level: int = 2, step: float = 0.04,
                            n_steps: int = 3, iters: int = 3):
    """Coordinate descent over a discrete pose grid, per keyframe.

    For each non-reference keyframe independently, the robust photometric
    cost at a coarse level for the candidate perturbations: identity
    first, then +-{1..n_steps}*step along each twist axis (37 at the
    defaults; argmin ties go to the earlier candidate); move to the
    argmin, `iters` times. The identity candidate keeps the discrete cost
    from increasing. All [K, candidates, P] costs are one batch.
    Returns (q [K,4], t [K,3]); the reference frame and invalid frames
    keep their poses."""
    K = kf_q.shape[0]
    dev = kf_pyrs.device
    ref_q, ref_t = kf_q[ref_index], kf_t[ref_index]
    pv = point_valid.to(torch.float32)
    lv = _level(level, dev)
    iref = bilinear_pyramid(kf_pyrs[ref_index], uv_ref, lv)[0]
    cand = _twist_grid(step, n_steps, dev)                # [C, 6]
    kf_flat = kf_pyrs.reshape(K, -1)
    rows = torch.arange(K, device=dev)
    need = 0.5 * torch.clamp(torch.sum(pv), min=1.0)
    q, t = kf_q, kf_t
    for _ in range(iters):
        uv_j, front = _warp_uv(cand[None, :, None, :], idepth, uv_ref,
                               q[:, None, None, :], t[:, None, None, :],
                               ref_q, ref_t, cam)         # [K, C, P, 2]
        val, ok = bilinear_pyramid_batched(kf_flat, rows, tuple(
            kf_pyrs.shape[1:]), uv_j, lv)
        w = (front & ok).to(torch.float32)
        r = (val - iref) * w
        w = w * pv
        n = torch.sum(w, dim=-1)                          # [K, C]
        cost = (torch.sum(torch.clamp(torch.abs(r), max=24.0) * w, dim=-1)
                / torch.clamp(n, min=1.0))
        # Out-of-view "solutions" zero their residuals: require the
        # candidate to keep most points visible.
        cost = torch.where(n >= need, cost,
                           torch.full_like(cost, float("inf")))
        dT = SE3.exp(cand[torch.argmin(cost, dim=1)])
        q, t = quat_mul(q, dT.q), quat_rotate(q, dT.t) + t
    keep = ((torch.arange(K, device=dev) == ref_index) | ~kf_valid)[:, None]
    return torch.where(keep, kf_q, q), torch.where(keep, kf_t, t)


def _warp_uv(tau, d, uv, q_j, t_j, ref_q, ref_t, cam: Pinhole):
    """Project points (ref pixel uv [..., 2], inverse depth d [...]) into
    frames (q_j, t_j) under pose perturbations tau [..., 6]; every
    argument broadcasts. Returns (uv_j [..., 2], in front [...])."""
    dT = SE3.exp(tau)
    qj = quat_mul(q_j, dT.q)
    tj = quat_rotate(q_j, dT.t) + t_j
    # X in the ref camera -> world -> frame j.
    X_ref = cam.ray(uv) / torch.maximum(d, _MIN_IDEPTH)[..., None]
    X_w = quat_rotate(ref_q, X_ref) + ref_t
    X_j = quat_rotate(quat_conj(qj), X_w - tj)
    z = X_j[..., 2]
    front = z > 1e-3
    zs = torch.where(front, z, torch.ones_like(z))
    uv_j = torch.stack([cam.fx * X_j[..., 0] / zs + cam.cx,
                        cam.fy * X_j[..., 1] / zs + cam.cy], -1)
    return uv_j, front


def _grad_mag(sample, uv, step: float):
    """Gradient magnitude at level-0 coords uv [K, P, 2] (central
    differences at the level's pixel pitch `step`), sampled by
    `sample(uv [K, 4, P, 2])` in one gather. Returns (mag, ok)."""
    e = torch.eye(2, dtype=uv.dtype, device=uv.device) * step
    offs = torch.stack([e[0], -e[0], e[1], -e[1]])[:, None, :]
    v, ok = sample(uv[:, None] + offs)
    gx = (v[:, 0] - v[:, 1]) / (2.0 * step)
    gy = (v[:, 2] - v[:, 3]) / (2.0 * step)
    return torch.sqrt(gx * gx + gy * gy + 1e-6), ok.all(1)


def _channel_fn(kf_pyrs, uv_ref, ref_q, ref_t, ref_index: int, cam: Pinhole,
                levels, *,
                estimate_affine: bool, gradient_weight: float, uv_obs,
                obs_valid, reproj_weight: float):
    """The residual channels of bundle_adjust_window as one batched
    function channels(q, t, g, o, l, tau, d) -> (r [K, P, C], w [K, P])
    over every (frame, point) pair at pyramid level l (one of `levels`),
    the points parameterized in the gauge frame ref_index (pose ref_q,
    ref_t): intensity (+ gradient magnitude) (+ reprojection) under
    perturbations tau [K, D] of the frames (twist, then gain and offset
    with estimate_affine) and depths d [P]; w is the in-bounds weight."""
    K, L, H, W = kf_pyrs.shape
    dev = kf_pyrs.device
    f32 = torch.float32
    ref_pyr = kf_pyrs[ref_index]
    kf_flat = kf_pyrs.reshape(K, -1)
    rows = torch.arange(K, device=dev)
    use_grad = gradient_weight > 0.0
    if uv_obs is not None:
        if obs_valid is None:
            obs_valid = torch.ones(uv_obs.shape[:2], dtype=torch.bool,
                                   device=dev)
        uv_obs_k = uv_obs.transpose(0, 1)                      # [K, P, 2]
        obs_w = obs_valid.transpose(0, 1).to(f32)
    # Reference intensities and gradient magnitudes at the levels.
    ref_at = {}
    for l in levels:
        lv = _level(l, dev)
        step = float(2 ** l)
        e = torch.eye(2, dtype=f32, device=dev) * step
        smp = bilinear_pyramid(
            ref_pyr, torch.stack([uv_ref, uv_ref + e[0], uv_ref - e[0],
                                  uv_ref + e[1], uv_ref - e[1]]), lv)[0]
        gx = (smp[1] - smp[2]) / (2.0 * step)
        gy = (smp[3] - smp[4]) / (2.0 * step)
        ref_at[l] = (lv, smp[0], torch.sqrt(gx * gx + gy * gy + 1e-6))

    def channels(q, t, g, o, l, tau, d):
        lv, iref_l, gref_l = ref_at[l]
        if estimate_affine:
            g_eff = (g + tau[:, 6])[:, None]
            o_eff = (o + tau[:, 7])[:, None]
        else:
            g_eff, o_eff = g[:, None], o[:, None]
        uv_j, front = _warp_uv(tau[:, None, :6], d, uv_ref, q[:, None],
                               t[:, None], ref_q, ref_t, cam)

        def sample(uv):
            return bilinear_pyramid_batched(kf_flat, rows, (L, H, W), uv, lv)

        val, ok = sample(uv_j)
        w = (front & ok).to(f32)
        chans = [(val - (g_eff * iref_l + o_eff)) * w]
        if use_grad:
            gm, gok = _grad_mag(sample, uv_j, float(2 ** l))
            chans.append(gradient_weight * (gm - g_eff * gref_l) * w
                         * gok.to(f32))
        if uv_obs is not None:
            wo = w * obs_w
            du = uv_j - uv_obs_k
            chans.append(reproj_weight * du[..., 0] * wo)
            chans.append(reproj_weight * du[..., 1] * wo)
        return torch.stack(chans, -1), w

    return channels


def _linearize(channels, q, t, g, o, l: int, d, D: int):
    """Residuals r [K, P, C], weights w [K, P] and the exact Jacobians
    Jt [K, P, C, D] (d r[k, p] / d tau_k) and Jd [K, P, C] (d r[k, p] /
    d d_p) at tau = 0: forward mode with D + 1 one-hot tangents (each
    frame parameter in the same slot of every frame, then the depths)
    under one vmap."""
    K, P = q.shape[0], d.shape[0]
    sel = torch.eye(D + 1, dtype=torch.float32, device=d.device)
    tau0 = torch.zeros((K, D), dtype=torch.float32, device=d.device)

    def res_fn(tau, dd):
        return channels(q, t, g, o, l, tau, dd)

    rr, jv, ww = torch.func.vmap(
        lambda a, b: torch.func.jvp(res_fn, (tau0, d), (a, b),
                                    has_aux=True),
        out_dims=(None, 0, None))(sel[:, None, :D].expand(D + 1, K, D),
                                  sel[:, None, D].expand(D + 1, P))
    return rr, ww, jv[:D].permute(1, 2, 3, 0), jv[D]


class _Shard(NamedTuple):
    """One device's points of a window solve, with the replicated window
    inputs on that device."""
    device: torch.device
    kf_pyrs: torch.Tensor
    kf_q: torch.Tensor
    kf_t: torch.Tensor
    kf_valid: torch.Tensor
    uv_ref: torch.Tensor
    idepth0: torch.Tensor
    point_valid: torch.Tensor
    uv_obs: object
    obs_valid: object


def _sum_on(parts, device):
    """Sum of tensors on possibly different devices, on `device` (one
    part: that part itself)."""
    out = parts[0].to(device, non_blocking=True)
    for x in parts[1:]:
        out = out + x.to(device, non_blocking=True)
    return out


def _cost_terms(rr, ww, wmask, huber_delta: float):
    """(numerator, denominator) of the robust cost: clamped |r| summed
    over the weighted (point, frame) pairs, and their weight."""
    w = (ww * wmask)[..., None]
    num = torch.sum(torch.where(
        w > 0, torch.clamp(torch.abs(rr), max=3 * huber_delta),
        torch.zeros_like(rr)))
    return num, torch.sum(w)


def bundle_adjust_window(
    kf_pyrs,           # [K, L, H, W] keyframe pyramids
    kf_q, kf_t,        # [K, 4], [K, 3] initial poses (camera-to-world)
    kf_valid,          # [K] bool (invalid frames contribute nothing)
    uv_ref,            # [P, 2] tracked points in the reference keyframe
    idepth0,           # [P] initial inverse depths (ref frame)
    point_valid,       # [P] bool
    *,
    uv_obs=None,           # [P, K, 2] observed pixel matches per frame
    obs_valid=None,        # [P, K] bool
    **ba_kwargs,
) -> BAResult:
    """Joint pose+depth Gauss-Newton over the keyframe window.

    The reference keyframe (ref_index) is the gauge: its pose is fixed
    and the points are parameterized in its frame. `coarse_iters`
    iterations at level min(level + 1, L - 1), then `num_iters` at
    `level`; each step is kept only if the robust cost does not
    increase (the damping halves on a kept step and grows 8x on a
    rejected one).

    estimate_affine: each non-reference frame also carries an affine
    exposure pair (gain_j, offset_j); residuals become
    I_j(warp) - (gain_j * I_ref(p) + offset_j), solved jointly (frame
    blocks grow 6 -> 8). gradient_weight > 0 adds a gradient-magnitude
    channel gw * (|grad I_j|(warp) - gain_j * |grad I_ref|(p)).
    uv_obs/obs_valid add reprojection channels reproj_weight *
    (pi(warp) - uv_obs[p, j]). The keyword arguments and their defaults
    are `_ba_solve`'s. Returns a BAResult."""
    return _ba_solve([_Shard(kf_pyrs.device, kf_pyrs, kf_q, kf_t, kf_valid,
                             uv_ref, idepth0, point_valid, uv_obs,
                             obs_valid)], **ba_kwargs)


def bundle_adjust_window_sharded(devices, kf_pyrs, kf_q, kf_t, kf_valid,
                                 uv_ref, idepth0, point_valid, *,
                                 uv_obs=None, obs_valid=None,
                                 **ba_kwargs) -> BAResult:
    """`bundle_adjust_window` with the point axis split over `devices`
    (a list of torch devices; it may name one device several times).

    Points (and their matches) split into len(devices) contiguous blocks,
    block k on devices[k]; the keyframe pyramids and poses are
    replicated. Each block builds its residuals, Jacobians and Schur
    partial sums; one sum per Gauss-Newton iteration, onto devices[0],
    assembles the [K*D, K*D] pose system and the current cost, a second
    one the trial step's cost; the solve and the accept/reject (a
    `torch.where`, no host read) run there and every block uses that
    step. Depth back-substitution stays on each block's device.
    Returns poses on devices[0] and the idepths of every block,
    concatenated there. P must divide by len(devices) (pad with
    point_valid=False lanes). Agrees with the unsharded solve up to f32
    reduction order (held to 1e-5, tests/test_torch_ba.py); one device
    gives the unsharded solve exactly."""
    devices = resolve_devices(devices)
    n, P = len(devices), uv_ref.shape[0]
    if P % n:
        raise ValueError(f"{P} points do not split over {n} devices")
    if uv_obs is not None and obs_valid is None:
        obs_valid = torch.ones(uv_obs.shape[:2], dtype=torch.bool,
                               device=uv_obs.device)
    shards = []
    for k, dev in enumerate(devices):
        sl = slice(k * P // n, (k + 1) * P // n)

        def put(x, sl=sl, dev=dev):
            return None if x is None else x[sl].to(dev, non_blocking=True)

        def rep(x, dev=dev):
            return x.to(dev, non_blocking=True)

        shards.append(_Shard(dev, rep(kf_pyrs), rep(kf_q), rep(kf_t),
                             rep(kf_valid), put(uv_ref), put(idepth0),
                             put(point_valid), put(uv_obs), put(obs_valid)))
    return _ba_solve(shards, **ba_kwargs)


def hybrid_bundle_adjust_sharded(devices, kf_pyrs, kf_q, kf_t, kf_valid,
                                 uv_ref, idepth0, point_valid, *,
                                 cam: Pinhole, num_iters: int = 12,
                                 coarse_iters: int = 10, level: int = 1,
                                 **ba_kwargs) -> BAResult:
    """One round of hybrid BA with the window solve's point axis split
    over `devices` (`bundle_adjust_window_sharded`): the epipolar matches
    and their 2-D refinement run on the inputs' device, as in
    `hybrid_bundle_adjust(rounds=1)`, whose result this equals up to the
    solve's reduction order. The reference keyframe must sit at index
    0 (callers roll the ring)."""
    uv_obs, obs_ok = match_window_points(
        kf_pyrs[0], kf_q[0], kf_t[0], kf_pyrs, kf_q, kf_t, uv_ref, idepth0,
        point_valid, cam=cam)
    uv_obs, obs_ok = refine_matches_2d(
        kf_pyrs[0], uv_ref, kf_pyrs, uv_obs, obs_ok, search_radius=3,
        max_shift=24.0)
    return bundle_adjust_window_sharded(
        devices, kf_pyrs, kf_q, kf_t, kf_valid, uv_ref, idepth0,
        point_valid, uv_obs=uv_obs, obs_valid=obs_ok, ref_index=0, cam=cam,
        num_iters=num_iters, coarse_iters=coarse_iters, level=level,
        **ba_kwargs)


def _ba_solve(shards, *, ref_index: int = 0, cam: Pinhole,
              num_iters: int = 5, coarse_iters: int = 10, level: int = 1,
              huber_delta: float = 8.0, depth_prior_weight: float = 50.0,
              damping: float = 0.1, optimize_poses: bool = True,
              estimate_affine: bool = True, gradient_weight: float = 0.5,
              reproj_weight: float = 4.0) -> BAResult:
    """The window solve over point blocks (`_Shard`s, one or several):
    the pose state lives on the first block's device."""
    f32 = torch.float32
    m = shards[0]
    dev = m.device
    K = m.kf_q.shape[0]
    L, H, W = m.kf_pyrs.shape[1:]
    D = 8 if estimate_affine else 6
    coarse = min(level + 1, L - 1)

    # Per block: the gauge's samples, the point and frame masks, and the
    # residual channels.
    ctx = []
    for sh in shards:
        d_ = sh.device
        iref, iok = bilinear_pyramid(sh.kf_pyrs[ref_index], sh.uv_ref,
                                     _level(level, d_))
        pvalid = sh.point_valid & iok & (sh.idepth0 > 1e-4)
        fmask = sh.kf_valid & (torch.arange(K, device=d_) != ref_index)
        wmask = fmask.to(f32)[:, None] * pvalid.to(f32)[None, :]
        channels = _channel_fn(
            sh.kf_pyrs, sh.uv_ref, sh.kf_q[ref_index], sh.kf_t[ref_index],
            ref_index, cam, sorted({coarse, level}),
            estimate_affine=estimate_affine,
            gradient_weight=gradient_weight, uv_obs=sh.uv_obs,
            obs_valid=sh.obs_valid, reproj_weight=reproj_weight)
        ctx.append((iref, pvalid, wmask, channels,
                    torch.zeros((K, D), dtype=f32, device=d_)))

    fmask = m.kf_valid & (torch.arange(K, device=dev) != ref_index)
    step_clip = torch.cat([torch.full((6,), 0.2, dtype=f32, device=dev),
                           torch.full((1,), 0.1, dtype=f32, device=dev),
                           torch.full((1,), 8.0, dtype=f32, device=dev)])[:D]
    tau0 = torch.zeros((K, D), dtype=f32, device=dev)
    q, t = m.kf_q, m.kf_t
    ds = [sh.idepth0 for sh in shards]
    g = torch.ones((K,), dtype=f32, device=dev)
    o = torch.zeros((K,), dtype=f32, device=dev)
    lam = torch.full((), damping, dtype=f32, device=dev)
    KD = K * D

    def on(x, d_):
        return x.to(d_, non_blocking=True)

    for l in [coarse] * coarse_iters + [level] * num_iters:
        lin, packed = [], []
        for sh, (_, pvalid, wmask, channels, _), d in zip(shards, ctx, ds):
            d_ = sh.device
            rr, ww, Jt, Jd = _linearize(channels, on(q, d_), on(t, d_),
                                        on(g, d_), on(o, d_), l, d, D)
            ar = torch.abs(rr)
            hub = torch.where(ar <= huber_delta, torch.ones_like(rr),
                              huber_delta / torch.clamp(ar, min=1e-6))
            w = hub * (ww * wmask)[..., None]           # [K, P, C]

            # Frame blocks Hpp [K, D, D], bp [K, D]; point diagonal Hdd
            # [P]; coupling Hpd [K, P, D].
            WJ = w[..., None] * Jt
            Hpp = torch.einsum("kpci,kpcj->kij", WJ, Jt)
            bp = torch.einsum("kpci,kpc->ki", WJ, rr)
            Hdd = torch.sum(w * Jd * Jd, dim=(0, 2)) + depth_prior_weight
            bd = (torch.sum(w * Jd * rr, dim=(0, 2))
                  + depth_prior_weight * (d - sh.idepth0))
            Hpd = torch.sum(WJ * Jd[..., None], dim=2)

            # Schur: S = Hpp - sum_p Hpd^T Hdd^-1 Hpd (block dense across
            # frames through the shared depths), this block's points.
            Hdd_inv = 1.0 / Hdd
            P_ = Hdd.shape[0]
            A = (Hpd * Hdd_inv[None, :, None]).permute(0, 2, 1).reshape(
                KD, P_)
            B = Hpd.permute(0, 2, 1).reshape(KD, P_)
            S_ = torch.block_diag(*Hpp.unbind(0)) - A @ B.T
            rhs_ = bp.reshape(KD) - (A @ bd)
            num, den = _cost_terms(rr, ww, wmask, huber_delta)
            packed.append(torch.cat([S_.reshape(-1), rhs_, num[None],
                                     den[None]]))
            lin.append((Hpd, Hdd_inv, bd))
        tot = packed[0] if len(packed) == 1 else _sum_on(packed, dev)
        S = tot[:KD * KD].reshape(KD, KD)
        rhs = tot[KD * KD:KD * KD + KD]
        cost_old = tot[-2] / torch.clamp(tot[-1], min=1.0)
        # Adaptive Levenberg damping, then a huge diagonal prior that
        # freezes the gauge and invalid frames.
        S = S + torch.diag(lam * torch.clamp(torch.diagonal(S), min=1e-6))
        prior = torch.where(fmask, 0.0, 1e12).to(f32).repeat_interleave(D)
        S = S + torch.diag(prior)
        if optimize_poses:
            # Jacobi-normalize: with exposure columns the column scales
            # span ~1..1e3, which a raw f32 solve cannot hold.
            sc = torch.rsqrt(torch.diagonal(S) + 1e-12)
            Sn = sc[:, None] * S * sc[None, :]
            x = torch.linalg.solve_ex(Sn, sc * rhs, check_errors=False)[0]
            dtau = torch.clamp(-(sc * x).reshape(K, D), -step_clip,
                               step_clip)
        else:
            # Depth-only refinement: exact per-point Newton.
            dtau = tau0

        dT = SE3.exp(dtau[:, :6])
        q_new = quat_mul(q, dT.q)
        t_new = quat_rotate(q, dT.t) + t
        if estimate_affine:
            g_new = torch.clamp(g + dtau[:, 6], 0.5, 2.0)
            o_new = torch.clamp(o + dtau[:, 7], -96.0, 96.0)
        else:
            g_new, o_new = g, o

        # Back-substitute the depths on each block's device, and the
        # trial step's cost (the cost at the current state is the jvp's
        # primal output). Keep the step only if it does not increase.
        d_new, trial = [], []
        for sh, c_, d, lin_ in zip(shards, ctx, ds, lin):
            _, pvalid, wmask, channels, tau0_ = c_
            Hpd, Hdd_inv, bd = lin_
            d_ = sh.device
            corr = torch.sum(Hpd * on(dtau, d_)[:, None, :], dim=(0, 2))
            dd = torch.clamp(-(bd + corr) * Hdd_inv, -0.2, 0.2)
            dn = torch.clamp(torch.where(pvalid, d + dd, d), 1e-3, 10.0)
            d_new.append(dn)
            num, den = _cost_terms(
                *channels(on(q_new, d_), on(t_new, d_), on(g_new, d_),
                          on(o_new, d_), l, tau0_, dn), wmask, huber_delta)
            trial.append(torch.stack([num, den]))
        tr = trial[0] if len(trial) == 1 else _sum_on(trial, dev)
        cost_new = tr[0] / torch.clamp(tr[1], min=1.0)
        accept = cost_new <= cost_old
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        g = torch.where(accept, g_new, g)
        o = torch.where(accept, o_new, o)
        ds = [torch.where(on(accept, sh.device), dn, d)
              for sh, dn, d in zip(shards, d_new, ds)]
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0),
                          1e-4, 1e4)

    # Final intensity cost at the refined poses, depths and exposures.
    terms, n_valid = [], []
    for sh, (iref, pvalid, wmask, _, _), d in zip(shards, ctx, ds):
        d_ = sh.device
        qd, td, gd, od = (on(x, d_) for x in (q, t, g, o))
        uv_j, front = _warp_uv(torch.zeros((K, 1, 6), dtype=f32, device=d_),
                               d, sh.uv_ref, qd[:, None], td[:, None],
                               sh.kf_q[ref_index], sh.kf_t[ref_index], cam)
        val, ok = bilinear_pyramid_batched(
            sh.kf_pyrs.reshape(K, -1), torch.arange(K, device=d_),
            (L, H, W), uv_j, _level(level, d_))
        ww = (front & ok).to(f32)
        rr = (val - (gd[:, None] * iref + od[:, None])) * ww
        w = ww * wmask
        num = torch.sum(torch.where(w > 0, torch.clamp(torch.abs(rr),
                                                       max=3 * huber_delta),
                                    torch.zeros_like(rr)))
        terms.append(torch.stack([num, torch.sum(w)]))
        n_valid.append(torch.sum(pvalid.to(torch.int32)))
    tot = terms[0] if len(terms) == 1 else _sum_on(terms, dev)
    cost = tot[0] / torch.clamp(tot[1], min=1.0)
    return BAResult(
        q=q, t=t, idepths=(ds[0] if len(ds) == 1 else
                           torch.cat([on(x, dev) for x in ds])),
        final_cost=cost,
        n_valid=n_valid[0] if len(n_valid) == 1 else _sum_on(n_valid, dev),
        gains=g, offsets=o)
