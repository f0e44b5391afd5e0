"""The plain reference of one camera stream: the port's single-stream
external-pose step (`flame_ros_torch/models/engine.py`: pyramid ->
`_track_step` -> `_smooth_step`, then on a poseframe the host Delaunay of
the vertex positions, installed for the next frame), frozen for the
benchmark. One stream, one frame at a time: no vmap, no batching, no
hand-written kernel (the raster is `raster.py`'s plain v4), no worker
threads. It imports nothing of the port and is given only the frames,
poses, frame ids and the parameter tree of the configuration file.

`params_from_dict` turns that tree into attribute access with the two
derived capacities (`max_triangles` = 2 N, `max_edges` = 3 N)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from flamebench.reference import epipolar as ep_ops
from flamebench.reference import nltgv2 as reg_ops
from flamebench.reference import raster as raster_ops
from flamebench.reference.camera import Pinhole
from flamebench.reference.delaunay import edges_from_triangles, triangulate
from flamebench.reference.detection import (detect_features,
                                            occupancy_from_features)
from flamebench.reference.interp import bilinear
from flamebench.reference.pyramid import build_pyramid
from flamebench.reference.se3 import quat_conj, quat_mul, quat_rotate

NUM_LEVELS = 3
NO_WATERMARK = 2 ** 30

STATS_KEYS = (
    "num_feats", "num_vtx", "num_tris", "num_edges", "coverage",
    "num_idepth_updates", "num_fail_ref_patch_grad",
    "num_fail_ambiguous_match", "num_fail_max_cost",
    "num_fail_max_dropouts", "num_fail_max_var", "num_detections",
    "nltgv2_total_smoothness_cost", "nltgv2_avg_smoothness_cost",
    "nltgv2_total_data_cost", "nltgv2_avg_data_cost",
    "total_photo_error", "avg_photo_error",
    "true_pos", "true_neg", "false_pos", "false_neg",
    "total_idepth_error", "idepth_rmse", "health",
)


def params_from_dict(d: dict) -> SimpleNamespace:
    def ns(x):
        if isinstance(x, dict):
            return SimpleNamespace(**{k: ns(v) for k, v in x.items()})
        return x
    p = ns(d)
    p.engine.max_triangles = 2 * p.engine.max_features
    p.engine.max_edges = 3 * p.engine.max_features
    return p


class State(NamedTuple):
    feat: ep_ops.FeatureFilterState
    vtx_uv: torch.Tensor
    vtx_x: torch.Tensor
    vtx_w: torch.Tensor
    vtx_z: torch.Tensor
    vtx_in_graph: torch.Tensor
    edge_q: torch.Tensor
    edges: torch.Tensor
    edge_valid: torch.Tensor
    inc_edges: torch.Tensor
    inc_sign: torch.Tensor
    tris: torch.Tensor
    tri_valid: torch.Tensor
    kf_pyrs: torch.Tensor
    kf_q: torch.Tensor
    kf_t: torch.Tensor
    kf_valid: torch.Tensor
    kf_ids: torch.Tensor
    prev_q: torch.Tensor
    prev_t: torch.Tensor
    last_idmap: torch.Tensor
    last_planes: torch.Tensor
    cell_err: torch.Tensor
    topo_frame_id: torch.Tensor


def init_state(params, cam: Pinhole, device) -> State:
    eng = params.engine
    N, E, T, K = (eng.max_features, eng.max_edges, eng.max_triangles,
                  eng.max_keyframes)
    D = eng.max_vertex_degree
    H, W = cam.height, cam.width
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, val, dtype=f32):
        return torch.full(shape, val, dtype=dtype, device=device)

    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f32, device=device)
    feat = ep_ops.FeatureFilterState(
        uv_ref=z((N, 2)), kf_idx=z((N,), i32), mu=full((N,), 0.5),
        var=full((N,), eng.init_idepth_var), dropouts=z((N,), i32),
        valid=z((N,), torch.bool), frame_id=z((N,), i32))
    ws = params.features.detection.win_size
    return State(
        feat=feat, vtx_uv=z((N, 2)), vtx_x=full((N,), 0.5),
        vtx_w=z((N, 2)), vtx_z=full((N,), 0.5),
        vtx_in_graph=z((N,), torch.bool), edge_q=z((E, 3)),
        edges=z((E, 2), i32), edge_valid=z((E,), torch.bool),
        inc_edges=z((N, D), i32), inc_sign=z((N, D)),
        tris=z((T, 3), i32), tri_valid=z((T,), torch.bool),
        kf_pyrs=z((K, NUM_LEVELS, H, W)), kf_q=ident.repeat(K, 1),
        kf_t=z((K, 3)), kf_valid=z((K,), torch.bool),
        kf_ids=full((K,), -1, i32), prev_q=ident.clone(), prev_t=z((3,)),
        last_idmap=full((H, W), -1, i32), last_planes=z((T, 3)),
        cell_err=z((H // ws, W // ws)),
        topo_frame_id=torch.tensor(NO_WATERMARK, dtype=i32, device=device))


def _masked_median(vals, mask, fallback: float):
    big = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    s = torch.sort(big).values
    n = torch.sum(mask.to(torch.int64))
    med = s[torch.clamp(n // 2, 0, vals.shape[0] - 1)]
    return torch.where(n > 0, med, torch.full_like(med, fallback))


def _set_row(t, idx, val):
    out = t.clone()
    if isinstance(val, torch.Tensor):
        out[idx] = val
    else:
        out[idx].fill_(val)
    return out


def track_step(state: State, img_pyr, cur_q, cur_t, frame_id, kf_slot: int,
               is_poseframe: bool, *, cam: Pinhole, params):
    """Epipolar update, graph and feature projection, and on a poseframe
    the keyframe-ring insert with re-anchor, detection and slot
    allocation. Returns (state, counts [7])."""
    eng = params.engine
    det = params.features.detection
    reg = params.regularization.nltgv2
    trk = params.features.tracking
    dev = img_pyr.device
    f32 = torch.float32

    res = ep_ops.epipolar_update(
        state.feat, state.kf_pyrs, state.kf_q, state.kf_t, img_pyr, cur_q,
        cur_t, cam=cam, num_samples=eng.num_search_samples,
        patch_size=trk.win_size, num_levels=NUM_LEVELS,
        sigma_window=eng.sigma_window, idepth_min=eng.idepth_min,
        idepth_max=eng.idepth_max, epipolar_line_var=trk.epipolar_line_var,
        min_ref_patch_grad=eng.min_ref_patch_grad,
        ambiguous_match_ratio=eng.ambiguous_match_ratio,
        max_cost=eng.max_cost, max_dropouts=trk.max_dropouts,
        max_idepth_var=trk.max_idepth_var,
        mode=eng.epipolar_mode, zero_mean_ssd=eng.zero_mean_ssd)
    feat = res.state

    uv_cur, z_cur, inb = ep_ops.project_features(
        feat, state.kf_q, state.kf_t, cur_q, cur_t, cam)
    # The last frame's smoothed vertex idepth carried into this frame.
    qc = quat_conj(cur_q)
    q_cp = quat_mul(qc, state.prev_q)
    t_cp = quat_rotate(qc, state.prev_t - cur_t)
    X_c = quat_rotate(q_cp[None, :], cam.ray(state.vtx_uv)) \
        / torch.clamp(state.vtx_x, min=1e-6)[:, None] + t_cp[None, :]
    x_proj = 1.0 / torch.clamp(X_c[..., 2], min=1e-6)
    graph_ok = state.vtx_in_graph & (X_c[..., 2] > 1e-6)
    vtx_x = torch.where(graph_ok, x_proj, z_cur)
    vtx_uv = uv_cur
    counts = res.counts

    kf_pyrs, kf_q, kf_t = state.kf_pyrs, state.kf_q, state.kf_t
    kf_valid, kf_ids = state.kf_valid, state.kf_ids
    if is_poseframe:
        doomed = (feat.valid & (feat.kf_idx == kf_slot)
                  & state.kf_valid[kf_slot])
        if eng.reanchor_on_evict:
            K = state.kf_q.shape[0]
            others = torch.arange(K, device=dev) != kf_slot
            ids_masked = torch.where(state.kf_valid & others, state.kf_ids,
                                     torch.full_like(state.kf_ids, -1))
            j_new = torch.argmax(ids_masked)
            has_target = ids_masked[j_new] >= 0
            qA, tA = state.kf_q[kf_slot], state.kf_t[kf_slot]
            qB, tB = state.kf_q[j_new], state.kf_t[j_new]
            X_A = cam.backproject(feat.uv_ref,
                                  torch.clamp(feat.mu, min=eng.idepth_min))
            X_w = quat_rotate(qA[None, :], X_A) + tA[None, :]
            X_B = quat_rotate(quat_conj(qB)[None, :], X_w - tB[None, :])
            z_B = X_B[..., 2]
            zs = torch.where(z_B > 1e-6, z_B, torch.ones_like(z_B))
            u_B = cam.fx * X_B[..., 0] / zs + cam.cx
            v_B = cam.fy * X_B[..., 1] / zs + cam.cy
            mu_B = 1.0 / zs
            pad = 4.0
            ok = (has_target & (z_B > 1e-6)
                  & (u_B >= pad) & (u_B <= cam.width - 1 - pad)
                  & (v_B >= pad) & (v_B <= cam.height - 1 - pad)
                  & (mu_B >= eng.idepth_min) & (mu_B <= eng.idepth_max))
            move = doomed & ok & (feat.var < reg.idepth_var_max)
            ratio = mu_B / torch.clamp(feat.mu, min=1e-6)
            var_B = feat.var * torch.square(ratio) * 2.0
            feat = feat._replace(
                uv_ref=torch.where(move[:, None],
                                   torch.stack([u_B, v_B], -1),
                                   feat.uv_ref),
                kf_idx=torch.where(move, j_new.to(torch.int32),
                                   feat.kf_idx),
                mu=torch.where(move, mu_B, feat.mu),
                var=torch.where(move, var_B, feat.var),
                dropouts=torch.where(move, 0, feat.dropouts),
                valid=feat.valid & ~(doomed & ~move))
        else:
            feat = feat._replace(valid=feat.valid & ~doomed)
        kf_pyrs = _set_row(state.kf_pyrs, kf_slot, img_pyr)
        kf_q = _set_row(state.kf_q, kf_slot, cur_q)
        kf_t = _set_row(state.kf_t, kf_slot, cur_t)
        kf_valid = _set_row(state.kf_valid, kf_slot, True)
        kf_ids = _set_row(state.kf_ids, kf_slot, frame_id)

        occ = occupancy_from_features(uv_cur, feat.valid & inb,
                                      cam.height, cam.width, det.win_size)
        occ = occ & ~(state.cell_err > det.min_error)
        duv, _, dvalid = detect_features(
            img_pyr[0], occ, win_size=det.win_size,
            min_grad_mag=det.min_grad_mag,
            do_letterbox=params.features.do_letterbox)

        N = feat.valid.shape[0]
        free = ~feat.valid
        det_rank = torch.cumsum(dvalid.to(torch.int64), 0) - 1
        n_free = torch.sum(free.to(torch.int64))
        take = dvalid & (det_rank < n_free)
        med = _masked_median(
            feat.mu, feat.valid & (feat.var < reg.idepth_var_max),
            eng.init_idepth)
        pred, pok = raster_ops.sample_idepth_at(
            state.last_idmap, state.last_planes, duv)
        use_pred = pok & torch.isfinite(pred) & (pred > eng.idepth_min)
        if not reg.init_with_prediction:
            use_pred = torch.zeros_like(use_pred)
        mu0 = torch.where(use_pred, torch.nan_to_num(pred, nan=0.5), med)
        var0 = torch.where(use_pred,
                           torch.full_like(pred, eng.init_idepth_var * 0.5),
                           torch.full_like(pred, eng.init_idepth_var))
        free_slots = torch.argsort((~free).to(torch.int8), stable=True)
        slot = free_slots[torch.clamp(det_rank, 0, N - 1)]
        target = torch.where(take, slot, N)
        vals = torch.stack([duv[:, 0], duv[:, 1], mu0, var0], -1)
        got = torch.zeros((N + 1, 4), dtype=f32,
                          device=dev).index_copy(0, target, vals)
        hit = torch.zeros(N + 1, dtype=torch.bool,
                          device=dev).index_fill(0, target, True)
        got, hit = got[:N], hit[:N]
        feat = feat._replace(
            uv_ref=torch.where(hit[:, None], got[:, :2], feat.uv_ref),
            kf_idx=torch.where(hit, kf_slot, feat.kf_idx),
            mu=torch.where(hit, got[:, 2], feat.mu),
            var=torch.where(hit, got[:, 3], feat.var),
            dropouts=torch.where(hit, 0, feat.dropouts),
            valid=feat.valid | hit,
            frame_id=torch.where(hit, frame_id, feat.frame_id))
        n_detected = torch.sum(take.to(torch.int32))
        vtx_uv = torch.where(hit[:, None], got[:, :2], vtx_uv)
        vtx_x = torch.where(hit, got[:, 2], vtx_x)
        uv_cur, z_cur, inb = ep_ops.project_features(
            feat, kf_q, kf_t, cur_q, cur_t, cam)
        vtx_uv = torch.where(feat.valid[:, None], uv_cur, vtx_uv)
    else:
        n_detected = torch.zeros((), dtype=torch.int32, device=dev)

    X_cur_cam = cam.backproject(uv_cur, torch.clamp(z_cur, min=1e-6))
    X_w = quat_rotate(cur_q[None, :], X_cur_cam) + cur_t[None, :]
    height = -X_w[..., 1]
    height_ok = (height >= reg.min_height) & (height <= reg.max_height)
    in_graph = (feat.valid & inb & height_ok
                & (feat.var <= reg.idepth_var_max))

    new_state = state._replace(
        feat=feat, vtx_uv=vtx_uv, vtx_x=vtx_x, vtx_z=z_cur,
        vtx_in_graph=in_graph, kf_pyrs=kf_pyrs, kf_q=kf_q, kf_t=kf_t,
        kf_valid=kf_valid, kf_ids=kf_ids, prev_q=cur_q, prev_t=cur_t)
    counts_vec = torch.stack([c.to(f32) for c in (
        counts["num_idepth_updates"], counts["num_fail_ref_patch_grad"],
        counts["num_fail_ambiguous_match"], counts["num_fail_max_cost"],
        counts["num_fail_max_dropouts"], counts["num_fail_max_var"],
        n_detected)])
    return new_state, counts_vec


def smooth_step(state: State, img_pyr, cur_q, cur_t, track_counts, *,
                cam: Pinhole, params):
    """NLTGV2 sweeps over the installed graph (stale triangles and edges
    masked), the configured graph filters, the raster, photometric
    telemetry and the stats vector. Returns (state, dense idepth map
    [H, W], stats [len(STATS_KEYS)])."""
    reg = params.regularization
    nl = reg.nltgv2
    eng = params.engine
    dev = state.vtx_x.device
    f32 = torch.float32
    if eng.nltgv2_adjoint != "gather":
        raise ValueError("the reference has the gather adjoint only")
    v_same = state.feat.frame_id <= state.topo_frame_id
    tri_fresh = state.tri_valid & v_same[state.tris.long()].all(-1)
    edge_fresh = state.edge_valid & v_same[state.edges.long()].all(-1)
    lam = reg_ops.data_weights(
        state.feat.var, state.vtx_in_graph, data_factor=nl.data_factor,
        adaptive=nl.adaptive_data_weights, rescale=nl.rescale_data)
    vtx_x, vtx_w, edge_q = state.vtx_x, state.vtx_w, state.edge_q
    costs = {}
    if reg.do_nltgv2:
        top = reg_ops.build_topology(state.edges, edge_fresh, state.vtx_uv,
                                     inc_edges=state.inc_edges,
                                     inc_sign=state.inc_sign)
        gs = reg_ops.GraphState(x=vtx_x, w=vtx_w, q=edge_q, x_bar=vtx_x,
                                w_bar=vtx_w)
        gs = reg_ops.pd_iterate(
            gs, top, state.vtx_z, lam, state.vtx_in_graph, None,
            num_iters=eng.pd_iters_per_frame, theta=nl.theta,
            gate_tol=eng.pd_gate_tol)
        costs = reg_ops.nltgv2_costs(gs, top, state.vtx_z, lam,
                                     state.vtx_in_graph)
        vtx_x, vtx_w, edge_q = gs.x, gs.w, gs.q
    else:
        vtx_x = torch.where(state.vtx_in_graph, state.vtx_z, vtx_x)

    if reg.do_median_filter:
        vtx_x = reg_ops.graph_median(vtx_x, state.inc_edges, state.inc_sign,
                                     state.edges, state.vtx_in_graph)
    if reg.do_lowpass_filter:
        vtx_x = reg_ops.graph_lowpass(vtx_x, state.inc_edges,
                                      state.inc_sign, state.edges,
                                      edge_fresh, state.vtx_in_graph)
    if nl.check_sticky_obstacles:
        sticky = (state.vtx_in_graph & (vtx_x > 0.5)
                  & (vtx_x > 2.0 * torch.clamp(state.vtx_z, min=1e-6)))
        vtx_x = torch.where(sticky, state.vtx_z, vtx_x)

    idmap, planes = raster_ops.rasterize_ids(
        state.vtx_uv, vtx_x, state.tris, tri_fresh, height=cam.height,
        width=cam.width)
    cov = torch.mean((idmap >= 0).to(f32))
    idepth_map = raster_ops.idepth_from_ids(idmap, planes)

    # Photometric error against the newest keyframe on a strided grid.
    ps = max(int(eng.photo_stride), 1)
    kf_slot = torch.argmax(state.kf_ids)
    hs, ws = cam.height // ps, cam.width // ps
    u = (torch.arange(ws, dtype=f32, device=dev) * float(ps))[None, :] \
        .expand(hs, ws)
    v = (torch.arange(hs, dtype=f32, device=dev) * float(ps))[:, None] \
        .expand(hs, ws)
    sidx = (v * cam.width + u).to(torch.int64)
    ids_s = idmap.reshape(-1)[sidx]
    g_s = planes[ids_s.clamp(min=0).long()]
    xi = g_s[..., 0] + g_s[..., 1] * u + g_s[..., 2] * v
    xi = torch.where(ids_s >= 0, xi, torch.zeros_like(xi))
    img_s = img_pyr[0].reshape(-1)[sidx]
    ok = (ids_s >= 0) & (xi > 1e-3)
    X = cam.backproject(torch.stack([u, v], -1), torch.clamp(xi, min=1e-3))
    q_kf = state.kf_q[kf_slot]
    q_kc = quat_mul(quat_conj(q_kf), cur_q)
    t_kc = quat_rotate(quat_conj(q_kf), cur_t - state.kf_t[kf_slot])
    X_kf = quat_rotate(q_kc[None, None, :], X) + t_kc[None, None, :]
    behind = X_kf[..., 2] <= 1e-6
    uv_kf = cam.project(torch.where(behind[..., None],
                                    ep_ops.unit_z_like(X_kf), X_kf))
    vals, samp_ok = bilinear(state.kf_pyrs[kf_slot, 0], uv_kf)
    perr = torch.abs(vals - img_s)
    pmask = ok & samp_ok & ~behind
    perr_m = torch.where(pmask, perr, torch.zeros_like(perr))
    total_photo = float(ps * ps) * torch.sum(perr_m)
    n_photo = torch.clamp(torch.sum(pmask.to(f32)), min=1.0)

    dw = params.features.detection.win_size
    nCy, nCx = cam.height // dw, cam.width // dw
    if dw % ps:
        raise ValueError("the reference needs photo_stride to divide the "
                         "detection cell")
    s2 = dw // ps
    e_c = perr_m[:nCy * s2, :nCx * s2].reshape(nCy, s2, nCx, s2).sum((1, 3))
    m_c = pmask[:nCy * s2, :nCx * s2].to(f32).reshape(
        nCy, s2, nCx, s2).sum((1, 3))
    cell_err = e_c / torch.clamp(m_c, min=1.0)

    health = (torch.isfinite(vtx_x).all()
              & torch.isfinite(state.feat.mu).all()
              & torch.isfinite(state.feat.var).all()
              & torch.isfinite(cur_q).all()
              & torch.isfinite(cur_t).all()).to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)

    def nsum(m):
        return torch.sum(m.to(f32))

    stats = torch.stack([
        nsum(state.feat.valid), nsum(state.vtx_in_graph),
        nsum(state.tri_valid), nsum(state.edge_valid), cov,
        *track_counts.unbind(0),
        costs.get("nltgv2_total_smoothness_cost", zero),
        costs.get("nltgv2_avg_smoothness_cost", zero),
        costs.get("nltgv2_total_data_cost", zero),
        costs.get("nltgv2_avg_data_cost", zero),
        total_photo, total_photo / n_photo,
        *([zero - 1.0] * 6), health])
    new_state = state._replace(vtx_x=vtx_x, vtx_w=vtx_w, edge_q=edge_q,
                               last_idmap=idmap, last_planes=planes,
                               cell_err=cell_err)
    return new_state, idepth_map, stats


def build_topology(params, uv: np.ndarray, eligible: np.ndarray,
                   watermark: int):
    """Delaunay of the eligible vertices on the host, padded to the
    capacities: (tris [T, 3], tri_valid [T], edges [E, 2], edge_valid [E],
    inc_edges [N, D], inc_sign [N, D]) as numpy arrays, and the
    watermark."""
    idx = np.flatnonzero(eligible)
    eng = params.engine
    N, E, T = eng.max_features, eng.max_edges, eng.max_triangles
    tris_pad = np.zeros((T, 3), np.int32)
    tv = np.zeros(T, bool)
    edges_pad = np.zeros((E, 2), np.int32)
    ev = np.zeros(E, bool)
    if len(idx) >= 3:
        tris_local = triangulate(uv[idx])
        edges_local = edges_from_triangles(tris_local)
        tris_g = idx[tris_local][:T]
        edges_g = idx[edges_local][:E]
        # Sorted by ymin, as the port installs them.
        if len(tris_g):
            ymin = uv[tris_g, 1].min(axis=1)
            tris_g = tris_g[np.argsort(ymin, kind="stable")]
        tris_pad[:len(tris_g)] = tris_g
        tv[:len(tris_g)] = True
        edges_pad[:len(edges_g)] = edges_g
        ev[:len(edges_g)] = True
    inc_e, inc_s, keep = reg_ops.build_incidence(
        edges_pad, ev, N, eng.max_vertex_degree)
    ev &= keep
    return tris_pad, tv, edges_pad, ev, inc_e, inc_s.astype(np.int32)


class Stream:
    """One camera stream advanced frame by frame as the runner's
    synchronous schedule does: the step, then on a poseframe the
    Delaunay of the step's vertex positions, installed for the next
    frame with the duals reset."""

    def __init__(self, params_dict: dict, cam: Pinhole, device):
        self.params = params_from_dict(params_dict)
        if self.params.engine.compute_dtype != "float32":
            raise ValueError(
                "the reference computes in float32 only; a configuration "
                f"stating {self.params.engine.compute_dtype!r} has no "
                "reference here")
        self.cam = cam
        self.device = torch.device(device)
        self.state = init_state(self.params, cam, self.device)

    def step(self, gray_u8: np.ndarray, q: np.ndarray, t: np.ndarray,
             frame_id: int, is_pf: bool, kf_slot: int, watermark: int):
        """Returns (stats [len(STATS_KEYS)], dense idepth map [H, W]) as
        tensors on the stream's device."""
        dev = self.device
        img = torch.from_numpy(np.ascontiguousarray(gray_u8)).to(dev)
        meta = torch.tensor(np.concatenate([q, t, [frame_id]]).astype(
            np.float32), device=dev)
        cur_q, cur_t = meta[:4], meta[4:7]
        fid = meta[7].to(torch.int32)
        img_pyr = build_pyramid(img.to(torch.float32), NUM_LEVELS)
        st, counts = track_step(self.state, img_pyr, cur_q, cur_t, fid,
                                kf_slot, is_pf, cam=self.cam,
                                params=self.params)
        st, idepth, stats = smooth_step(st, img_pyr, cur_q, cur_t, counts,
                                        cam=self.cam, params=self.params)
        if is_pf:
            N = self.params.engine.max_features
            uv = st.vtx_uv.cpu().numpy().reshape(N, 2)
            elig = st.vtx_in_graph.cpu().numpy()
            tris, tv, edges, ev, inc_e, inc_s = build_topology(
                self.params, uv, elig, watermark)

            def up(a, dtype=None):
                x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                return x if dtype is None else x.to(dtype)
            st = st._replace(
                tris=up(tris), tri_valid=up(tv), edges=up(edges),
                edge_valid=up(ev), inc_edges=up(inc_e),
                inc_sign=up(inc_s, torch.float32),
                topo_frame_id=torch.tensor(watermark, dtype=torch.int32,
                                           device=dev),
                edge_q=torch.zeros_like(st.edge_q))
        self.state = st
        return stats, idepth
