"""Debug-rate per-stage timing profiler.

Counterpart of `flame_ros_tpu/utils/stage_profiler.py`. The engine runs
a frame as a few large steps (`_track_step`, the host Delaunay,
`_smooth_step`), so the reference's per-stage timings
(msg/FlameStats.msg:31-46, stage scopes at src/flame_nodelet.cc:533-610)
are not observable on the product path. This module recovers them on
demand: every stage is re-run standalone against the engine's current
state and timed, and the times are written into the engine's
StatsTracker. The engine's steps are out of place, so re-running them
leaves its state as it was.

On the card each stage is timed with CUDA events around the call (the
card's time for the stage's work, launches included); on the CPU with
the host clock. Each stage runs once untimed first and is then timed
`iters` times; the least time is kept. The stage times are an upper bound
per stage: the product path runs them back to back.

Enabled by `debug.profile_stages` (every `debug.profile_stages_every`
frames) or `offline_runner --profile-stages`. It costs host syncs, so it
is off unless asked for.
"""
from __future__ import annotations

import time

import torch

# The stages profile_stages measures: the reference's stage-timing
# vocabulary but for "update" (the whole frame, timed by the engine
# itself) and "update_locking" (the engine's wait for a frame's upload).
STAGES = ("frame_creation", "update_idepths", "project_features",
          "project_graph", "keyframe", "detection", "detection_loop",
          "interpolate", "sync_graph", "median_filter", "lowpass_filter",
          "triangulate")


def _time_ms(fn, device: torch.device, iters: int = 2) -> float:
    """ms per call of fn, the least of `iters` timed calls after one
    untimed call: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def _keyframe_insert(state, img_pyr, cur_q, cur_t, kf_slot: int):
    """The keyframe-ring insert piece of the poseframe branch."""
    from flame_ros_torch.models.engine import _set_row
    evict = (state.feat.valid & (state.feat.kf_idx == kf_slot)
             & state.kf_valid[kf_slot])
    feat = state.feat._replace(valid=state.feat.valid & ~evict)
    return state._replace(
        feat=feat, kf_pyrs=_set_row(state.kf_pyrs, kf_slot, img_pyr),
        kf_q=_set_row(state.kf_q, kf_slot, cur_q),
        kf_t=_set_row(state.kf_t, kf_slot, cur_t),
        kf_valid=_set_row(state.kf_valid, kf_slot, True))


def _alloc(feat_valid, dvalid, duv):
    """The detection -> free-slot allocation scatter (the reference's
    detection_loop: iterating detections into the feature set)."""
    N = feat_valid.shape[0]
    order = torch.argsort(feat_valid.to(torch.int8), stable=True)
    det_rank = torch.cumsum(dvalid.to(torch.int64), 0) - 1
    n_free = torch.sum((~feat_valid).to(torch.int64))
    take = dvalid & (det_rank < n_free)
    slot = order[torch.clamp(det_rank, 0, N - 1)]
    tgt = torch.where(take, slot, N)                  # row N is a dummy
    uv_ref = torch.zeros((N + 1, 2), dtype=torch.float32,
                         device=feat_valid.device)
    return uv_ref.index_copy(0, tgt, duv)[:N], take


def profile_stages(engine, img_gray, pose) -> dict:
    """Time each stage of STAGES against `engine`'s current state with
    (img_gray, pose) as the current frame. Returns {stage: ms} and writes
    each into engine.stats_ (set_timing). A disabled filter stage reads
    0."""
    from flame_ros_torch.models.engine import (NUM_LEVELS, _host,
                                               _project_graph_core,
                                               _smooth_step)
    from flame_ros_torch.ops import epipolar as ep_ops
    from flame_ros_torch.ops import nltgv2 as reg_ops
    from flame_ros_torch.ops import raster as raster_ops
    from flame_ros_torch.ops.detection import (detect_features,
                                               occupancy_from_features)
    from flame_ros_torch.ops.pyramid import build_pyramid

    st = engine.state
    cam = engine.cam
    params = engine.params
    det = params.features.detection
    eng = params.engine
    reg = params.regularization
    dev = engine.device

    img = engine._on_device(img_gray)
    cur_q = engine._on_device(_host(pose.q).ravel())
    cur_t = engine._on_device(_host(pose.t).ravel())
    out = {}

    def rec(name, fn):
        out[name] = _time_ms(fn, dev) if fn is not None else 0.0
        engine.stats_.set_timing(name, out[name])

    rec("frame_creation", lambda: build_pyramid(img, NUM_LEVELS))
    img_pyr = build_pyramid(img, NUM_LEVELS)
    rec("update_idepths", lambda: ep_ops.epipolar_update(
        st.feat, st.kf_pyrs, st.kf_q, st.kf_t, img_pyr, cur_q, cur_t,
        cam=cam, num_samples=eng.num_search_samples,
        patch_size=params.features.tracking.win_size,
        num_levels=NUM_LEVELS).state.mu)
    rec("project_features", lambda: ep_ops.project_features(
        st.feat, st.kf_q, st.kf_t, cur_q, cur_t, cam))
    rec("project_graph", lambda: _project_graph_core(st, cur_q, cur_t, cam))
    rec("keyframe", lambda: _keyframe_insert(st, img_pyr, cur_q, cur_t,
                                             0).kf_valid)

    uv_cur, _, inb = ep_ops.project_features(st.feat, st.kf_q, st.kf_t,
                                             cur_q, cur_t, cam)
    occ = occupancy_from_features(uv_cur, st.feat.valid & inb, cam.height,
                                  cam.width, det.win_size)

    def detect():
        return detect_features(img_pyr[0], occ, win_size=det.win_size,
                               min_grad_mag=det.min_grad_mag,
                               do_letterbox=params.features.do_letterbox)

    rec("detection", detect)
    duv, _, dvalid = detect()
    rec("detection_loop", lambda: _alloc(st.feat.valid, dvalid, duv))
    # interpolate: the reference warm-starts a new frame from the
    # predicted dense map (msg/FlameStats.msg:33); here the plane sample
    # of the last rasterized map at the new detections.
    rec("interpolate", lambda: raster_ops.sample_idepth_at(
        st.last_idmap, st.last_planes, duv)[0])
    # sync_graph: the graph smoothing + raster step (_smooth_step).
    counts = torch.zeros((7,), dtype=torch.float32, device=dev)
    rec("sync_graph", lambda: _smooth_step(
        st, img_pyr, cur_q, cur_t, counts, None, cam=cam, params=params,
        has_gt=False)[2])
    rec("median_filter", (lambda: reg_ops.graph_median(
        st.vtx_x, st.inc_edges, st.inc_sign, st.edges, st.vtx_in_graph))
        if reg.do_median_filter else None)
    rec("lowpass_filter", (lambda: reg_ops.graph_lowpass(
        st.vtx_x, st.inc_edges, st.inc_sign, st.edges, st.edge_valid,
        st.vtx_in_graph)) if reg.do_lowpass_filter else None)

    # triangulate: the host Delaunay + incidence build (the engine also
    # times this live at poseframe rate); its inputs are read first.
    uv_h = st.vtx_uv.cpu().numpy()
    el_h = st.vtx_in_graph.cpu().numpy()
    t0 = time.perf_counter()
    engine._build_topology_host(uv_h, el_h)
    out["triangulate"] = (time.perf_counter() - t0) * 1e3
    engine.stats_.set_timing("triangulate", out["triangulate"])
    return out
