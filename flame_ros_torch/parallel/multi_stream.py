"""Many streams on one card: the engine step batched over a stream axis.

Counterpart of `flame_ros_tpu/parallel/multi_stream.py`. Every stream runs
the full algorithm (epipolar filtering, poseframe detection, host
Delaunay, NLTGV2 smoothing, rasterization); one call of
`batched_full_step` advances all of them. It is `torch.func.vmap` of the
single-stream step (pyramid -> `_track_step` -> `_smooth_step`) over a
leading stream dimension of the `EngineState`, so each stream computes
exactly what a single `Flame` computes for it. Under the vmap the raster
operator runs its batched rule (`ops/raster.py`): one launch of the
batched v4 kernel for all streams on the card.

Poseframes are aligned across streams (one cadence), so `is_pf` and the
keyframe slot are shared Python values and the step has no per-stream
control flow. Host triangulation stays per stream at poseframe rate, on a
thread pool, optionally deferred behind the next frames' compute.

Per frame the runner uploads one [S, H, W] uint8 batch and one
[S, META_COLS] f32 metadata batch (pinned, non-blocking); a poseframe
round makes one device-to-host copy of every stream's vertex snapshot and
one upload of the S packed topologies.

Not ported (ROADMAP "Do not port"): `make_mesh`, `state_shardings`,
`place` and `batched_full_step_spatial` (device meshes and the spatial
NLTGV2 partition), the multi-process (multi-controller) mode with its
per-process checkpoint shards and `local_streams`, and `get_meshes`'
f32 bit-packed transport (the integer leaves are read as int32 here,
with the same semantics past 2^24). A mesh other than None/"auto",
`engine.spatial_parts > 1` and a multi-process run raise `ValueError`.
"""
from __future__ import annotations

import os
import time as time_mod
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, META_COLS,
                                           NUM_LEVELS, EngineState, _host,
                                           _smooth_step, _track_step,
                                           _unpack_topology,
                                           build_topology_host, init_state,
                                           state_from_leaves, state_leaves)
from flame_ros_torch.ops.pyramid import build_pyramid
from flame_ros_torch.utils.device import resolve_device

# Deferred poseframe rounds in flight before a new one is dropped.
_MAX_TOPO_PENDING = 2
_NOT_PORTED = "is not ported (ROADMAP 'Do not port')"


def init_batched_state(num_streams: int, params: FlameParams, cam: Pinhole,
                       device) -> EngineState:
    """S copies of the initial engine state, stacked on a leading stream
    dimension."""
    one = init_state(params, cam, device)
    return state_from_leaves([
        x.unsqueeze(0).repeat(num_streams, *([1] * x.dim()))
        for x in state_leaves(one)])


def batched_frame_step(states: EngineState, img_pyrs, qs, ts, frame_ids, *,
                       cam: Pinhole, params: FlameParams):
    """One ordinary (non-poseframe) engine step for a batch of streams:
    epipolar filtering, graph projection, NLTGV2 sweeps and rasterization.
    img_pyrs [S, L, H, W], qs [S, 4], ts [S, 3], frame_ids [S] int32.
    Returns (states, dense idepth maps [S, H, W], coverage [S])."""
    cov_idx = DEVICE_STATS_KEYS.index("coverage")

    def one(state, img_pyr, q, t, fid):
        state, _, _, counts_vec, _ = _track_step(
            state, img_pyr, q, t, fid, 0, False, cam=cam, params=params)
        state, idepth, stats_vec = _smooth_step(
            state, img_pyr, q, t, counts_vec, None, cam=cam, params=params,
            dense_products=True)
        return state, idepth, stats_vec[cov_idx]

    return torch.func.vmap(one)(states, img_pyrs, qs, ts, frame_ids)


def batched_full_step(states: EngineState, imgs, meta, gt, *, cam: Pinhole,
                      params: FlameParams, is_pf: bool, kf_slot: int):
    """One full engine frame (track + smooth, the poseframe branch
    included) for a batch of streams. imgs [S, H, W] uint8; meta
    [S, META_COLS] f32 rows (quaternion, translation, frame id, ...); gt
    [S, H, W] GT depth or None. Returns (states, dense idepth maps
    [S, H, W], stats [S, len(DEVICE_STATS_KEYS)])."""
    has_gt = gt is not None

    def one(state, img, m, g):
        img_pyr = build_pyramid(img.to(torch.float32), NUM_LEVELS)
        cur_q, cur_t = m[:4], m[4:7]
        state, _, _, counts_vec, _ = _track_step(
            state, img_pyr, cur_q, cur_t, m[7].to(torch.int32), kf_slot,
            is_pf, cam=cam, params=params)
        return _smooth_step(state, img_pyr, cur_q, cur_t, counts_vec, g,
                            cam=cam, params=params, has_gt=has_gt,
                            dense_products=True)

    return torch.func.vmap(one, in_dims=(0, 0, 0, 0 if has_gt else None))(
        states, imgs, meta, gt)


def _batched_install(states: EngineState, bufs, *, T: int, E: int, N: int,
                     D: int) -> EngineState:
    """Install one packed topology per stream (bufs [S, L] int32 on the
    states' device), the duals reset."""
    def one(state, buf):
        tris, tv, edges, ev, inc_e, inc_s, wm = _unpack_topology(
            buf, T=T, E=E, N=N, D=D)
        return state._replace(
            tris=tris, tri_valid=tv, edges=edges, edge_valid=ev,
            inc_edges=inc_e, inc_sign=inc_s, topo_frame_id=wm,
            edge_q=torch.zeros_like(state.edge_q))

    return torch.func.vmap(one)(states, bufs)


class _HostTopologyBuilder:
    """Stateless per-stream topology build (Delaunay + incidence + pack),
    shared by the runner's worker pool."""

    def __init__(self, params: FlameParams):
        self.params = params

    def build(self, uv: np.ndarray, eligible: np.ndarray,
              watermark: int = 2 ** 30) -> np.ndarray:
        return build_topology_host(self.params, uv, eligible, watermark)


class MultiStreamRunner:
    """End-to-end S-stream orchestrator on one device: one batched engine
    dispatch advances all streams; per-stream host triangulation runs on a
    thread pool at poseframe rate.

    `update` takes one frame per stream; every
    input.poseframe_subsample_factor-th call is a poseframe for all
    streams. With deferred_triangulation the poseframe round's snapshot
    copy and S Delaunay builds run behind the next frames' dispatches;
    finished rounds install at the next `update`, in issue order, and a
    round that finds two still in flight is dropped (`topo_dropped`).
    Runs on the card unless `device` says otherwise."""

    def __init__(self, cam: Pinhole, num_streams: int,
                 params: Optional[FlameParams] = None, mesh=None,
                 deferred_triangulation: bool = False, device=None):
        if mesh is not None and mesh != "auto":
            # One card: "auto" selects the plain path, as in the JAX
            # package when its rule picks one device.
            raise ValueError(f"a device mesh {_NOT_PORTED}; pass None or "
                             f"'auto', got {mesh!r}")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise ValueError(f"the multi-process runner {_NOT_PORTED}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = (params or FlameParams()).resolved(self.device)
        eng = self.params.engine
        if eng.spatial_parts > 1:
            raise ValueError(f"engine.spatial_parts > 1 (the spatial NLTGV2 "
                             f"partition) {_NOT_PORTED}")
        if self.device.type == "cuda" and not (
                eng.use_pallas_raster and eng.pallas_raster_kernel == "v4"):
            raise ValueError("the batched step on the card needs the v4 "
                             "raster kernel (the only one with a batched "
                             "form)")
        self.cam = cam
        self.S = int(num_streams)
        self.deferred = deferred_triangulation
        self._pending_topo = deque()   # in-flight deferred rounds
        self.topo_dropped = 0          # rounds skipped under pressure
        self.states = init_batched_state(self.S, self.params, cam,
                                         self.device)
        self._num_poseframes = 0
        self._kf_slot = 0
        self._frame_count = 0
        self._max_frame_id = 0   # topology watermark (engine semantics)
        self._round_pool = None  # runs deferred rounds, one at a time
        self._build_pool = None  # the S Delaunay builds of a round
        # Host seconds of each poseframe round's S builds (telemetry).
        self.tri_round_s = []
        self.last_stats = None   # [S, len(DEVICE_STATS_KEYS)] device
        self.last_idepth = None  # [S, H, W] device

    # -- upload ----------------------------------------------------------
    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def update(self, frames, gt_depths=None) -> bool:
        """Advance every stream by one frame. frames: S tuples (time,
        img_id, pose: SE3, gray [H, W]); gt_depths: optional [S, H, W] GT
        depth (meters) folded into each stream's stats."""
        if len(frames) != self.S:
            raise ValueError(f"{len(frames)} frames for {self.S} streams")
        while self._pending_topo and self._pending_topo[0].done():
            self._install_topologies(self._pending_topo.popleft().result())
        pf_every = max(self.params.input.poseframe_subsample_factor, 1)
        is_pf = self._frame_count % pf_every == 0
        kf_slot = self._kf_slot
        if is_pf:
            self._num_poseframes += 1
            self._kf_slot = ((self._kf_slot + 1)
                             % self.params.engine.max_keyframes)
        H, W = self.cam.height, self.cam.width
        imgs = np.empty((self.S, H, W), np.uint8)
        meta = np.empty((self.S, META_COLS), np.float32)
        for s, (_, img_id, pose, gray) in enumerate(frames):
            self._max_frame_id = max(self._max_frame_id, int(img_id))
            g = _host(gray)
            imgs[s] = (g if g.dtype == np.uint8
                       else np.clip(g, 0, 255).astype(np.uint8))
            meta[s, :4] = _host(pose.q).ravel()
            meta[s, 4:7] = _host(pose.t).ravel()
            meta[s, 7:] = (img_id, 1.0 if is_pf else 0.0, kf_slot)
        gt = (None if gt_depths is None else self._to_device(
            torch.from_numpy(np.ascontiguousarray(
                _host(gt_depths), np.float32))))
        self.states, self.last_idepth, self.last_stats = batched_full_step(
            self.states, self._to_device(torch.from_numpy(imgs)),
            self._to_device(torch.from_numpy(meta)), gt, cam=self.cam,
            params=self.params, is_pf=is_pf, kf_slot=kf_slot)
        self._frame_count += 1
        if is_pf:
            self._poseframe_round()
        return True

    # -- host triangulation (poseframe rate) -----------------------------
    def _poseframe_round(self):
        """Triangulate every stream's vertex snapshot: now, or (deferred)
        on the round pool behind the next frames' compute. The watermark
        is taken here, at submit: a delayed round must not stamp its older
        snapshot with a newer frame id."""
        wm = self._max_frame_id
        if not self.deferred:
            self._install_topologies(self._build_topologies(
                self._snapshot(), None, wm))
            return
        if len(self._pending_topo) >= _MAX_TOPO_PENDING:
            self.topo_dropped += 1
            return
        snap = self._snapshot()
        copied = None
        if self.device.type == "cuda":
            host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
            host.copy_(snap, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            snap = host
        if self._round_pool is None:
            self._round_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="flame-ms-round")
        self._pending_topo.append(self._round_pool.submit(
            self._build_topologies, snap, copied, wm))

    def _snapshot(self) -> torch.Tensor:
        """[S, 3N] f32 (vertex positions, graph membership) on the
        device."""
        st = self.states
        return torch.cat([st.vtx_uv.reshape(self.S, -1),
                          st.vtx_in_graph.to(torch.float32)], 1)

    def _build_topologies(self, snap, copied, wm: int) -> torch.Tensor:
        """The S packed topologies [S, L] int32 of one round, built on the
        build pool from one host copy of the snapshot."""
        if copied is not None:
            copied.synchronize()
        buf = snap.cpu().numpy()
        N = self.params.engine.max_features
        uv = buf[:, :2 * N].reshape(self.S, N, 2)
        elig = buf[:, 2 * N:] > 0.5
        if self._build_pool is None:
            self._build_pool = ThreadPoolExecutor(
                max_workers=min(self.S, 8), thread_name_prefix="flame-ms-tri")
        builder = _HostTopologyBuilder(self.params)
        t0 = time_mod.perf_counter()
        built = list(self._build_pool.map(
            lambda s: builder.build(uv[s], elig[s], wm), range(self.S)))
        self.tri_round_s.append(time_mod.perf_counter() - t0)
        return torch.from_numpy(np.stack(built))

    def _install_topologies(self, bufs: torch.Tensor):
        e = self.params.engine
        self.states = _batched_install(
            self.states, self._to_device(bufs), T=e.max_triangles,
            E=e.max_edges, N=e.max_features, D=e.max_vertex_degree)

    def drain_topologies(self):
        """Block until every in-flight deferred round is installed (call
        before reading final meshes or maps)."""
        while self._pending_topo:
            self._install_topologies(self._pending_topo.popleft().result())

    # -- checkpoint / restart --------------------------------------------
    @staticmethod
    def _ckpt_file(path: str) -> str:
        return (path[:-4] if path.endswith(".npz") else path) + ".npz"

    def _caps(self) -> list:
        e = self.params.engine
        return [self.S, e.max_features, e.max_keyframes,
                e.max_vertex_degree, e.spatial_parts]

    def save_checkpoint(self, path: str) -> str:
        """Write the batched state and host counters to one NPZ in the JAX
        package's layout: leaf_i in `state_leaves` order with a leading
        stream dimension, `__host__` = [num_poseframes, kf_slot,
        frame_count, max_frame_id, topo_dropped], `__caps__` = [S,
        max_features, max_keyframes, max_vertex_degree, spatial_parts].
        In-flight rounds install first. The file is published atomically
        (a temporary name, fsync, rename). Returns the file's path."""
        self.drain_topologies()
        arrays = {f"leaf_{i}": x.detach().cpu().numpy()
                  for i, x in enumerate(state_leaves(self.states))}
        arrays["__host__"] = np.array(
            [self._num_poseframes, self._kf_slot, self._frame_count,
             self._max_frame_id, self.topo_dropped], np.int64)
        arrays["__caps__"] = np.array(self._caps(), np.int64)
        fn = self._ckpt_file(path)
        tmp = fn + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fn)
        return fn

    def load_checkpoint(self, path: str):
        """Restore a state written by `save_checkpoint` (here or by the JAX
        package's runner) into a runner with the same stream count and
        capacity params; rounds in flight for the replaced state are
        dropped."""
        data = np.load(self._ckpt_file(path))
        caps = data["__caps__"].tolist()
        if caps != self._caps():
            raise ValueError(
                f"checkpoint capacities {caps} != runner {self._caps()} — "
                f"construct the runner with the same params")
        leaves = []
        for i, old in enumerate(state_leaves(self.states)):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(old.shape):
                raise ValueError(f"checkpoint shape mismatch at leaf {i}: "
                                 f"{a.shape} vs {tuple(old.shape)}")
            leaves.append(torch.from_numpy(np.array(a, copy=True)).to(
                self.device, old.dtype))
        self.states = state_from_leaves(leaves)
        host = data["__host__"]
        self._num_poseframes = int(host[0])
        self._kf_slot = int(host[1])
        self._frame_count = int(host[2])
        self._max_frame_id = int(host[3])
        self.topo_dropped = int(host[4])
        self._pending_topo.clear()
        self.last_stats = None
        self.last_idepth = None

    def shutdown(self):
        """Stop the worker pools and abandon in-flight rounds
        (drain_topologies first if they must land). Safe to call twice;
        the pools restart on demand."""
        self._pending_topo.clear()
        for name in ("_round_pool", "_build_pool"):
            pool = getattr(self, name)
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
                setattr(self, name, None)

    # -- getters ---------------------------------------------------------
    def flush_stats(self) -> list:
        """One device-to-host copy: per-stream {key: value} stats of the
        last frame."""
        if self.last_stats is None:
            return []
        rows = self.last_stats.detach().cpu().numpy()
        return [dict(zip(DEVICE_STATS_KEYS, map(float, r))) for r in rows]

    def get_idepth_maps(self) -> np.ndarray:
        """The last frame's in-dispatch dense idepth maps [S, H, W] (NaN
        where uncovered)."""
        return self.last_idepth.detach().cpu().numpy()

    def get_meshes(self) -> list:
        """Per-stream compacted meshes, (uv [V, 2], idepth [V], tris
        [M, 3]), from two device-to-host copies (the float and the int32
        leaves). Triangles are gated on the stale-topology watermark, the
        single-stream getters' rule: a vertex slot re-detected after the
        installed triangulation (frame id > watermark) is a different
        feature, so triangles touching it are masked."""
        st = self.states
        S, N, T = self.S, st.vtx_x.shape[-1], st.tris.shape[-2]
        fl = torch.cat([st.vtx_uv.reshape(S, -1), st.vtx_x,
                        st.vtx_in_graph.to(torch.float32),
                        st.tri_valid.to(torch.float32)], 1).cpu().numpy()
        ints = torch.cat([st.tris.reshape(S, -1), st.feat.frame_id,
                          st.topo_frame_id[:, None]], 1).cpu().numpy()
        out = []
        for s in range(S):
            uv = fl[s, :2 * N].reshape(N, 2)
            x = fl[s, 2 * N:3 * N]
            g = fl[s, 3 * N:4 * N] > 0.5
            tvv = fl[s, 4 * N:] > 0.5
            tris = ints[s, :3 * T].reshape(T, 3)
            fid = ints[s, 3 * T:3 * T + N]
            v_same = fid <= ints[s, -1]
            tv = tvv & v_same[tris].all(-1)
            out.append((uv[g], x[g], tris[tv]))
        return out
