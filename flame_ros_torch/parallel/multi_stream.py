"""Many streams: the engine step batched over a stream axis, over one or
several devices, in one process or several.

Counterpart of `flame_ros_tpu/parallel/multi_stream.py`. Every stream runs
the full algorithm (epipolar filtering, poseframe detection, host
Delaunay, NLTGV2 smoothing, rasterization); one call of
`batched_full_step` advances a batch of streams. It is `torch.func.vmap`
of the single-stream step (pyramid -> `_track_step` -> `_smooth_step`)
over a leading stream dimension of the `EngineState`, so each stream
computes exactly what a single `Flame` computes for it. Under the vmap
the raster operator runs its batched rule (`ops/raster.py`): one launch
of the batched v4 kernel for the batch on its card.

Devices. The JAX package's `jax.sharding.Mesh` is an explicit list of
`torch.device`s here (`make_mesh`):

- a flat list `[d0, d1, ...]`: stream-parallel groups. Group g holds a
  contiguous block of S / groups streams, and that block's batched
  `EngineState` lives on d_g; a step runs `batched_full_step` once per
  group, each with its own raster launch on its own device. No stream
  talks to another, so the groups need no communication.
- a nested list `[[d00, d01], [d10, d11], ...]`: stream groups of parts
  (the JAX ("stream", "part") mesh). With `engine.spatial_parts` = the
  row width, the NLTGV2 sweep of each group runs over the spatial graph
  partition (`parallel/spatial_pd.py`): part p's arrays on d_gp, one
  halo exchange per sweep (`batched_full_step_spatial`). The group's
  engine state lives on its first device; the track step and the
  smooth tail run there.
- a `Mesh` with axes ("stream", "feat") (`make_mesh(devices,
  stream_axis=k)`: k stream groups of F = n / k devices): the JAX feat
  axis. Each group's lane leaves (feature filter, vertices, edges,
  incidence lists, triangles) live split into F blocks, block f on d_gf,
  the other leaves on d_g0 (`parallel/feat_shard.py`). The epipolar
  filter, the NLTGV2 sweeps and the cost sums run on the blocks, with an
  all-gather of the primals and of the per-edge adjoint terms every
  sweep; the rest runs on d_g0. The state equals the plain runner's bit
  for bit. A Mesh with F = 1 is a flat list.

A list may name one device several times: one card (or "cpu") then holds
a 2- or 4-way layout, which runs the same partition, halo and install
logic as distinct cards. A list mixing "cpu" and "cuda", or naming a card
that is not there, raises. `mesh="auto"` keeps the JAX rule: the first
gcd(S, n) of the n visible cards as stream groups; one card gives the
plain path.

Poseframes are aligned across streams (one cadence), so `is_pf` and the
keyframe slot are shared Python values and the step has no per-stream
control flow. The topology watermark (`topo_frame_id` of an install) is
one host value, the largest frame id any stream has dispatched, written
to every group. Host triangulation stays per stream at poseframe rate,
on a thread pool, optionally deferred behind the next frames' compute.

Multi-process mode (`torch.distributed` initialised with world size >
1, e.g. by `parallel/dist_e2e.py`): rank r owns a contiguous block of
S / world streams and runs the groups of its own device list (by default
one group on `cuda:(local_rank % device_count)`, so ranks share a card
when only one is visible). Every process passes the same global list of
S frames; a process uploads, steps, triangulates and reads back only its
own streams. The step needs no collective. Installs block at the next
`update` (one fixed point in every process, so no rank's result depends
on its threads' timing), and checkpoints are per process,
`<path>.p<rank>.npz` with the stream rows it holds in `__rows__`.

Per frame a group uploads one [S_g, H, W] uint8 batch and one
[S_g, META_COLS] f32 metadata batch (pinned, non-blocking); a poseframe
round makes one device-to-host copy of each group's vertex snapshot and
one upload of the group's packed topologies (and partitions).

`get_meshes` reads the integer leaves as int32 (the JAX package packs
them into f32 bits for its transport; the semantics past 2^24 are the
same).
"""
from __future__ import annotations

import math
import os
import time as time_mod
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.models.engine import (DEVICE_STATS_KEYS, META_COLS,
                                           NUM_LEVELS, EngineState, _host,
                                           _smooth_finish, _smooth_pd_setup,
                                           _smooth_step, _track_step,
                                           _unpack_topology,
                                           build_topology_host, init_state,
                                           state_from_leaves, state_leaves)
from flame_ros_torch.ops import nltgv2 as reg_ops
from flame_ros_torch.ops import raster_cuda
from flame_ros_torch.ops.pyramid import build_pyramid
from flame_ros_torch.parallel import feat_shard, spatial_pd
from flame_ros_torch.utils.device import resolve_device, resolve_devices

# Deferred poseframe rounds in flight before a new one is dropped.
_MAX_TOPO_PENDING = 2


class Mesh:
    """A device grid with named axes (the JAX package's
    `jax.sharding.Mesh`): devices[i][j] is the device at index i of
    axis_names[0] ("stream") and j of axis_names[1] ("feat")."""

    def __init__(self, devices, axis_names=("stream", "feat")):
        self.devices = [list(r) for r in devices]
        self.axis_names = tuple(axis_names)
        if len({len(r) for r in self.devices}) != 1:
            raise ValueError(f"mesh rows must have one width: {devices!r}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def __repr__(self):
        return f"Mesh({self.devices!r}, {self.axis_names!r})"


def make_mesh(devices=None, stream_axis: Optional[int] = None,
              parts: int = 1, auto_for_streams: Optional[int] = None):
    """A device layout for `MultiStreamRunner(mesh=...)`: a flat list of
    stream groups; with `parts` > 1 a nested [groups][parts] list
    (spatial partitioning); with `stream_axis=k` a ("stream", "feat")
    `Mesh` of k stream groups of n / k devices each (feature-axis
    sharding). devices: the visible cards when None.
    auto_for_streams=S: the JAX package's rule, pure stream groups over
    the first gcd(S, n) devices (every parts > 1 or feat > 1 layout is
    an explicit opt-in). Trailing devices that do not fill a part group
    are left out."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the "
                               "devices (e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = resolve_devices(devices)
    if auto_for_streams is not None:
        S = int(auto_for_streams)
        if S < 1:
            raise ValueError(f"auto_for_streams must be >= 1, got {S}")
        return devices[:math.gcd(S, len(devices))]
    if parts > 1:
        n = len(devices) // parts * parts
        if n == 0:
            raise ValueError(f"{len(devices)} devices for {parts} parts")
        return [devices[i:i + parts] for i in range(0, n, parts)]
    if stream_axis is not None:
        k = int(stream_axis)
        if k < 1 or len(devices) % k:
            raise ValueError(f"stream_axis {k} does not divide "
                             f"{len(devices)} devices")
        F = len(devices) // k
        return Mesh([devices[i * F:(i + 1) * F] for i in range(k)])
    return devices


def _split(n: int, groups: int) -> list:
    per = n // groups
    return [slice(g * per, (g + 1) * per) for g in range(groups)]


def place(states: EngineState, homes) -> list:
    """A stream-batched state split into contiguous stream blocks, block g
    on homes[g] (the port's `state_shardings` + `place`: each group holds
    its streams' whole state on one device)."""
    leaves = state_leaves(states)
    return [state_from_leaves([x[sl].to(d) for x in leaves])
            for sl, d in zip(_split(leaves[0].shape[0], len(homes)), homes)]


def init_batched_state(num_streams: int, params: FlameParams, cam: Pinhole,
                       device) -> EngineState:
    """S copies of the initial engine state, stacked on a leading stream
    dimension."""
    one = init_state(params, cam, device)
    return state_from_leaves([
        x.unsqueeze(0).repeat(num_streams, *([1] * x.dim()))
        for x in state_leaves(one)])


def batched_frame_step(states: EngineState, img_pyrs, qs, ts, frame_ids, *,
                       cam: Pinhole, params: FlameParams, mesh=None):
    """One ordinary (non-poseframe) engine step for a batch of streams:
    epipolar filtering, graph projection, NLTGV2 sweeps and rasterization.
    img_pyrs [S, L, H, W], qs [S, 4], ts [S, 3], frame_ids [S] int32.
    mesh: None, or a ("stream", "feat") `Mesh`: the streams split over
    its rows and each row's lanes over its devices (`feat_shard`); the
    inputs may lie on any device. Returns (states, dense idepth maps
    [S, H, W], coverage [S]), on the mesh's first device."""
    cov_idx = DEVICE_STATS_KEYS.index("coverage")
    if mesh is not None:
        return _feat_frame_step(states, img_pyrs, qs, ts, frame_ids,
                                cam=cam, params=params, mesh=mesh)

    def one(state, img_pyr, q, t, fid):
        state, _, _, counts_vec, _ = _track_step(
            state, img_pyr, q, t, fid, 0, False, cam=cam, params=params)
        state, idepth, stats_vec = _smooth_step(
            state, img_pyr, q, t, counts_vec, None, cam=cam, params=params,
            dense_products=True)
        return state, idepth, stats_vec[cov_idx]

    return torch.func.vmap(one)(states, img_pyrs, qs, ts, frame_ids)


def _feat_frame_step(states, img_pyrs, qs, ts, frame_ids, *, cam, params,
                     mesh):
    if not isinstance(mesh, Mesh) or mesh.axis_names != ("stream", "feat"):
        raise ValueError(f"a ('stream', 'feat') Mesh is needed; got {mesh!r}")
    rows = [resolve_devices(r) for r in mesh.devices]
    out = []
    for sl, devs in zip(_split(img_pyrs.shape[0], len(rows)), rows):
        group = feat_shard.LaneGroup(devs)
        fs = group.split(state_from_leaves(
            [x[sl] for x in state_leaves(states)]))
        fs, idepth, stats = feat_shard.feat_step(
            fs, group, *(x[sl].to(group.home) for x in (
                img_pyrs, qs, ts, frame_ids)), None, cam=cam,
            params=params, is_pf=False, kf_slot=0)
        out.append((group.join(fs), idepth,
                    stats[:, DEVICE_STATS_KEYS.index("coverage")]))
    home = rows[0][0]
    st = state_from_leaves([torch.cat([x.to(home) for x in xs]) for xs in
                            zip(*(state_leaves(o[0]) for o in out))])
    return (st, torch.cat([o[1].to(home) for o in out]),
            torch.cat([o[2].to(home) for o in out]))


def _track_one(state, img, m, *, cam, params, is_pf, kf_slot):
    img_pyr = build_pyramid(img.to(torch.float32), NUM_LEVELS)
    cur_q, cur_t = m[:4], m[4:7]
    state, _, _, counts_vec, _ = _track_step(
        state, img_pyr, cur_q, cur_t, m[7].to(torch.int32), kf_slot, is_pf,
        cam=cam, params=params)
    return state, img_pyr, cur_q, cur_t, counts_vec


def batched_full_step(states: EngineState, imgs, meta, gt, *, cam: Pinhole,
                      params: FlameParams, is_pf: bool, kf_slot: int):
    """One full engine frame (track + smooth, the poseframe branch
    included) for a batch of streams. imgs [S, H, W] uint8; meta
    [S, META_COLS] f32 rows (quaternion, translation, frame id, ...); gt
    [S, H, W] GT depth or None. Returns (states, dense idepth maps
    [S, H, W], stats [S, len(DEVICE_STATS_KEYS)])."""
    has_gt = gt is not None

    def one(state, img, m, g):
        state, img_pyr, cur_q, cur_t, counts_vec = _track_one(
            state, img, m, cam=cam, params=params, is_pf=is_pf,
            kf_slot=kf_slot)
        return _smooth_step(state, img_pyr, cur_q, cur_t, counts_vec, g,
                            cam=cam, params=params, has_gt=has_gt,
                            dense_products=True)

    return torch.func.vmap(one, in_dims=(0, 0, 0, 0 if has_gt else None))(
        states, imgs, meta, gt)


def batched_full_step_spatial(states: EngineState,
                              parts: spatial_pd.PlacedPartition, imgs, meta,
                              gt, *, cam: Pinhole, params: FlameParams,
                              is_pf: bool, kf_slot: int):
    """`batched_full_step` with the NLTGV2 sweep over the spatial graph
    partition: the track step and the smooth tail (raster, photometric
    telemetry, stats) run on the states' device; the sweep runs on the
    part devices of `parts` (built at topology install,
    `spatial_pd.place_partitions`) with one halo exchange per sweep. The
    layout conversions (global <-> partitioned) are gathers, two per
    frame each way. Same arguments and results as `batched_full_step`."""
    has_gt = gt is not None
    eng = params.engine
    nl = params.regularization.nltgv2
    home = states.vtx_x.device

    def track(state, img, m):
        state, img_pyr, cur_q, cur_t, counts = _track_one(
            state, img, m, cam=cam, params=params, is_pf=is_pf,
            kf_slot=kf_slot)
        tri_fresh, edge_fresh, lam = _smooth_pd_setup(state, params=params)
        return state, img_pyr, cur_q, cur_t, counts, tri_fresh, edge_fresh, \
            lam

    states, pyrs, qs, ts, counts, tri_fresh, edge_fresh, lam = \
        torch.func.vmap(track)(states, imgs, meta)

    # --- global -> partitioned: gathers on each part device -------------
    S = states.vtx_x.shape[0]
    xw = torch.cat([states.vtx_x[..., None], states.vtx_w], -1)
    ins = {k: [] for k in ("xw", "q", "el", "uv", "z", "lam", "vm")}
    for p, d in enumerate(parts.devices):
        rows = torch.arange(S, device=d)[:, None]
        o, gid, ev = parts.vtx_order[p], parts.edge_gid[p], parts.edge_valid[p]

        def take(a, idx):
            return a.to(d, non_blocking=True)[rows, idx]

        ins["xw"].append(take(xw, o))
        ins["uv"].append(take(states.vtx_uv, o))
        ins["z"].append(take(states.vtx_z, o))
        ins["lam"].append(take(lam, o))
        ins["vm"].append(take(states.vtx_in_graph, o))
        ins["q"].append(take(states.edge_q, gid)
                        * ev[..., None].to(xw.dtype))
        ins["el"].append(take(edge_fresh, gid) & ev)

    xw_p, q_p = spatial_pd.pd_iterate_spatial_batched(
        parts.devices, parts.part, ins["xw"], ins["q"], ins["el"], ins["uv"],
        ins["z"], ins["lam"], ins["vm"], num_iters=eng.pd_iters_per_frame,
        theta=nl.theta, gate_tol=eng.pd_gate_tol)

    # --- partitioned -> global: gathers on the states' device -----------
    rows = torch.arange(S, device=home)[:, None]
    xw_g = torch.cat([x.to(home, non_blocking=True) for x in xw_p],
                     1)[rows, parts.inv_vtx]
    q_all = torch.cat([x.to(home, non_blocking=True) for x in q_p]
                      + [torch.zeros((S, 1, 3), dtype=xw.dtype,
                                     device=home)], 1)
    edge_q = q_all[rows, parts.inv_edge]

    def finish(state, img_pyr, cur_q, cur_t, cv, g, x, w, q, tf, ef, lm):
        top = reg_ops.build_topology(state.edges, ef, state.vtx_uv,
                                     inc_edges=state.inc_edges,
                                     inc_sign=state.inc_sign)
        gs = reg_ops.GraphState(x=x, w=w, q=q, x_bar=x, w_bar=w)
        costs = reg_ops.nltgv2_costs(gs, top, state.vtx_z, lm,
                                     state.vtx_in_graph)
        return _smooth_finish(state, img_pyr, cur_q, cur_t, cv, g, x, w, q,
                              costs, tf, ef, cam=cam, params=params,
                              has_gt=has_gt, dense_products=True)

    dims = [0] * 12
    dims[5] = 0 if has_gt else None
    return torch.func.vmap(finish, in_dims=tuple(dims))(
        states, pyrs, qs, ts, counts, gt, xw_g[..., 0], xw_g[..., 1:],
        edge_q, tri_fresh, edge_fresh, lam)


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
    """Stateless per-stream topology build (Delaunay + incidence + pack,
    and the spatial partition of the installed edge set), shared by the
    runner's worker pool."""

    def __init__(self, params: FlameParams):
        self.params = params

    def build(self, uv: np.ndarray, eligible: np.ndarray,
              watermark: int = 2 ** 30) -> np.ndarray:
        return build_topology_host(self.params, uv, eligible, watermark)

    def partition(self, edges: np.ndarray, edge_valid: np.ndarray,
                  uv: np.ndarray, eligible: np.ndarray
                  ) -> spatial_pd.SpatialPartition:
        """The partition of an installed edge set, with the config's
        static budgets (every install the same shapes)."""
        e = self.params.engine
        return spatial_pd.build_spatial_partition(
            edges, edge_valid, uv, eligible, e.spatial_parts,
            halo_budget=e.spatial_halo_budget,
            edge_budget=e.spatial_edge_budget_resolved(),
            max_degree=e.max_vertex_degree)

    def packed_edges(self, packed: np.ndarray):
        """(edges [E, 2], edge_valid [E]) of a packed topology."""
        e = self.params.engine
        T, E = e.max_triangles, e.max_edges
        o = 4 * T
        return (packed[o:o + 2 * E].reshape(E, 2),
                packed[o + 2 * E:o + 3 * E] > 0)


def _dist_info():
    """(multi-process, rank, world size, local rank)."""
    d = torch.distributed
    if not (d.is_available() and d.is_initialized()
            and d.get_world_size() > 1):
        return False, 0, 1, 0
    rank = d.get_rank()
    return True, rank, d.get_world_size(), int(os.environ.get(
        "LOCAL_RANK", rank))


class MultiStreamRunner:
    """End-to-end S-stream orchestrator: one batched engine dispatch per
    stream group advances its streams; per-stream host triangulation runs
    on a thread pool at poseframe rate.

    `update` takes one frame per stream; every
    input.poseframe_subsample_factor-th call is a poseframe for all
    streams. With deferred_triangulation the poseframe round's snapshot
    copy and Delaunay builds run behind the next frames' dispatches;
    finished rounds install at the next `update`, in issue order, and a
    round that finds two still in flight is dropped (`topo_dropped`;
    in multi-process mode installs block instead, so none is dropped).

    mesh: None (the plain path on `device`), "auto", a flat device list
    (stream groups) or a nested one (stream groups of spatial parts); see
    the module docstring. Runs on the card unless `device` or the list
    says otherwise."""

    def __init__(self, cam: Pinhole, num_streams: int,
                 params: Optional[FlameParams] = None, mesh=None,
                 deferred_triangulation: bool = False, device=None):
        self.cam = cam
        self.S = int(num_streams)
        (self.multiprocess, self.rank, self.world,
         local_rank) = _dist_info()
        if self.S % self.world:
            raise ValueError(f"{self.S} streams for {self.world} processes")
        per = self.S // self.world
        self._local = list(range(self.rank * per, (self.rank + 1) * per))
        if self.multiprocess and mesh == "auto":
            mesh = None          # a rank holds its own card, not all of them
        if self.multiprocess and device is None and mesh is None:
            if not torch.cuda.is_available():
                resolve_device(None)        # raises: no card, no fallback
            device = torch.device(
                "cuda", local_rank % torch.cuda.device_count())
        groups, layout = self._layout(mesh, per, device)
        self.groups = groups
        self.device = groups[0][0]
        self.params = (params or FlameParams()).resolved(self.device)
        eng = self.params.engine
        sp = eng.spatial_parts
        self.spatial = bool(sp > 1 and layout == "part")
        # Feature-axis layout: each group's lanes over its devices.
        self.feat = layout == "feat" and len(groups[0]) > 1
        if self.feat:
            F = len(groups[0])
            for cap in (eng.max_features, eng.max_edges, eng.max_triangles):
                if cap % F:
                    raise ValueError(f"a feat axis of {F} does not divide "
                                     f"the lane capacity {cap}")
        self._lanes = [feat_shard.LaneGroup(g) if self.feat else None
                       for g in groups]
        if sp > 1 and not self.spatial:
            raise ValueError(
                "engine.spatial_parts > 1 requires a part layout: a nested "
                "device list [[...]] (make_mesh(parts=N))")
        if self.spatial and len(groups[0]) != sp:
            raise ValueError(f"part layout width {len(groups[0])} != "
                             f"engine.spatial_parts {sp}")
        if self.spatial:
            # Kept from the JAX runner: an operator must not configure an
            # unmeasured layout silently.
            warnings.warn(
                f"spatial_parts={sp} (num_streams={self.S}) has not been "
                "shown to pay on this card: no measurement of a parts > 1 "
                "layout beats pure stream groups (PERF.md §5, §6). "
                "mesh='auto' selects pure stream groups.", RuntimeWarning,
                stacklevel=2)
        if self.device.type == "cuda" and not (
                eng.use_pallas_raster and eng.pallas_raster_kernel == "v4"):
            raise ValueError("the batched step on the card needs the v4 "
                             "raster kernel (the only one with a batched "
                             "form)")
        self._rows = _split(per, len(groups))
        self.deferred = deferred_triangulation
        # Installs at every update() block in multi-process mode: one
        # fixed point in every process, whatever its threads' timing.
        self.blocking_installs = self.multiprocess
        self._pending_topo = deque()   # in-flight deferred rounds
        self.topo_dropped = 0          # rounds skipped under pressure
        self._gstates = [init_batched_state(sl.stop - sl.start, self.params,
                                            cam, g[0])
                         for sl, g in zip(self._rows, groups)]
        if self.feat:
            self._gstates = [lg.split(st) for lg, st in
                             zip(self._lanes, self._gstates)]
        self.parts = [None] * len(groups)   # PlacedPartition per group
        self._num_poseframes = 0
        self._kf_slot = 0
        self._frame_count = 0
        self._max_frame_id = 0   # topology watermark (engine semantics)
        self._round_pool = None  # runs deferred rounds, one at a time
        self._build_pool = None  # the Delaunay builds of a round
        # Host seconds of each poseframe round's builds (telemetry).
        self.tri_round_s = []
        # Batched raster launches made by each group's steps.
        self.group_launches = [0] * len(groups)
        self._last_stats = None   # per group [S_g, len(DEVICE_STATS_KEYS)]
        self._last_idepth = None  # per group [S_g, H, W]

    @staticmethod
    def _layout(mesh, n_streams: int, device):
        """(groups [[home, device 1, ...], ...], "plain" | "part" |
        "feat") of a mesh argument."""
        if mesh is None or mesh == "auto":
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if mesh == "auto" and dev.type == "cuda":
                flat = make_mesh(auto_for_streams=n_streams)
                if len(flat) > 1:
                    return [[d] for d in flat], "plain"
            return [[dev]], "plain"
        if isinstance(mesh, Mesh):
            if mesh.axis_names != ("stream", "feat"):
                raise ValueError(f"unknown mesh axes {mesh.axis_names}")
            kind, rows = "feat", mesh.devices
        elif isinstance(mesh, str) or not hasattr(mesh, "__iter__"):
            raise ValueError(f"mesh must be None, 'auto', a Mesh or a device "
                             f"list; got {mesh!r}")
        else:
            rows = list(mesh)
            kind = "part" if rows and all(
                isinstance(r, (list, tuple)) for r in rows) else "plain"
        rows = [list(r) for r in rows] if kind != "plain" else \
            [[d] for d in rows]
        if not rows or len({len(r) for r in rows}) != 1:
            raise ValueError(f"mesh rows must have one width: {mesh!r}")
        flat = resolve_devices([d for r in rows for d in r])
        w = len(rows[0])
        groups = [flat[i:i + w] for i in range(0, len(flat), w)]
        if device is not None and torch.device(device).type != \
                flat[0].type:
            raise ValueError(f"device {device!r} and mesh {mesh!r} differ "
                             "in kind")
        if n_streams % len(groups):
            raise ValueError(f"{n_streams} streams do not split over "
                             f"{len(groups)} stream groups")
        return groups, kind

    # -- the stream-batched state ----------------------------------------
    def _group_states(self) -> list:
        """Each group's batched state, whole on its home device (the lane
        blocks of the feature-axis layout joined)."""
        if not self.feat:
            return list(self._gstates)
        return [lg.join(fs) for lg, fs in zip(self._lanes, self._gstates)]

    def _set_group_state(self, g: int, st: EngineState):
        self._gstates[g] = self._lanes[g].split(st) if self.feat else st

    @property
    def states(self) -> EngineState:
        """This process's streams' state, [S_local, ...] on the first
        group's device (the groups' blocks concatenated)."""
        sts = self._group_states()
        if len(sts) == 1:
            return sts[0]
        return state_from_leaves([
            torch.cat([x.to(self.device) for x in xs]) for xs in
            zip(*(state_leaves(s) for s in sts))])

    @states.setter
    def states(self, value: EngineState):
        sts = ([value] if len(self.groups) == 1 else
               place(value, [g[0] for g in self.groups]))
        for g, st in enumerate(sts):
            self._set_group_state(g, st)

    @property
    def last_stats(self):
        if self._last_stats is None:
            return None
        return torch.cat([s.to(self.device) for s in self._last_stats])

    @property
    def last_idepth(self):
        if self._last_idepth is None:
            return None
        return torch.cat([s.to(self.device) for s in self._last_idepth])

    def local_streams(self) -> list:
        """Global ids of the streams this process holds (all of them in
        one process)."""
        return list(self._local)

    # -- upload ----------------------------------------------------------
    def _to_device(self, t: torch.Tensor, dev) -> torch.Tensor:
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def _install_ready(self):
        if self.blocking_installs:
            while self._pending_topo:
                self._install_topologies(self._pending_topo.popleft().result())
        else:
            while self._pending_topo and self._pending_topo[0].done():
                self._install_topologies(self._pending_topo.popleft().result())

    def update(self, frames, gt_depths=None) -> bool:
        """Advance every stream by one frame. frames: S tuples (time,
        img_id, pose: SE3, gray [H, W]), the same global list in every
        process; gt_depths: optional [S, H, W] GT depth (meters) folded
        into each stream's stats."""
        if len(frames) != self.S:
            raise ValueError(f"{len(frames)} frames for {self.S} streams")
        self._install_ready()
        pf_every = max(self.params.input.poseframe_subsample_factor, 1)
        is_pf = self._frame_count % pf_every == 0
        kf_slot = self._kf_slot
        if is_pf:
            self._num_poseframes += 1
            self._kf_slot = ((self._kf_slot + 1)
                             % self.params.engine.max_keyframes)
        for _, img_id, _, _ in frames:
            self._max_frame_id = max(self._max_frame_id, int(img_id))
        H, W = self.cam.height, self.cam.width
        n = len(self._local)
        imgs = np.empty((n, H, W), np.uint8)
        meta = np.empty((n, META_COLS), np.float32)
        for k, s in enumerate(self._local):
            _, img_id, pose, gray = frames[s]
            g = _host(gray)
            imgs[k] = (g if g.dtype == np.uint8
                       else np.clip(g, 0, 255).astype(np.uint8))
            meta[k, :4] = _host(pose.q).ravel()
            meta[k, 4:7] = _host(pose.t).ravel()
            meta[k, 7:] = (img_id, 1.0 if is_pf else 0.0, kf_slot)
        gt = (None if gt_depths is None else np.ascontiguousarray(
            _host(gt_depths)[self._local[0]:self._local[-1] + 1],
            np.float32))
        spatial = self.spatial and self.params.regularization.do_nltgv2
        stats, idepth = [], []
        for g, (sl, devs) in enumerate(zip(self._rows, self.groups)):
            home = devs[0]
            args = (self._to_device(torch.from_numpy(imgs[sl]), home),
                    self._to_device(torch.from_numpy(meta[sl]), home),
                    None if gt is None else self._to_device(
                        torch.from_numpy(gt[sl]), home))
            kw = dict(cam=self.cam, params=self.params, is_pf=is_pf,
                      kf_slot=kf_slot)
            before = raster_cuda.rasterize_tri_ids_v4_batched.launches
            if self.feat:
                st, dmap, row = feat_shard.feat_full_step(
                    self._gstates[g], self._lanes[g], *args, **kw)
            elif spatial and self.parts[g] is not None:
                st, dmap, row = batched_full_step_spatial(
                    self._gstates[g], self.parts[g], *args, **kw)
            else:
                st, dmap, row = batched_full_step(self._gstates[g], *args,
                                                  **kw)
            self.group_launches[g] += (
                raster_cuda.rasterize_tri_ids_v4_batched.launches - before)
            self._gstates[g] = st
            idepth.append(dmap)
            stats.append(row)
        self._last_stats, self._last_idepth = stats, idepth
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
        if (not self.blocking_installs
                and len(self._pending_topo) >= _MAX_TOPO_PENDING):
            self.topo_dropped += 1
            return
        snaps = self._snapshot()
        copied = None
        if self.device.type == "cuda":
            hosts, copied = [], []
            for snap in snaps:
                host = torch.empty(snap.shape, dtype=snap.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(snap.device))
                hosts.append(host)
                copied.append(ev)
            snaps = hosts
        if self._round_pool is None:
            self._round_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="flame-ms-round")
        self._pending_topo.append(self._round_pool.submit(
            self._build_topologies, snaps, copied, wm))

    def _snapshot(self) -> list:
        """Per group [S_g, 3N] f32 (vertex positions, graph membership) on
        the group's device."""
        return [torch.cat([st.vtx_uv.reshape(st.vtx_uv.shape[0], -1),
                           st.vtx_in_graph.to(torch.float32)], 1)
                for st in self._group_states()]

    def _build_topologies(self, snaps, copied, wm: int):
        """The packed topologies [S_local, L] int32 of one round (with the
        per-stream spatial partitions in spatial mode), built on the build
        pool from one host copy of each group's snapshot."""
        for ev in copied or ():
            ev.synchronize()
        buf = np.concatenate([s.cpu().numpy() for s in snaps])
        n = buf.shape[0]
        N = self.params.engine.max_features
        uv = buf[:, :2 * N].reshape(n, N, 2)
        elig = buf[:, 2 * N:] > 0.5
        if self._build_pool is None:
            self._build_pool = ThreadPoolExecutor(
                max_workers=min(n, 8), thread_name_prefix="flame-ms-tri")
        builder = _HostTopologyBuilder(self.params)
        t0 = time_mod.perf_counter()

        def one(s):
            packed = builder.build(uv[s], elig[s], wm)
            if not self.spatial:
                return packed, None
            return packed, builder.partition(*builder.packed_edges(packed),
                                             uv[s], elig[s])

        built = list(self._build_pool.map(one, range(n)))
        self.tri_round_s.append(time_mod.perf_counter() - t0)
        bufs = torch.from_numpy(np.stack([b for b, _ in built]))
        if not self.spatial:
            return bufs
        return bufs, [p for _, p in built]

    def _place_parts(self, g: int, parts: list):
        self.parts[g] = spatial_pd.place_partitions(
            self.groups[g], self.groups[g][0], parts,
            self.params.engine.max_edges)

    def _install_topologies(self, bufs):
        parts = None
        if isinstance(bufs, tuple):
            bufs, parts = bufs
        e = self.params.engine
        sts = self._group_states()
        for g, (sl, devs) in enumerate(zip(self._rows, self.groups)):
            self._set_group_state(g, _batched_install(
                sts[g], self._to_device(bufs[sl], devs[0]),
                T=e.max_triangles, E=e.max_edges, N=e.max_features,
                D=e.max_vertex_degree))
            if parts is not None:
                self._place_parts(g, parts[sl])

    def drain_topologies(self):
        """Block until every in-flight deferred round is installed (call
        before reading final meshes or maps)."""
        while self._pending_topo:
            self._install_topologies(self._pending_topo.popleft().result())

    # -- checkpoint / restart --------------------------------------------
    def _ckpt_file(self, path: str) -> str:
        base = path[:-4] if path.endswith(".npz") else path
        if self.multiprocess:
            base = f"{base}.p{self.rank}"
        return base + ".npz"

    def _caps(self) -> list:
        e = self.params.engine
        return [self.S, e.max_features, e.max_keyframes,
                e.max_vertex_degree, e.spatial_parts]

    def save_checkpoint(self, path: str) -> str:
        """Write this process's streams' state and the host counters to
        one NPZ in the JAX package's layout: leaf_i in `state_leaves`
        order with a leading stream dimension, `__host__` =
        [num_poseframes, kf_slot, frame_count, max_frame_id,
        topo_dropped], `__caps__` = [S, max_features, max_keyframes,
        max_vertex_degree, spatial_parts]. In multi-process mode the file
        is `<path>.p<rank>.npz` and `__rows__` lists the global ids of
        the streams it holds. In-flight rounds install first; the spatial
        partitions are not saved (a load re-triangulates). The file is published
        atomically (a temporary name, fsync, rename). Returns its path."""
        self.drain_topologies()
        arrays = {f"leaf_{i}": np.concatenate(
            [x.detach().cpu().numpy() for x in xs])
            for i, xs in enumerate(zip(*(state_leaves(s)
                                         for s in self._group_states())))}
        if self.multiprocess:
            arrays["__rows__"] = np.asarray(self._local, np.int32)
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
        package's runner) into a runner with the same stream count,
        capacity params and (multi-process) process layout; rounds in
        flight for the replaced state are dropped. In spatial mode, as in
        the JAX package, each of this process's streams is re-triangulated
        on the host from the restored vertex positions and graph membership
        at watermark `_max_frame_id`, and that topology is installed with
        its partitions, as a synchronous poseframe round does. The resumed
        run then differs from the uninterrupted one (the restored edges
        and duals are replaced) exactly as the JAX package's does."""
        data = np.load(self._ckpt_file(path))
        caps = data["__caps__"].tolist()
        if caps != self._caps():
            raise ValueError(
                f"checkpoint capacities {caps} != runner {self._caps()} — "
                f"construct the runner with the same params")
        if self.multiprocess:
            rows = data["__rows__"].tolist()
            if rows != self._local:
                raise ValueError(f"checkpoint stream rows {rows} != this "
                                 f"process's streams {self._local}")
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
        self._last_stats = None
        self._last_idepth = None
        self.parts = [None] * len(self.groups)
        if self.spatial and self._num_poseframes > 0:
            self._install_topologies(self._build_topologies(
                self._snapshot(), None, self._max_frame_id))

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
        """One device-to-host copy per group: per-stream {key: value}
        stats of the last frame, this process's streams in order."""
        if self._last_stats is None:
            return []
        rows = np.concatenate([s.detach().cpu().numpy()
                               for s in self._last_stats])
        return [dict(zip(DEVICE_STATS_KEYS, map(float, r))) for r in rows]

    def get_idepth_maps(self) -> np.ndarray:
        """The last frame's in-dispatch dense idepth maps [S_local, H, W]
        (NaN where uncovered)."""
        return np.concatenate([m.detach().cpu().numpy()
                               for m in self._last_idepth])

    def get_meshes(self) -> list:
        """Per-stream compacted meshes, (uv [V, 2], idepth [V], tris
        [M, 3]), from two device-to-host copies per group (the float and
        the int32 leaves). Triangles are gated on the stale-topology
        watermark, the single-stream getters' rule: a vertex slot
        re-detected after the installed triangulation (frame id >
        watermark) is a different feature, so triangles touching it are
        masked."""
        out = []
        for st in self._group_states():
            S, N, T = st.vtx_x.shape[0], st.vtx_x.shape[-1], st.tris.shape[-2]
            fl = torch.cat([st.vtx_uv.reshape(S, -1), st.vtx_x,
                            st.vtx_in_graph.to(torch.float32),
                            st.tri_valid.to(torch.float32)], 1).cpu().numpy()
            ints = torch.cat([st.tris.reshape(S, -1), st.feat.frame_id,
                              st.topo_frame_id[:, None]], 1).cpu().numpy()
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
