"""Feature-axis sharding of a stream's graph: the JAX package's "feat" mesh
axis (`flame_ros_tpu/parallel/multi_stream.py`, `make_mesh(stream_axis <
n)` and the "feat" lanes of `state_shardings`).

Within a stream group of F lane blocks, the lane leaves of the batched
`EngineState` — the feature filter, the vertex arrays (`vtx_*`), the edge
arrays (`edge_q`, `edges`, `edge_valid`), the incidence lists and the
triangles — live split into F contiguous blocks along their lane axis,
block f on device f. Images, keyframes and the other leaves stay whole on
the group's home device (block 0's), as JAX replicates them over the feat
axis. `FeatState` holds that layout.

One engine frame (`feat_step`):

- lane-local work runs on each block: the epipolar filter (elementwise
  over features), the NLTGV2 sweeps and the smoothing cost sums;
- lane-global work runs on the home device over lanes gathered once per
  frame: the rest of the track step (projection, slot allocation and
  detection on poseframes), the sweep's setup, and the smooth tail
  (raster, dense map, photometric telemetry, stats); the blocks are cut
  from its result.

Each sweep all-gathers the extrapolated primals xwb [V, 3], which every
edge block's dual update reads at its edges' endpoints, and the per-edge
adjoint contributions [E, 3], which every vertex block's incidence
gather (or product with its rows of the matmul adjoint's matrix) reads.
The sweep is `ops/nltgv2.py`'s, cut into its edge half (`_sweep_dual`)
and its vertex half (`_adjoint`, `_sweep_primal`) on block-local
constants; each vertex sums its incidence list in the unsharded order, so
the state equals the plain step's bit for bit. Only the cost sums are
split (per block, then added in block order), so the stats' smoothing
costs may differ from the plain step's by the ulps of a split sum. The
gate's max |dx| is a max over blocks.

Where the blocks live (`LaneGroup`):

- in one process, a list of F devices (one device may be named F times:
  one card holds the layout). The all-gather is a concatenation on each
  distinct device; nothing syncs the host.
- across processes (`LaneGroup.processes`, `parallel/dist_smoke.py`):
  rank r holds block r on its own device and does the lane-global work
  itself, on lanes all-gathered to every rank (JAX replicates that work
  over the feat axis the same way). The collective is gloo's
  `all_gather`, which takes CPU tensors only (and NCCL refuses two ranks
  on one card): a block goes to a pinned host buffer, the card's stream
  is synchronized, gloo gathers the host buffers, and the result goes
  back to the card non-blocking. Booleans travel as uint8. Nothing falls
  back to the CPU: the compute stays on each rank's device.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.geometry.camera import Pinhole
from flame_ros_torch.models.engine import (NUM_LEVELS, EngineState,
                                           _epipolar_step, _smooth_finish,
                                           _smooth_pd_setup, _smooth_step,
                                           _track_step, state_from_leaves,
                                           state_leaves)
from flame_ros_torch.ops import epipolar as ep_ops
from flame_ros_torch.ops import nltgv2 as reg_ops
from flame_ros_torch.ops.pyramid import build_pyramid

# The lane leaves: the feature filter's fields, then these EngineState
# fields (the "feat" leaves of the JAX package's state_shardings); all
# lead `state_leaves`, so a state's first NUM_LANE_LEAVES leaves.
LANE_FIELDS = ("vtx_uv", "vtx_x", "vtx_w", "vtx_z", "vtx_in_graph",
               "edge_q", "edges", "edge_valid", "inc_edges", "inc_sign",
               "tris", "tri_valid")
assert EngineState._fields[1:1 + len(LANE_FIELDS)] == LANE_FIELDS
NUM_LANE_LEAVES = len(ep_ops.FeatureFilterState._fields) + len(LANE_FIELDS)
_NF = len(ep_ops.FeatureFilterState._fields)

# The sweep constants a block holds whole: the matmul adjoint's tail and
# head contributions read every edge's dp. The others are cut, the edge
# half's along the edges and the vertex half's along the vertices.
_WHOLE_CONSTS = ("dp",)


class FeatState(NamedTuple):
    """A stream group's batched state in the feature-axis layout: `lanes`
    holds this process's lane blocks (each a tuple of NUM_LANE_LEAVES
    [S, n/F, ...] tensors on its block's device), `rest` the other leaves
    whole on the home device."""
    lanes: tuple
    rest: tuple


def _cut(x, f: int, F: int, dim: int = 1):
    n = x.shape[dim]
    return x.narrow(dim, f * n // F, n // F)


class LaneGroup:
    """Where a group's F lane blocks live and how they are all-gathered.

    `LaneGroup(devices)`: all F blocks in this process, block f on
    devices[f]. `LaneGroup.processes(device)`: one block per rank of the
    default process group, this rank's on `device`."""

    def __init__(self, devices: Sequence, *, blocks=None, F=None,
                 collective=False):
        devices = [torch.device(d) for d in devices]
        self.devices = devices
        self.blocks = list(range(len(devices))) if blocks is None else blocks
        self.F = len(devices) if F is None else F
        self.home = devices[0]
        self.collective = collective

    @classmethod
    def processes(cls, device) -> "LaneGroup":
        d = torch.distributed
        return cls([device], blocks=[d.get_rank()], F=d.get_world_size(),
                   collective=True)

    def split(self, state: EngineState) -> FeatState:
        """A batched state ([S, ...] leaves, on any device) cut into this
        process's lane blocks."""
        leaves = state_leaves(state)
        lanes = tuple(tuple(_cut(x, f, self.F).to(d, non_blocking=True)
                            for x in leaves[:NUM_LANE_LEAVES])
                      for f, d in zip(self.blocks, self.devices))
        rest = tuple(x.to(self.home, non_blocking=True)
                     for x in leaves[NUM_LANE_LEAVES:])
        return FeatState(lanes, rest)

    def join(self, fs: FeatState) -> EngineState:
        """The whole batched state on the home device."""
        lanes = self.gather([list(b) for b in fs.lanes], 1, [self.home])[0]
        return state_from_leaves(list(lanes) + list(fs.rest))

    def gather(self, parts, dim: int, targets=None):
        """All-gather along `dim`. parts: one entry per local block (a
        tensor, or a list of tensors gathered alike). Returns one entry
        per target device (default: each local block's), each the F
        blocks concatenated in block order."""
        targets = self.devices if targets is None else targets
        single = torch.is_tensor(parts[0])
        rows = [[p] if single else list(p) for p in parts]
        if self.collective:
            full = [self._all_gather(x, dim) for x in rows[0]]
            out = [[x.to(d, non_blocking=True) for x in full]
                   for d in targets]
        else:
            cache = {}
            out = []
            for d in targets:
                if d not in cache:      # one copy per distinct device
                    cache[d] = [torch.cat([r[k].to(d, non_blocking=True)
                                           for r in rows], dim)
                                for k in range(len(rows[0]))]
                out.append(cache[d])
        return [o[0] for o in out] if single else out

    def _all_gather(self, x, dim: int):
        """gloo all_gather of this rank's block through host buffers."""
        dist = torch.distributed
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        pin = x.device.type == "cuda"
        host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=pin)
        host.copy_(wire, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(x.device).synchronize()
        bufs = [torch.empty_like(host) for _ in range(self.F)]
        dist.all_gather(bufs, host)
        shape = list(host.shape)
        shape[dim] *= self.F
        full = torch.empty(shape, dtype=host.dtype, pin_memory=pin)
        torch.cat(bufs, dim, out=full)
        full = full.to(x.device, non_blocking=pin)
        return full.to(torch.bool) if x.dtype == torch.bool else full


def _block_consts(c: reg_ops._SweepConsts, f: int, F: int,
                  device) -> reg_ops._SweepConsts:
    """Block f's sweep constants ([S, ...]): its edges' and its
    vertices' (and `_WHOLE_CONSTS` whole)."""
    return reg_ops._SweepConsts(**{
        k: (getattr(c, k) if k in _WHOLE_CONSTS
            else _cut(getattr(c, k), f, F)).to(device, non_blocking=True)
        for k in reg_ops._SweepConsts._fields})


def _block_costs(top, xw_full, xw, z, lam, vm):
    """(smoothness, data, live vertices) sums of one block: its edges'
    |K| (the endpoints read from the gathered primals) and its vertices'
    data term."""
    K = reg_ops._K_apply(top, xw_full[:, 0], xw_full[:, 1:])
    smooth = torch.sum(torch.abs(K) * top.edge_valid[:, None])
    data = torch.sum(torch.abs(xw[:, 0] - z) * lam * vm)
    return torch.stack([smooth, data, torch.sum(vm.to(torch.float32))])


def _sweeps(group: LaneGroup, cons, gcats, xw, q, *, num_iters: int,
            theta: float, gate_tol: float):
    """The sweeps over the lane blocks. cons / gcats / xw / q: one entry
    per local block, stream-batched ([S, ...]; the sweep's halves take
    the batch dimension directly). Each sweep all-gathers xwb and the
    per-edge contributions; the gate as in `pd_iterate`, its max over
    blocks."""
    nb = len(xw)
    xwb = list(xw)
    xw, q = list(xw), list(q)
    if gate_tol > 0.0:
        delta = torch.full((xw[0].shape[0],), float("inf"),
                           dtype=xw[0].dtype, device=group.home)
    for _ in range(num_iters):
        xwb_full = group.gather(xwb, 1)
        dq = [reg_ops._sweep_dual(cons[b], xwb_full[b], q[b])
              for b in range(nb)]
        pe_full = group.gather([p for _, p in dq], 1)
        outs = []
        for b in range(nb):
            g = reg_ops._adjoint(cons[b], pe_full[b],
                                 None if gcats is None else gcats[b])
            outs.append((*reg_ops._sweep_primal(cons[b], theta, xw[b], g),
                         dq[b][0]))
        if gate_tol <= 0.0:
            xw = [o[0] for o in outs]
            xwb = [o[1] for o in outs]
            q = [o[2] for o in outs]
            continue
        d_blk = [torch.abs(outs[b][0][..., 0] - xw[b][..., 0])
                 .amax(-1)[:, None] for b in range(nb)]
        d_n = group.gather(d_blk, 1, [group.home])[0].amax(1)
        active = delta > gate_tol
        for b, d in enumerate(group.devices):
            a = active.to(d, non_blocking=True)[:, None, None]
            xw[b] = torch.where(a, outs[b][0], xw[b])
            xwb[b] = torch.where(a, outs[b][1], xwb[b])
            q[b] = torch.where(a, outs[b][2], q[b])
        delta = torch.where(active, d_n, delta)
    return xw, q


def feat_step(fs: FeatState, group: LaneGroup, img_pyrs, qs, ts, frame_ids,
              gt, *, cam: Pinhole, params: FlameParams, is_pf: bool,
              kf_slot: int):
    """One engine frame (track + smooth, the poseframe branch included)
    for a stream group in the feature-axis layout. img_pyrs [S, L, H, W],
    qs [S, 4], ts [S, 3], frame_ids [S] int32 and gt ([S, H, W] or None)
    on the home device. Returns (FeatState, dense idepth maps [S, H, W],
    stats [S, len(DEVICE_STATS_KEYS)]) as `batched_full_step` does, the
    maps and stats on the home device."""
    vmap = torch.func.vmap
    home, F = group.home, group.F
    has_gt = gt is not None
    rest = state_from_leaves([None] * NUM_LANE_LEAVES + list(fs.rest))

    # --- the epipolar filter on each lane block ---------------------------
    epis = []
    for blk, d in zip(fs.lanes, group.devices):
        feat = ep_ops.FeatureFilterState(*blk[:_NF])
        args = [x.to(d, non_blocking=True) for x in (
            rest.kf_pyrs, rest.kf_q, rest.kf_t, img_pyrs, qs, ts)]
        epis.append(vmap(lambda *a: _epipolar_step(
            *a, cam=cam, params=params))(feat, *args))
    keys = list(epis[0].counts)
    parts = [[*r.state, r.status, r.xi_meas, r.uv_match, *blk[_NF:]]
             for r, blk in zip(epis, fs.lanes)]
    full = group.gather(parts, 1, [home])[0]
    counts = group.gather([torch.stack([r.counts[k] for k in keys], 1)
                           for r in epis], 1, [home])[0]
    nk = len(keys)
    counts = {k: counts[:, i::nk].sum(1) for i, k in enumerate(keys)}
    res = ep_ops.EpipolarResult(
        state=ep_ops.FeatureFilterState(*full[:_NF]), status=full[_NF],
        xi_meas=full[_NF + 1], uv_match=full[_NF + 2], counts=counts)
    states = state_from_leaves(list(full[:_NF]) + list(full[_NF + 3:])
                               + list(fs.rest))

    # --- the rest of the track step on the home device --------------------
    def track(state, pyr, q, t, fid, r):
        state, _, _, counts_vec, _ = _track_step(
            state, pyr, q, t, fid, kf_slot, is_pf, cam=cam, params=params,
            epipolar=r)
        tri_fresh, edge_fresh, lam = _smooth_pd_setup(state, params=params)
        return state, counts_vec, tri_fresh, edge_fresh, lam

    states, counts_vec, tri_fresh, edge_fresh, lam = vmap(track)(
        states, img_pyrs, qs, ts, frame_ids, res)

    reg = params.regularization
    if not reg.do_nltgv2:
        states, idepth, stats = vmap(lambda st, p, q, t, cv, g: _smooth_step(
            st, p, q, t, cv, g, cam=cam, params=params, has_gt=has_gt,
            dense_products=True),
            in_dims=(0, 0, 0, 0, 0, 0 if has_gt else None))(
            states, img_pyrs, qs, ts, counts_vec, gt)
        return group.split(states), idepth, stats

    # --- the NLTGV2 sweeps on the lane blocks -----------------------------
    eng = params.engine

    def setup(st, ef, lm):
        top = reg_ops.build_topology(st.edges, ef, st.vtx_uv,
                                     inc_edges=st.inc_edges,
                                     inc_sign=st.inc_sign)
        return reg_ops._sweep_consts(top, st.vtx_z, lm, st.vtx_in_graph,
                                     st.vtx_x.dtype), top

    consts, top = vmap(setup)(states, edge_fresh, lam)
    gcat = None
    if eng.nltgv2_adjoint == "matmul":
        V = states.vtx_x.shape[-1]
        gcat = vmap(lambda e, ev: reg_ops.build_gcat(e, ev, V))(
            states.edges, edge_fresh)
    xw0 = torch.cat([states.vtx_x[..., None], states.vtx_w], -1)
    cons, gcats, xw, q = [], [], [], []
    for f, d in zip(group.blocks, group.devices):
        cons.append(_block_consts(consts, f, F, d))
        if gcat is not None:
            gcats.append(_cut(gcat, f, F).to(d, non_blocking=True))
        xw.append(_cut(xw0, f, F).to(d, non_blocking=True))
        q.append(_cut(states.edge_q, f, F).to(d, non_blocking=True))
    xw, q = _sweeps(group, cons, gcats if gcat is not None else None, xw, q,
                    num_iters=eng.pd_iters_per_frame,
                    theta=reg.nltgv2.theta, gate_tol=eng.pd_gate_tol)

    # --- the cost sums on the blocks, the smooth tail on the home device --
    xw_all = group.gather(xw, 1)
    sums = []
    for b, (f, d) in enumerate(zip(group.blocks, group.devices)):
        top_f = reg_ops.GraphTopology(*(
            None if x is None else _cut(x, f, F).to(d, non_blocking=True)
            for x in top))
        sums.append(vmap(_block_costs)(
            top_f, xw_all[b], xw[b], cons[b].z, _cut(lam, f, F).to(d),
            _cut(states.vtx_in_graph, f, F).to(d))[..., None])
    sums = group.gather(sums, 2, [home])[0]       # [S, 3, F]
    tot = sums[..., 0]
    for k in range(1, F):
        tot = tot + sums[..., k]
    n = torch.clamp(tot[:, 2], min=1.0)
    costs = {"nltgv2_total_smoothness_cost": tot[:, 0],
             "nltgv2_avg_smoothness_cost": tot[:, 0] / n,
             "nltgv2_total_data_cost": tot[:, 1],
             "nltgv2_avg_data_cost": tot[:, 1] / n}
    xw_h = xw_all[0]                  # block 0's device is the home
    q_h = group.gather(q, 1, [home])[0]

    def finish(st, p, cq, ct, cv, g, x, w, qq, c, tf, ef):
        return _smooth_finish(st, p, cq, ct, cv, g, x, w, qq, c, tf, ef,
                              cam=cam, params=params, has_gt=has_gt,
                              dense_products=True)

    dims = [0] * 12
    dims[5] = 0 if has_gt else None
    states, idepth, stats = vmap(finish, in_dims=tuple(dims))(
        states, img_pyrs, qs, ts, counts_vec, gt, xw_h[..., 0],
        xw_h[..., 1:], q_h, costs, tri_fresh, edge_fresh)
    return group.split(states), idepth, stats


def feat_full_step(fs: FeatState, group: LaneGroup, imgs, meta, gt, *,
                   cam: Pinhole, params: FlameParams, is_pf: bool,
                   kf_slot: int):
    """`multi_stream.batched_full_step` in the feature-axis layout: imgs
    [S, H, W] uint8 and meta [S, META_COLS] f32 rows on the home device,
    gt [S, H, W] or None. Returns (FeatState, dense idepth maps, stats)."""
    pyrs = torch.func.vmap(
        lambda im: build_pyramid(im.to(torch.float32), NUM_LEVELS))(imgs)
    return feat_step(fs, group, pyrs, meta[:, :4], meta[:, 4:7],
                     meta[:, 7].to(torch.int32), gt, cam=cam,
                     params=params, is_pf=is_pf, kf_slot=kf_slot)
