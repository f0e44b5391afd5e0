"""Spatially partitioned NLTGV2 primal-dual smoothing with halo exchange.

Counterpart of `flame_ros_tpu/parallel/spatial_pd.py`. The Delaunay graph
is split into P vertical image strips, one per part device, and the
NLTGV2 sweep of `ops/nltgv2.py` runs on each part's own vertices:

- **Vertices are partitioned** by balanced u-coordinate quantiles over
  the live vertices, padded slots spread evenly (`build_spatial_partition`,
  host numpy, a copy of the JAX package's: the same stable sorts, so the
  same partition bit for bit).
- **Boundary edges are replicated** on every part that owns an endpoint.
  Each replica does the same dual update from the same inputs, so the
  replicas stay equal without a reverse exchange of adjoint sums.
- **One halo exchange per sweep**: each part gathers its export set (the
  owned vertices another part references) into [P-1] blocks of [H, 3]
  and copies them to the other part devices (the JAX package's
  `ppermute` rotations become ring copies: block r of part s goes to
  part (s + r) % P). A part appends the blocks it receives after its
  owned vertices, so its edge lists index one [Vl + (P-1)H, 3] array.

A part holds every edge incident to its owned vertices, so the adjoint,
the diagonal preconditioners and the prox steps are all local: the sweep
is `ops/nltgv2.py`'s `_sweep_consts`/`_sweep` on part-local arrays. The
incidence lists keep the global edge order and the pad width D, so the
local adjoint reduces in the same order as the unsharded gather, and the
sweep equals the unsharded `pd_iterate` bit for bit on the CPU
(`tests/test_torch_spatial_pd.py` holds it to that).

A device list may name one device several times (one card, or "cpu",
holding a 2- or 4-way layout). A copy to the same device returns the
tensor itself, so the blocks a part sends are fresh gathers, never views
of a tensor that is later written: nothing here writes in place.

The gate (`gate_tol` > 0) needs no host sync, as in `pd_iterate`: every
sweep runs, and a device flag (the max |dx| over all parts, on the first
part's device) freezes the iterate once it is below the tolerance.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from flame_ros_torch.ops import nltgv2 as reg_ops
from flame_ros_torch.utils.device import resolve_devices


class SpatialPartition(NamedTuple):
    """Host-built partition of a (fixed, padded) Delaunay graph.

    All arrays are numpy, rebuilt at triangulation (poseframe) rate.
    `n_parts = P`, `Vl` owned vertex slots per part, `H` halo budget per
    (source, dest) pair, `El` edge slots per part. `shard_partition`
    turns the array fields into tuples of P tensors, tensor p on part
    device p.
    """
    vtx_order: np.ndarray     # [P, Vl] int32: global vertex id per slot
    vtx_part: np.ndarray      # [V] int32: owning part of each global vtx
    vtx_slot: np.ndarray      # [V] int32: owned slot of each global vtx
    edges_l: np.ndarray       # [P, El, 2] int32 into [0, Vl + (P-1)H)
    edge_valid_l: np.ndarray  # [P, El] bool
    edge_gid: np.ndarray      # [P, El] int32 global edge id (-1 pad)
    export_idx: np.ndarray    # [P, P-1, H] int32 owned slots to send to
    #                           part (p + r) % P at ring offset r = 1..P-1
    dp: np.ndarray            # [P, El, 2] f32 p_i - p_j (pixels)
    alpha: np.ndarray         # [P, El] f32 (0 on padding)
    beta: np.ndarray          # [P, El] f32
    inc_edges: np.ndarray     # [P, Vl, D] int32 local edge ids
    inc_sign: np.ndarray      # [P, Vl, D] f32 +1 tail / -1 head / 0 pad


def build_spatial_partition(edges, edge_valid, vtx_uv, vtx_valid,
                            n_parts: int, *, halo_budget: int | None = None,
                            edge_budget: int | None = None,
                            max_degree: int = 16) -> SpatialPartition:
    """Partition the padded graph into `n_parts` vertical strips.

    `edge_valid` must already reflect the degree-budget filtering of
    `ops.nltgv2.build_incidence` (the engine's installed edge set), so
    every part sees exactly the edges the unsharded sweep sees.

    Budgets: `halo_budget` (H) and `edge_budget` (El) are padded static
    shapes; when None they are sized to the actual partition with a small
    headroom and rounded up to a multiple of 8. A partition exceeding an
    explicit budget raises.
    """
    edges = np.asarray(edges)
    edge_valid = np.asarray(edge_valid, bool)
    vtx_uv = np.asarray(vtx_uv, np.float32)
    vtx_valid = np.asarray(vtx_valid, bool)
    V = len(vtx_uv)
    Pn = int(n_parts)
    if V % Pn:
        raise ValueError(f"V={V} not divisible by n_parts={Pn}")
    Vl = V // Pn

    # --- vertex buckets: u-quantile strips over live vertices ----------
    live = np.where(vtx_valid)[0]
    order = live[np.argsort(vtx_uv[live, 0], kind="stable")]
    chunks = np.array_split(order, Pn)
    dead = np.where(~vtx_valid)[0]
    vtx_order = np.zeros((Pn, Vl), np.int32)
    vtx_part = np.zeros(V, np.int32)
    vtx_slot = np.zeros(V, np.int32)
    d_at = 0
    for p in range(Pn):
        ids = list(chunks[p])
        room = Vl - len(ids)
        if room < 0:
            raise ValueError("strip overflow (live vertices unbalanced)")
        ids += list(dead[d_at:d_at + room])
        d_at += room
        ids = np.asarray(ids, np.int32)
        vtx_order[p] = ids
        vtx_part[ids] = p
        vtx_slot[ids] = np.arange(Vl, dtype=np.int32)

    # --- halo export sets: needed[s][r] = owned slots of part s that
    # part (s + r) % P references through its edges -----------------------
    needed = [[set() for _ in range(Pn)] for _ in range(Pn)]
    ev_ids = np.where(edge_valid)[0]
    for e in ev_ids:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        pi, pj = int(vtx_part[i]), int(vtx_part[j])
        if pi != pj:
            needed[pj][(pi - pj) % Pn].add(int(vtx_slot[j]))   # pj -> pi
            needed[pi][(pj - pi) % Pn].add(int(vtx_slot[i]))   # pi -> pj
    h_req = max([1] + [len(needed[s][r]) for s in range(Pn)
                       for r in range(1, Pn)])
    H = halo_budget or -(-int(h_req * 1.25) // 8) * 8
    if h_req > H:
        raise ValueError(f"halo budget {H} < required {h_req}")
    export_idx = np.zeros((Pn, max(Pn - 1, 1), H), np.int32)
    halo_pos = [[{} for _ in range(Pn)] for _ in range(Pn)]  # [s][r]{slot:k}
    for s in range(Pn):
        for r in range(1, Pn):
            lst = sorted(needed[s][r])
            export_idx[s, r - 1, :len(lst)] = lst
            halo_pos[s][r] = {sl: k for k, sl in enumerate(lst)}

    # --- per-part edge lists (global edge order preserved, so incidence
    # reductions match the unsharded path bitwise) -----------------------
    def local_index(v: int, d: int) -> int:
        s = int(vtx_part[v])
        if s == d:
            return int(vtx_slot[v])
        r = (d - s) % Pn
        return Vl + (r - 1) * H + halo_pos[s][(d - s) % Pn][int(vtx_slot[v])]

    per_part = [[] for _ in range(Pn)]   # (gid, li, lj)
    for e in ev_ids:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        owners = {int(vtx_part[i]), int(vtx_part[j])}
        for d in owners:
            per_part[d].append((int(e), local_index(i, d),
                                local_index(j, d)))
    e_req = max(1, max(len(pp) for pp in per_part))
    El = edge_budget or -(-int(e_req * 1.25) // 8) * 8
    if e_req > El:
        raise ValueError(f"edge budget {El} < required {e_req}")
    edges_l = np.zeros((Pn, El, 2), np.int32)
    edge_valid_l = np.zeros((Pn, El), bool)
    edge_gid = np.full((Pn, El), -1, np.int32)
    for p in range(Pn):
        for k, (gid, li, lj) in enumerate(per_part[p]):
            edges_l[p, k] = (li, lj)
            edge_gid[p, k] = gid
            edge_valid_l[p, k] = True

    # --- per-edge geometry (identical formula to ops.nltgv2.build_topology)
    ext_uv = np.zeros((Pn, Vl + (Pn - 1) * H, 2), np.float32)
    for p in range(Pn):
        ext_uv[p, :Vl] = vtx_uv[vtx_order[p]]
        for r in range(1, Pn):
            s = (p - r) % Pn
            src = vtx_order[s][export_idx[s, r - 1]]
            ext_uv[p, Vl + (r - 1) * H: Vl + r * H] = vtx_uv[src]
    dp = np.stack([ext_uv[p][edges_l[p, :, 0]] - ext_uv[p][edges_l[p, :, 1]]
                   for p in range(Pn)])
    dist = np.linalg.norm(dp, axis=-1)
    inv = np.where(edge_valid_l, 1.0 / np.maximum(dist, 1.0), 0.0)
    dp = dp.astype(np.float32)
    alpha = inv.astype(np.float32)
    beta = inv.astype(np.float32)

    # --- owned-vertex incidence over local edges (global edge order) ----
    inc_e = np.zeros((Pn, Vl, max_degree), np.int32)
    inc_s = np.zeros((Pn, Vl, max_degree), np.float32)
    for p in range(Pn):
        deg = np.zeros(Vl, np.int32)
        for k, (gid, li, lj) in enumerate(per_part[p]):
            for v, sign in ((li, 1.0), (lj, -1.0)):
                if v < Vl:
                    if deg[v] >= max_degree:
                        raise ValueError(
                            "degree overflow: pass the engine's filtered "
                            "edge set (build_incidence keep mask)")
                    inc_e[p, v, deg[v]] = k
                    inc_s[p, v, deg[v]] = sign
                    deg[v] += 1
    return SpatialPartition(
        vtx_order=vtx_order, vtx_part=vtx_part.astype(np.int32),
        vtx_slot=vtx_slot.astype(np.int32), edges_l=edges_l,
        edge_valid_l=edge_valid_l, edge_gid=edge_gid,
        export_idx=export_idx, dp=dp, alpha=alpha, beta=beta,
        inc_edges=inc_e, inc_sign=inc_s)


# ---------------------------------------------------------------------------
# Layout conversion (host numpy or tensors on one device).
# ---------------------------------------------------------------------------

def _index(idx, like):
    """An index array for `like`: numpy as is, else a long tensor on its
    device."""
    if isinstance(like, np.ndarray):
        return np.asarray(idx)
    return torch.as_tensor(np.asarray(idx), device=like.device).long()


def partition_vertex(part: SpatialPartition, x):
    """[V, ...] global -> [P, Vl, ...] partitioned."""
    return x[_index(part.vtx_order, x)]


def unpartition_vertex(part: SpatialPartition, xp):
    """[P, Vl, ...] -> [V, ...]: inverse of partition_vertex (a gather by
    each vertex's (part, slot))."""
    Vl = part.vtx_order.shape[1]
    flat = xp.reshape((-1,) + tuple(xp.shape[2:]))
    return flat[_index(part.vtx_part * Vl + part.vtx_slot, flat)]


def partition_edges(part: SpatialPartition, qe):
    """[E, ...] per-edge global -> [P, El, ...] (pad rows zero)."""
    gid = np.maximum(part.edge_gid, 0)
    keep = part.edge_valid_l[(...,) + (None,) * (qe.ndim - 1)]
    out = qe[_index(gid, qe)]
    if isinstance(qe, np.ndarray):
        return out * keep
    return out * torch.as_tensor(keep, device=qe.device).to(qe.dtype)


def edge_source(edge_gid: np.ndarray, num_edges: int) -> np.ndarray:
    """[..., E] int64: for each global edge, the flat (part, slot) index of
    one of its replicas in [..., P * El] (the last one), or P * El (a zero
    row appended by the caller) for an edge no part holds. Replicas carry
    equal values, so any replica is the edge's value."""
    *lead, Pn, El = edge_gid.shape
    g = edge_gid.reshape(-1, Pn * El)
    out = np.full((g.shape[0], num_edges), Pn * El, np.int64)
    for b in range(g.shape[0]):
        k = np.flatnonzero(g[b] >= 0)
        out[b, g[b, k]] = k
    return out.reshape(tuple(lead) + (num_edges,))


def unpartition_edges(part: SpatialPartition, qp, num_edges: int):
    """[P, El, ...] -> [E, ...]; edges no part holds are zero."""
    tail = tuple(qp.shape[2:])
    flat = qp.reshape((-1,) + tail)
    if isinstance(qp, np.ndarray):
        flat = np.concatenate([flat, np.zeros((1,) + tail, qp.dtype)])
    else:
        flat = torch.cat([flat, torch.zeros((1,) + tail, dtype=qp.dtype,
                                            device=qp.device)])
    return flat[_index(edge_source(part.edge_gid, num_edges), flat)]


# ---------------------------------------------------------------------------
# Device layout and the sharded sweeps.
# ---------------------------------------------------------------------------

_DEVICE_FIELDS = ("vtx_order", "edges_l", "edge_valid_l", "edge_gid",
                  "export_idx", "dp", "alpha", "beta", "inc_edges",
                  "inc_sign")


def shard_partition(devices: Sequence, part: SpatialPartition, *,
                    batched: bool = False,
                    geometry: bool = True) -> SpatialPartition:
    """Place the partition on its part devices: each array field becomes a
    tuple of P tensors, tensor p (part p's slice) on devices[p]. batched:
    the arrays are [S, P, ...] (one partition per stream) and tensor p is
    [S, ...]. geometry=False leaves out the install-time dp/alpha/beta
    (the batched sweep rebuilds them from current positions). vtx_part
    and vtx_slot stay host numpy."""
    devices = resolve_devices(devices)
    ax = 1 if batched else 0
    vals = {}
    for f in SpatialPartition._fields:
        a = getattr(part, f)
        if f not in _DEVICE_FIELDS:
            vals[f] = a
        elif f in ("dp", "alpha", "beta") and not geometry:
            vals[f] = None
        else:
            a = np.asarray(a)
            if a.shape[ax] != len(devices):
                raise ValueError(f"{f}: {a.shape[ax]} parts for "
                                 f"{len(devices)} devices")
            vals[f] = tuple(
                torch.from_numpy(np.ascontiguousarray(np.take(a, p, ax)))
                .to(d) for p, d in enumerate(devices))
    return SpatialPartition(**vals)


def _per_part(x, devices):
    """[P, ...] tensor or a sequence of P tensors -> part p's on
    devices[p]."""
    return [x[p].to(d, non_blocking=True) for p, d in enumerate(devices)]


def _exchange(devices, export_idx, x, batched: bool):
    """One halo exchange: part d's extended array [.., Vl + (P-1)H, C] is
    its own rows, then for r = 1..P-1 the export block of part
    (d - r) % P, gathered on the sender and copied to devices[d]."""
    Pn = len(devices)
    ext = []
    for d in range(Pn):
        blocks = [x[d]]
        for r in range(1, Pn):
            s = (d - r) % Pn
            idx = export_idx[s][..., r - 1, :]
            if batched:
                blk = torch.gather(x[s], 1, idx[..., None].expand(
                    -1, -1, x[s].shape[-1]))
            else:
                blk = x[s][idx]
            blocks.append(blk.to(devices[d], non_blocking=True))
        ext.append(torch.cat(blocks, dim=-2))
    return ext


def _sweeps(devices, consts, export_idx, xw, q, *, num_iters: int,
            theta: float, gate_tol: float, batched: bool):
    """`num_iters` sweeps of every part with one halo exchange each; the
    gate (gate_tol > 0) as in `pd_iterate`, its flag on devices[0]."""
    Pn = len(devices)
    sweep = (torch.func.vmap(reg_ops._sweep, in_dims=(0, None, 0, 0, 0))
             if batched else reg_ops._sweep)
    xwb = list(xw)
    xw, q = list(xw), list(q)
    if gate_tol > 0.0:
        shape = (xw[0].shape[0],) if batched else ()
        delta = torch.full(shape, float("inf"), dtype=xw[0].dtype,
                           device=devices[0])
    for _ in range(num_iters):
        ext = _exchange(devices, export_idx, xwb, batched)
        outs = [sweep(consts[p], theta, xw[p], ext[p], q[p])
                for p in range(Pn)]
        if gate_tol <= 0.0:
            xw = [o[0] for o in outs]
            xwb = [o[1] for o in outs]
            q = [o[2] for o in outs]
            continue
        d_n = None
        for p in range(Pn):
            dp_ = torch.abs(outs[p][0][..., 0] - xw[p][..., 0]).amax(-1)
            dp_ = dp_.to(devices[0], non_blocking=True)
            d_n = dp_ if d_n is None else torch.maximum(d_n, dp_)
        active = delta > gate_tol
        for p in range(Pn):
            a = active.to(devices[p], non_blocking=True)
            a = a[:, None, None] if batched else a
            xw[p] = torch.where(a, outs[p][0], xw[p])
            xwb[p] = torch.where(a, outs[p][1], xwb[p])
            q[p] = torch.where(a, outs[p][2], q[p])
        delta = torch.where(active, d_n, delta)
    return xw, q


def pd_iterate_spatial(devices: Sequence, part_dev: SpatialPartition, xw, q,
                       z, lam, vmask, *, num_iters: int = 10,
                       theta: float = 1.0, gate_tol: float = 0.0):
    """Sweeps of one graph over its spatial partition, part p on
    devices[p].

    part_dev: `shard_partition(devices, part)` (its install-time edge
    geometry is used). xw [P, Vl, 3] packed (x, w1, w2), q [P, El, 3],
    z/lam/vmask [P, Vl]: tensors, or sequences of P per-part tensors.
    One sweep = one halo exchange of extragradient primals + the
    packed-path arithmetic of `ops/nltgv2.py` on part-local data.
    Returns (xw, q): lists of P tensors, part p's on devices[p]."""
    devices = resolve_devices(devices)
    xw, q = _per_part(xw, devices), _per_part(q, devices)
    z, lam, vmask = (_per_part(a, devices) for a in (z, lam, vmask))
    consts = []
    for p in range(len(devices)):
        top = reg_ops.GraphTopology(
            edges=part_dev.edges_l[p], edge_valid=part_dev.edge_valid_l[p],
            dp=part_dev.dp[p], alpha=part_dev.alpha[p],
            beta=part_dev.beta[p], inc_edges=part_dev.inc_edges[p],
            inc_sign=part_dev.inc_sign[p])
        consts.append(reg_ops._sweep_consts(top, z[p], lam[p], vmask[p],
                                            xw[p].dtype))
    exp = [e.long() for e in part_dev.export_idx]
    return _sweeps(devices, consts, exp, xw, q, num_iters=num_iters,
                   theta=theta, gate_tol=gate_tol, batched=False)


def pd_iterate_spatial_batched(devices: Sequence, parts: SpatialPartition,
                               xw, q, edge_live, uv, z, lam, vmask, *,
                               num_iters: int = 10, theta: float = 1.0,
                               gate_tol: float = 0.0):
    """The engine's NLTGV2 sweep for a batch of streams over their spatial
    partitions (`multi_stream.batched_full_step_spatial`).

    parts: `shard_partition(devices, stacked, batched=True,
    geometry=False)` of S stacked partitions. Every other argument is a
    sequence of P per-part tensors with a leading stream dimension: xw
    [S, Vl, 3], q [S, El, 3], edge_live [S, El] (the per-frame
    stale-topology mask gathered to the part layout: a masked edge gets
    alpha = beta = 0 and a zero dual, as `build_topology` gives it on the
    unsharded path), uv [S, Vl, 2] the owned vertices' current pixel
    positions, z/lam/vmask [S, Vl]. The edge geometry is rebuilt from
    `uv` every call (one halo exchange of positions before the sweeps),
    as the unsharded step rebuilds it from `state.vtx_uv` each frame.
    Per stream the arithmetic is the unsharded step's under vmap; the
    gate's flag is per stream. Returns (xw, q) lists, part p's on
    devices[p]."""
    devices = resolve_devices(devices)
    xw, q, el, uv = (_per_part(a, devices) for a in (xw, q, edge_live, uv))
    z, lam, vmask = (_per_part(a, devices) for a in (z, lam, vmask))
    exp = [e.long() for e in parts.export_idx]
    uv_ext = _exchange(devices, exp, uv, True)
    consts = []
    for p in range(len(devices)):
        def setup(edges, live, pos, inc_e, inc_s, zz, ll, vm):
            top = reg_ops.build_topology(edges, live, pos, inc_edges=inc_e,
                                         inc_sign=inc_s)
            return reg_ops._sweep_consts(top, zz, ll, vm, pos.dtype)
        consts.append(torch.func.vmap(setup)(
            parts.edges_l[p], el[p], uv_ext[p], parts.inc_edges[p],
            parts.inc_sign[p], z[p], lam[p], vmask[p]))
    return _sweeps(devices, consts, exp, xw, q, num_iters=num_iters,
                   theta=theta, gate_tol=gate_tol, batched=True)


def stack_partitions(parts: Sequence[SpatialPartition]) -> SpatialPartition:
    """S per-stream partitions (equal budgets) stacked on a leading stream
    axis, numpy."""
    return SpatialPartition(*(np.stack(xs) for xs in zip(*parts)))



class PlacedPartition(NamedTuple):
    """S streams' partitions placed for `batched_full_step_spatial`: the
    sweep's arrays on the part devices, and the layout-conversion indices
    (long) where each conversion runs."""
    devices: tuple            # P part devices
    part: SpatialPartition    # shard_partition(batched=True, geometry=False)
    vtx_order: tuple          # P x [S, Vl] on the part devices
    edge_gid: tuple           # P x [S, El] (pads -> 0) on the part devices
    edge_valid: tuple         # P x [S, El] bool on the part devices
    inv_vtx: torch.Tensor     # [S, V] flat (part, slot) of each vertex, home
    inv_edge: torch.Tensor    # [S, E] flat replica of each edge (P*El: none)


def place_partitions(devices: Sequence, home, parts: Sequence[
        SpatialPartition], num_edges: int) -> PlacedPartition:
    """Stack S per-stream partitions and place them: the sweep's arrays
    on devices[p], the gathers back to the global layout on `home` (the
    device that holds the streams' engine state)."""
    devices = resolve_devices(devices)
    st = stack_partitions(parts)
    dev = shard_partition(devices, st, batched=True, geometry=False)
    Vl = st.vtx_order.shape[-1]

    def per_part(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, p]))
                     .to(d) for p, d in enumerate(devices))

    return PlacedPartition(
        devices=tuple(devices), part=dev,
        vtx_order=per_part(st.vtx_order.astype(np.int64)),
        edge_gid=per_part(np.maximum(st.edge_gid, 0).astype(np.int64)),
        edge_valid=per_part(st.edge_valid_l),
        inv_vtx=torch.from_numpy(
            (st.vtx_part * Vl + st.vtx_slot).astype(np.int64)).to(home),
        inv_edge=torch.from_numpy(edge_source(st.edge_gid, num_edges))
        .to(home))
