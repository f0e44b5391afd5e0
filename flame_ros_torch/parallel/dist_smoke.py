"""Multi-process smoke worker: one batched engine step whose feature axis
pairs one device from each process (counterpart of
`flame_ros_tpu/parallel/dist_smoke.py`).

    python -m flame_ros_torch.parallel.dist_smoke <rank> <nproc> <port> \
        [--device cpu]

Start one process per rank (0 .. nproc-1) with the same port. Every rank
builds the same tiny setup (96x128, 256 feature slots, 2 keyframes, a
seeded keyframe with 64 live features and their Delaunay graph; a copy of
the JAX package's `__graft_entry__._tiny_setup`) for S = 2 streams, and
the group's lane blocks are spread over the ranks: rank r holds block r
of F = nproc (`feat_shard.LaneGroup.processes`), on `cuda:(r % cards)`
(ranks share the card when one is visible) or on the CPU with `--device
cpu`. One `feat_shard.feat_step` runs; its all-gathers cross the process
boundary every sweep (gloo over pinned host buffers; see
`parallel/feat_shard.py`).

Each rank checks its coverage per stream (finite, above 0.05, equal
across the streams, which have identical inputs), then sums it across
the processes (an `all_reduce` over gloo) and checks that every rank sees
nproc * S times the coverage. It prints `DIST_OK pid=<rank> nproc=..
mesh=.. cov=<repr>`; `single_coverage` is the same step in one process
without the feat layout, which the coverage must equal.

The address is `tcp://127.0.0.1:<port>`.
"""
from __future__ import annotations

import sys

STREAMS = 2


def tiny_setup(device, height=96, width=128, max_features=256,
               max_keyframes=2):
    """(params, cam, state, pyr, q, t) on `device`: the JAX package's
    `__graft_entry__._tiny_setup` (same seed, same numbers)."""
    import numpy as np
    import torch

    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.geometry.camera import Pinhole
    from flame_ros_torch.graph.delaunay import (edges_from_triangles,
                                                triangulate)
    from flame_ros_torch.models.engine import init_state
    from flame_ros_torch.ops.nltgv2 import build_incidence
    from flame_ros_torch.ops.pyramid import build_pyramid

    params = FlameParams.from_dict({
        "engine": {"max_features": max_features,
                   "max_keyframes": max_keyframes,
                   "pd_iters_per_frame": 5}}).resolved(device)
    cam = Pinhole(fx=100.0, fy=100.0, cx=width / 2 - 0.5,
                  cy=height / 2 - 0.5, width=width, height=height)
    state = init_state(params, cam, device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (height, width))
                           .astype(np.float32)).to(device)
    pyr = build_pyramid(img, 3)
    n_seed = 64
    uv = rng.uniform(8, [width - 8, height - 8], (n_seed, 2)).astype(
        np.float32)
    tris = triangulate(uv)
    edges = edges_from_triangles(tris)
    e = params.engine
    N, E, T = e.max_features, e.max_edges, e.max_triangles
    tris_pad = np.zeros((T, 3), np.int32)
    tris_pad[:len(tris)] = tris
    tv = np.zeros(T, bool)
    tv[:len(tris)] = True
    e_pad = np.zeros((E, 2), np.int32)
    e_pad[:len(edges)] = edges
    ev = np.zeros(E, bool)
    ev[:len(edges)] = True
    inc_e, inc_s, keep = build_incidence(e_pad, ev, N, e.max_vertex_degree)
    ev &= keep

    def put(x, rows, val):
        out = x.clone()
        out[rows] = val
        return out

    def dev(a):
        return torch.from_numpy(a).to(device)

    first = slice(0, n_seed)
    feat = state.feat._replace(
        uv_ref=put(state.feat.uv_ref, first, dev(uv)),
        mu=put(state.feat.mu, first, 0.5),
        var=put(state.feat.var, first, 0.005),
        valid=put(state.feat.valid, first, True))
    state = state._replace(
        feat=feat, vtx_uv=put(state.vtx_uv, first, dev(uv)),
        vtx_x=put(state.vtx_x, first, 0.5),
        vtx_in_graph=put(state.vtx_in_graph, first, True),
        tris=dev(tris_pad), tri_valid=dev(tv), edges=dev(e_pad),
        edge_valid=dev(ev), inc_edges=dev(inc_e), inc_sign=dev(inc_s),
        kf_pyrs=put(state.kf_pyrs, 0, pyr),
        kf_valid=put(state.kf_valid, 0, True),
        kf_ids=put(state.kf_ids, 0, 0))
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t = torch.tensor([0.05, 0.0, 0.01], device=device)
    return params, cam, state, pyr, q, t


def _batch(device, S=STREAMS):
    """The setup stacked for S streams: (params, cam, states, pyrs, qs,
    ts, frame ids)."""
    import torch

    from flame_ros_torch.models.engine import (state_from_leaves,
                                               state_leaves)
    params, cam, state, pyr, q, t = tiny_setup(device)

    def rep(x):
        return x.unsqueeze(0).repeat(S, *([1] * x.dim()))

    return (params, cam, state_from_leaves([rep(x) for x in
                                            state_leaves(state)]),
            rep(pyr), rep(q), rep(t),
            torch.ones(S, dtype=torch.int32, device=device))


def single_coverage(device) -> list:
    """The per-stream coverage of the same step in one process, on the
    plain path (`multi_stream.batched_frame_step`)."""
    from flame_ros_torch.parallel.multi_stream import batched_frame_step
    params, cam, *args = _batch(device)
    _, _, cov = batched_frame_step(*args, cam=cam, params=params)
    return cov.tolist()


def main(rank: int, nproc: int, port: int, device=None) -> None:
    import math

    import torch
    import torch.distributed as dist

    from flame_ros_torch.models.engine import DEVICE_STATS_KEYS
    from flame_ros_torch.parallel import feat_shard
    from flame_ros_torch.utils.device import resolve_device

    dev = resolve_device(device)          # no card: raises, no fallback
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nproc, rank=rank)
    params, cam, states, pyrs, qs, ts, fids = _batch(dev)
    group = feat_shard.LaneGroup.processes(dev)
    fs = group.split(states)
    fs, idepth, stats = feat_shard.feat_step(
        fs, group, pyrs, qs, ts, fids, None, cam=cam, params=params,
        is_pf=False, kf_slot=0)
    cov = stats[:, DEVICE_STATS_KEYS.index("coverage")].tolist()
    assert len(fs.lanes) == 1 and group.F == nproc
    assert all(math.isfinite(c) and c > 0.05 for c in cov), cov
    assert max(cov) - min(cov) < 1e-5, cov
    assert bool(torch.isfinite(idepth).any())
    # Cross-process value exchange: every rank's coverage sum, summed.
    total = torch.tensor([sum(cov)], dtype=torch.float64)
    dist.all_reduce(total)
    assert abs(float(total) - nproc * STREAMS * cov[0]) < 1e-4, (total, cov)
    print(f"DIST_OK pid={rank} nproc={nproc} "
          f"mesh={{'stream': {STREAMS}, 'feat': {nproc}}} cov={cov[0]!r}",
          flush=True)
    dist.destroy_process_group()


def cli(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    main(int(argv[0]), int(argv[1]), int(argv[2]), device=device)


if __name__ == "__main__":
    cli()
