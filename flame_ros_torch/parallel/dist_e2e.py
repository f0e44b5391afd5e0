"""Multi-process end-to-end worker: the full MultiStreamRunner loop across a
process boundary, each process feeding, triangulating and smoothing its
own cameras' streams (counterpart of `flame_ros_tpu/parallel/dist_e2e.py`).

    python -m flame_ros_torch.parallel.dist_e2e <rank> <nproc> <port> \
        [n_frames] [--single] [--spatial] [--ckpt=PATH] [--ckpt-at=N] \
        [--ckpt-load] [--pause-after-save=S] [--bench] [--device cpu] \
        [--frames=NPZ]

Start one process per rank (0 .. nproc-1) with the same port. Each runs
`MultiStreamRunner` over nproc QVGA synthetic streams (stream s fed frame
max(i - s, 0), so the streams' states differ) for n_frames frames (13: 3
poseframe rounds) with deferred triangulation and blocking installs, and
holds its own stream: rank r owns stream r, on `cuda:(r % cards)` (two
ranks share the card when one is visible) or on the CPU with `--device
cpu`. `--spatial` runs each rank's stream over a 2-part spatial layout
on its device ([[d, d]], `engine.spatial_parts=2`). `--single` is the
same loop and streams in one process (one stream group per stream, no
process group): the baseline each rank's result must equal.
`--ckpt=PATH --ckpt-at=N` writes the per-process checkpoint
`PATH.p<rank>.npz` after frame N (`--pause-after-save=S` then idles S
seconds, a window in which a harness can kill a rank); `--ckpt-load`
resumes from those files at frame N. `--bench` times 24 more updates.
`--frames=NPZ` reads the frames from a file `render_frames` wrote
(`np.savez(path, imgs=, depths=, q=, t=, ts=)`) instead of rendering
them in every process.

Each stream prints one line, `DIST_E2E_OK stream=<s> nproc=.. frames=..
pf_rounds=.. cov=.. med_err=.. tris=.. digest=..` (`DIST_E2E_SPATIAL_OK`
with `--spatial`); the part from `frames=` on is the stream's result (its
coverage and median idepth error against GT, its triangle count and a
hash of its last idepth map and vertex idepths), the same in every run of
the same streams.

The process group uses the `gloo` backend: the stream-parallel step
needs no collective, and the only ones here are host-side (the stats rows
gathered onto every rank, and barriers), which gloo runs on the CPU over
TCP whatever device a rank computes on. The address is
`tcp://127.0.0.1:<port>`.
"""
from __future__ import annotations

import hashlib
import sys
import time


def render_frames(device):
    """The worker's 14 QVGA strafe frames as host arrays: uint8 images,
    GT depths, poses (q, t) and timestamps."""
    import numpy as np
    import torch

    from flame_ros_torch.datasets.synthetic import QVGA, make_sequence
    seq = make_sequence(14, QVGA, motion="strafe", device=device)
    return (torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy(),
            seq.depths.cpu().numpy(), seq.poses.q.cpu().numpy(),
            seq.poses.t.cpu().numpy(), np.asarray(seq.timestamps))


def main(rank: int, nproc: int, port: int, n_frames: int = 13,
         bench: bool = False, single: bool = False, spatial: bool = False,
         ckpt: str = "", ckpt_at: int = 0, ckpt_load: bool = False,
         pause_after_save: float = 0.0, device=None,
         frames_file: str = "") -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.datasets.synthetic import QVGA
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.parallel.multi_stream import MultiStreamRunner
    from flame_ros_torch.utils.device import resolve_device

    dev = resolve_device(device)          # no card: raises, no fallback
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    if not single:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=nproc, rank=rank)
    params = FlameParams.from_dict({
        "engine": {"max_features": 512, "max_keyframes": 4,
                   "pd_iters_per_frame": 30,
                   **({"spatial_parts": 2} if spatial else {})},
        "input": {"poseframe_subsample_factor": 6},
    })
    if frames_file:
        with np.load(frames_file) as f:
            imgs, depths, q, t, ts = (f[k] for k in
                                      ("imgs", "depths", "q", "t", "ts"))
    else:
        imgs, depths, q, t, ts = render_frames(dev)
    one = [[dev, dev]] if spatial else [dev]
    mesh = one * nproc if single else one
    runner = MultiStreamRunner(QVGA, nproc, params=params, mesh=mesh,
                               deferred_triangulation=True)
    assert runner.multiprocess == (not single)
    # The same install policy in both modes, so a run's result does not
    # depend on the build threads' timing.
    runner.blocking_installs = True

    def frames(i):
        return [(float(ts[k]), k,
                 SE3(torch.from_numpy(q[k]), torch.from_numpy(t[k])),
                 imgs[k]) for k in (max(i - s, 0) for s in range(nproc))]

    start = 0
    if ckpt and ckpt_load:
        runner.load_checkpoint(ckpt)
        start = ckpt_at
        print(f"CKPT_LOADED rank={rank} at={ckpt_at}", flush=True)
    for i in range(start, n_frames - 1):
        runner.update(frames(i))
        if ckpt and not ckpt_load and i + 1 == ckpt_at:
            runner.save_checkpoint(ckpt)
            print(f"CKPT_SAVED rank={rank} at={ckpt_at}", flush=True)
            if pause_after_save > 0:
                time.sleep(pause_after_save)
    # Installs land before the checked frame, so its raster runs over the
    # installed topology.
    runner.drain_topologies()
    runner.update(frames(n_frames - 1))

    local = runner.local_streams()
    assert local == (list(range(nproc)) if single else [rank]), local
    maps = runner.get_idepth_maps()
    meshes = runner.get_meshes()
    stats = runner.flush_stats()
    assert maps.shape[0] == len(meshes) == len(stats) == len(local)
    if spatial:
        assert runner.spatial and all(p is not None for p in runner.parts)
    tag = "DIST_E2E_SPATIAL_OK" if spatial else "DIST_E2E_OK"
    for k, s in enumerate(local):
        # Stream s lags s frames; >= 3 poseframe rounds ran, so its mesh
        # is installed and fresh.
        ref = max(n_frames - 1 - s, 0)
        gt = 1.0 / np.maximum(depths[ref], 1e-6)
        m = np.isfinite(maps[k]) & (depths[ref] > 0)
        assert m.mean() > 0.4, f"stream {s}: coverage {m.mean()}"
        med = float(np.median(np.abs(maps[k] - gt)[m]))
        assert med < 0.05, f"stream {s}: median idepth err {med}"
        uv, x, tris = meshes[k]
        assert len(tris) >= 1 and np.isfinite(x).all()
        assert stats[k]["coverage"] > 0.3, stats[k]
        digest = hashlib.sha1(np.ascontiguousarray(maps[k]).tobytes()
                              + np.ascontiguousarray(x).tobytes()
                              ).hexdigest()[:16]
        print(f"{tag} stream={s} nproc={nproc} frames={n_frames} "
              f"pf_rounds={(n_frames + 5) // 6} cov={m.mean():.6f} "
              f"med_err={med:.6f} tris={len(tris)} digest={digest}",
              flush=True)
    if not single:
        # Host-side collectives (gloo): every rank gathers every rank's
        # stats rows, then all meet at a barrier.
        rows = [None] * nproc
        dist.all_gather_object(rows, stats)
        assert sum(len(r) for r in rows) == nproc, rows
        dist.barrier()
        if rank == 0:
            print(f"DIST_E2E_STATS streams={sum(len(r) for r in rows)} "
                  f"coverage={[round(r[0]['coverage'], 6) for r in rows]}",
                  flush=True)

    if bench:
        # After the accuracy checks: the replay below wraps around the
        # sequence (a throughput load, not a scene).
        runner.get_idepth_maps()
        t0 = time.perf_counter()
        n_bench = 24
        for i in range(n_bench):
            runner.update(frames(i % 13))
        runner.get_idepth_maps()
        fps = len(local) * n_bench / (time.perf_counter() - t0)
        print(f"DIST_E2E_FPS rank={rank} fps={fps:.2f}", flush=True)
    runner.shutdown()
    if not single:
        dist.destroy_process_group()


def _opt(argv, name: str, default: str = "") -> str:
    for i, a in enumerate(argv):
        if a.startswith(f"--{name}="):
            return a.split("=", 1)[1]
        if a == f"--{name}" and i + 1 < len(argv):
            return argv[i + 1]
    return default


def cli(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = _opt(argv, "device") or None
    pos = [a for i, a in enumerate(argv)
           if not a.startswith("--") and not (i and argv[i - 1] == "--device")]
    main(int(pos[0]), int(pos[1]), int(pos[2]),
         int(pos[3]) if len(pos) > 3 else 13,
         bench="--bench" in argv, single="--single" in argv,
         spatial="--spatial" in argv, ckpt=_opt(argv, "ckpt"),
         ckpt_at=int(_opt(argv, "ckpt-at", "0")),
         ckpt_load="--ckpt-load" in argv,
         pause_after_save=float(_opt(argv, "pause-after-save", "0")),
         device=device, frames_file=_opt(argv, "frames"))


if __name__ == "__main__":
    cli()
