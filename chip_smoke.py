#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (flame_ros_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one line:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, TF32 off;
2. kernel build: csrc/raster.cu compiled from this checkout with nvcc;
3. kernels vs plain versions at VGA with T = 4096 triangle slots
   (Delaunay of 2048 seeded random points, and of 1300 of them for the
   engine's density): the v4, v2 and v3 raster kernels must equal their
   plain PyTorch versions bit for bit on an unsorted, a y-sorted, an
   engine-density, a long-triangle, a forced-fallback (budgets so small
   that the TPU v3 falls back to v2; the port's v3, which has none, must
   give v2's ids there), an empty, a sliver and a multi-chunk mesh, each
   wrapper call making one launch of its own kernel and none of another
   (wrapper counts and device work counters); whether the TPU v3's
   budgets would hold; CUDA-event medians of the kernel alone (one launch
   between two events, and back to back on the card), of the wrapper and
   of the plain version, beside the kernel's bound;
4. the main path: `run_offline` at VGA with the default FlameParams over
   60 frames rendered on the card — health on every frame, the v4 kernel
   launched and doing the work on every frame and v2 on none, the id
   buffer of six frames recomputed from the engine's own state by the
   plain v4 version (equal) and by the plain formulation `ops/raster.py::
   rasterize_tri_ids` (equal but on the few pixels that v4's evaluation
   order and its own split at VGA), whether the TPU v3's budgets would
   hold there,
   ms/frame and accuracy; then the v4 and v2 kernels timed on those six
   frames' inputs (kernel only and wrapper, CUDA-event medians), each
   equal to its plain version there;
5. the windowed streaming path at VGA, room/strafe: (a)
   `run_offline_windowed` with windows of 6 and synchronous
   triangulation over the same 60 frames, held against the JAX package's
   CPU run of that sequence; (b) 120 host frames (more than two wraps of
   the 8-keyframe ring) streamed as windows of 6 with prefetch depth 2
   and deferred triangulation: ms/frame, frames/s, coverage per window,
   topology install counters, accuracy and the raster work split; the
   per-frame path's accuracy over the same frames; and prefetched
   windows bit for bit equal to plain `update_window` calls;
6. small-input agreement: the same 96x128 frames through the card path
   (CUDA kernels) and the CPU path (plain versions);
7. the live frontend at VGA with the default FlameParams, over phase 4's
   60 frames: (a) a FlameNodelet fed by a producer thread while its
   consumer thread runs — every frame processed, none dropped, health
   READY at both ends, per-frame accuracy equal to phase 4's, v4 doing
   the raster work on every frame, process_frame_ms and latency_ms
   p50/p95 (of the burst, and of frames pushed at 30 frames/s); (b) at
   frame 30, poseframe_callback with the live poseframes' poses moved by
   a fixed SE3 and then with one id dropped, held against a numpy
   recomputation, and save_checkpoint/load_checkpoint: the resumed and
   the uninterrupted engine run to frame 60 and must agree bit for bit;
   (c) FlameServer on 127.0.0.1: one client streams 30 uint8 frames and
   gets every stats message and the idepth map, a second polls meshes,
   and stop() closes both; (d) epipolar_mode="patch" and the truth
   harness (--pass-in-truth), each held against the JAX package's CPU
   run of the sequence; (e) the TUM and ASL loaders and CLI routes over
   the same frames written as a TUM and an ASL tree.

Any failure exits non-zero. The line before the last is the card's
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`; before
it, one JSON line of per-kernel numbers. The last line is the contract
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and
prints no result.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "run_out", "chip_smoke")
# The least time of a raster kernel: the larger of its bytes (output and
# slab, each once) over the HBM3 rate and its inside tests over the f32
# instruction rate. The kernels are built with -fmad=false (the id buffer
# must match the plain version bit for bit), so a multiply and an add
# issue as two instructions: the rate is 132 SMs x 128 f32 lanes x the
# 1.98 GHz boost clock that the data sheet's 67 TFLOP/s (an FMA counted
# as two flops) implies, 33.5e12 instructions/s. H100 SXM data sheet.
F32_INSTR_RATE = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12
# f32 instructions per inside test, the per-row term hoisted: v4 x*a + d
# per edge (2 x 3); v2 and v3 (x*a + y*b) + c with y*b hoisted (3 x 3).
INSTR_PER_TEST = {"v4": 6, "v2": 9, "v3": 9}
# The JAX package on the CPU over the phase-5 (a) sequence:
#   JAX_PLATFORMS=cpu python -m flame_ros_tpu.frontends.offline_runner \
#       --dataset synthetic --frames 60 --resolution vga --window 6
# printed rmse 0.04661, recall 0.7433, coverage 0.7429 (PERF.md).
JAX_WINDOWED_VGA = {"idepth_rmse": 0.04661, "recall": 0.7433,
                    "coverage": 0.7429}
# The JAX package on the CPU over the phase-4 sequence, per frame, with
# exact per-candidate patch warps in the epipolar search:
#   JAX_PLATFORMS=cpu python -m flame_ros_tpu.frontends.offline_runner \
#       --dataset synthetic --frames 60 --resolution vga \
#       --config cfg/epipolar_patch.yaml
# and with the truth harness (same command, --pass-in-truth instead of
# --config). Phase 7 (d) holds the port to each within JAX_BAND: rmse
# relative, recall and coverage absolute.
JAX_PATCH_VGA = {"idepth_rmse": 0.04369, "recall": 0.7381,
                 "coverage": 0.8533}
JAX_TRUTH_VGA = {"idepth_rmse": 0.02795, "recall": 0.7657,
                 "coverage": 0.8405}
JAX_BAND = {"idepth_rmse": 0.05, "recall": 0.02, "coverage": 0.02}
# The TPU v3 kernel's defaults; the port's v3 takes tri_block and
# long_thresh only (it has no block budgets).
V3_DEFAULTS = {"tri_block": 128, "s_blocks": 5, "l_blocks": 4,
               "long_thresh": 64.0}


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


def port_kw(kw):
    """A kernel's keyword arguments without the TPU v3's block budgets."""
    return {k: v for k, v in kw.items() if k not in ("s_blocks", "l_blocks")}


def v3_budgets_hold(rc, args, H, kw):
    """Whether the TPU v3 kernel's block budgets (each clipped to the
    block count) would hold on this mesh, from the port's setup; the JAX
    wrapper runs v2 where they do not
    (flame_ros_tpu/ops/raster_pallas.py:275)."""
    kw = {**V3_DEFAULTS, **kw}
    _, _, nblk_s, long2, B = rc.v3_setup(
        *args, height=H, row_tile=2, tri_block=kw["tri_block"],
        long_thresh=kw["long_thresh"])
    n_blocks = args[1].shape[0] // B
    return (int(nblk_s.max()) <= min(kw["s_blocks"], n_blocks)
            and int(long2[1]) <= min(kw["l_blocks"], n_blocks))


def cuda_median_ms(fn, reps=30, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=20, rounds=5):
    """Device time per call of fn, for a kernel launch that takes the
    host longer to issue than the card to run: `reps` calls queued behind
    a ~1 ms sleep kernel, so the events time the card alone (the gap
    between two back-to-back kernels included); the median of `rounds`.
    cuda_median_ms of one launch also times the host's issue of it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def make_meshes(triangulate, np, H=480, W=640, n=2048, T=4096, seed=0):
    """The phase-3 meshes, padded to T triangles. At 2048 uniform points
    (~4070 triangles) a 2-row tile has up to ~520 short candidates (over
    the TPU kernel's 384 budget); the engine's own topology is sparser
    (~2.6k triangles at VGA), which the 1300-point meshes match. The
    sliver mesh adds sub-pixel triangles (lowest ids) and two flat
    slivers above the mesh whose -1e-3 band reaches 7.7 px and the whole
    row beyond their bounding boxes; the multi-chunk mesh packs 740 more
    points into rows 200-260, so a tile's v4 range spans several staging
    chunks."""
    rng = np.random.default_rng(seed)

    def pad(pts, tris):
        tp = np.zeros((T, 3), np.int32)
        tp[:len(tris)] = tris[:T]
        tv = np.zeros(T, bool)
        tv[:min(len(tris), T)] = True
        pos = np.zeros((max(n, len(pts)), 2), np.float32)
        pos[:len(pts)] = pts
        return pos, tp, tv

    def ccw(p, t):
        a, b, c = (p[i].astype(np.float64) for i in t)
        cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return t if cross > 0 else [t[0], t[2], t[1]]

    def slivers(pts):
        extra, front, back = [], [], []

        def tri(*vs, into):
            i = len(pts) + len(extra)
            extra.extend(vs)
            into.append([i, i + 1, i + 2])

        for cx, cy in ((100, 100), (101, 100), (300, 200), (10, 2),
                       (500.5, 300.5)):
            tri((cx - 0.02, cy - 0.02), (cx + 0.03, cy - 0.01),
                (cx, cy + 0.03), into=front)
        tri((30, 1), (50, 1), (40, np.float32(1) + np.float32(1.3e-4)),
            into=back)
        tri((60, 2), (80, 2),
            (70, np.nextafter(np.float32(2), np.float32(3))), into=back)
        allp = np.concatenate([pts, np.asarray(extra, np.float32)])
        tris = [ccw(allp, t) for t in front] + triangulate(pts).tolist() \
            + [ccw(allp, t) for t in back]
        return pad(allp, np.asarray(tris, np.int32))

    def ysort(mesh):
        pos, tp, tv = mesh
        ymin = pos[tp, 1].min(1)
        ymin[~tv] = 1e9
        order = np.argsort(ymin, kind="stable")
        return pos, tp[order], tv[order]

    pts = rng.uniform(4, [W - 4, H - 4], (n, 2)).astype(np.float32)
    base = pad(pts, triangulate(pts))
    sparse = pts[:1300]
    # A point-free band: triangles bridging it are taller than the
    # 48-pixel long threshold.
    band = sparse[(sparse[:, 1] < 215) | (sparse[:, 1] > 275)]
    empty = (np.zeros((n, 2), np.float32), np.zeros((T, 3), np.int32),
             np.zeros(T, bool))
    dense = np.concatenate([sparse, rng.uniform(
        [4, 200], [W - 4, 260], (740, 2)).astype(np.float32)])
    # Per case, the keyword arguments of each kernel: the forced-fallback
    # case gives v3 budgets too small for the mesh (as in
    # tests/test_raster_pallas.py:97-107); v4 and v2 have none.
    return {"unsorted": (base, {}), "ysorted": (ysort(base), {}),
            "engine_density": (ysort(pad(sparse, triangulate(sparse))), {}),
            "long_triangles": (pad(band, triangulate(band)), {}),
            "forced_fallback": (base, {
                "v3": {"s_blocks": 1, "l_blocks": 1, "tri_block": 32}}),
            "empty": (empty, {}),
            "sliver": (slivers(sparse), {}),
            "multi_chunk": (ysort(pad(dense, triangulate(dense))), {})}


def bare_launch(rc, name, args, H, W, kw, lib=None, rt=2):
    """A launch of the kernel alone, its inputs prepared once (for the
    split of the wrapper's time between setup and kernel), from the
    package's library or `lib`, on tiles of `rt` rows. fn.out is its
    output, fn.slab_bytes the bytes of its inputs."""
    import torch
    lib = lib or rc._get_lib()
    out = torch.empty(H * W, dtype=torch.int32, device=args[0].device)
    work = torch.zeros(len(rc.WORK_SLOTS), dtype=torch.int32,
                       device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    T = args[1].shape[0]
    if name == "v3":
        C, lo_blk, nblk_s, long2, B = rc.v3_setup(
            *args, height=H, row_tile=rt,
            tri_block=kw.get("tri_block", V3_DEFAULTS["tri_block"]),
            long_thresh=kw.get("long_thresh", V3_DEFAULTS["long_thresh"]))
        keep = (C, lo_blk, nblk_s, long2)

        def fn():
            lib.raster_v3_launch(C.data_ptr(), T, lo_blk.data_ptr(),
                                 nblk_s.data_ptr(), long2.data_ptr(), B,
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    elif name == "v4":
        C, lo_pos, hi_pos, counts = rc.v4_setup(
            *args, height=H, row_tile=rt,
            long_thresh=kw.get("long_thresh", 48.0))
        keep = (C, lo_pos, hi_pos, counts)

        def fn():
            lib.raster_v4_launch(C.data_ptr(), T, lo_pos.data_ptr(),
                                 hi_pos.data_ptr(), counts.data_ptr(),
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    else:
        C, bounds, B = rc.v2_setup(*args, height=H, width=W, row_tile=rt,
                                   tri_block=512)
        keep = (C, bounds)

        def fn():
            lib.raster_v2_launch(C.data_ptr(), T, bounds.data_ptr(), B,
                                 out.data_ptr(), H, W, rt, work.data_ptr(),
                                 stream)
    fn.keep = keep
    fn.out = out.reshape(H, W)
    fn.slab_bytes = sum(t.numel() * t.element_size() for t in keep)
    return fn


def y_overlap_tests(torch, pos, tris, tv, H, W, rt=2):
    """The inside tests of a kernel that culls in y only (the measure
    the bound once used): per tile of rt rows, the valid triangles whose
    y-range overlaps it, times its pixels."""
    t = tris.long()
    ys = torch.stack([pos[t[:, k], 1] for k in range(3)], -1)
    ymin = torch.sort(ys.min(-1).values[tv]).values
    ymax = torch.sort(ys.max(-1).values[tv]).values
    y0 = torch.arange(H // rt, device=pos.device, dtype=torch.float32) * rt
    n = (torch.searchsorted(ymin, y0 + rt)
         - torch.searchsorted(ymax, y0)).clamp(min=0)
    return int(n.sum()) * rt * W


def bbox_pairs(torch, pos, tris, tv, H, W):
    """The inside tests the id buffer needs on this data: the (pixel,
    valid triangle) pairs whose pixel lies in the triangle's bounding
    box."""
    t = tris.long()[tv]
    p = pos[t]                                   # [n, 3, 2]
    lo = torch.ceil(p.min(1).values).clamp(min=0)
    hi = torch.floor(p.max(1).values)
    hi = torch.minimum(hi, torch.tensor([W - 1.0, H - 1.0],
                                        device=pos.device))
    n = (hi - lo + 1).clamp(min=0)
    return int((n[:, 0] * n[:, 1]).sum())


def order_split(torch, rc, pos, tris, ids_v4, ids_plain):
    """Pixels where the v4 id buffer and the plain formulation's differ,
    and whether each is explained by their evaluation orders alone: v4's
    answer passes the inside test in v4's order x*a + (y*b + c), the
    plain formulation's passes in its order (x*a + y*b) + c, and one of
    the two triangles passes in one order and fails in the other (a
    pixel within rounding of the -1e-3 band of an edge)."""
    px = (ids_v4 != ids_plain).nonzero()
    if not len(px):
        return 0, True
    y = px[:, 0].to(torch.float32)[:, None]
    x = px[:, 1].to(torch.float32)[:, None]

    def inside(ids, v4_order):
        t = tris[ids.clamp(min=0).long()].long()
        c = [pos[t[:, k]] for k in range(3)]
        ok = ids >= 0
        for p0, p1 in ((c[0], c[1]), (c[1], c[2]), (c[2], c[0])):
            a, b, cc = rc.edge_coeffs(p0, p1)
            a, b, cc = a[:, None], b[:, None], cc[:, None]
            e = x * a + (y * b + cc) if v4_order else (x * a + y * b) + cc
            ok = ok & (e[:, 0] >= rc.EPS)
        return ok

    a = ids_v4[px[:, 0], px[:, 1]]
    b = ids_plain[px[:, 0], px[:, 1]]
    a4, a2, b4, b2 = (inside(i, o) for i in (a, b) for o in (True, False))
    explained = ((a4 | (a < 0)) & (b2 | (b < 0))
                 & ((a4 != a2) | (b4 != b2)))
    return len(px), bool(explained.all())


def drive_main_path(engine, seq, out_dir):
    """run_offline over `seq` with `engine`. Times each frame on the host
    clock from its start to the end of its stats read (a device sync);
    after six non-poseframes spread over the run, recomputes that frame's id
    buffer from the engine's own state with the plain v4 version, which
    must equal it, and with the plain formulation `ops/raster.py::
    rasterize_tri_ids`, which may differ only on pixels that the two
    evaluation orders split (order_split); records whether the TPU v3's
    budgets would hold on that frame's mesh, and keeps the raster's
    inputs.
    Returns (RunResult, ms per frame, checked frame ids, pixels that
    differ from the plain formulation per checked frame, v3 fits per
    checked frame, raster inputs per checked frame, telemetry)."""
    import numpy as np
    import torch
    from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                          synthetic_frames)
    from flame_ros_torch.models.engine import _smooth_pd_setup
    from flame_ros_torch.ops import raster as raster_ops
    from flame_ros_torch.ops import raster_cuda as rc
    cam = engine.cam
    pf_every = engine.params.input.poseframe_subsample_factor
    starts, ends, checked, v3_fits, inputs, split = [], [], [], [], [], []

    def frames():
        for i, f in enumerate(synthetic_frames(seq)):
            if i:
                ends.append(time.perf_counter())
            # After a non-poseframe the state still holds the inputs of
            # that frame's raster (no topology install since). Frames 7,
            # 17, ..., 57: the mesh exists from the second poseframe on.
            if (i - 1) % 10 == 7 and (i - 1) % pf_every != 0:
                st = engine.state
                tri_fresh, _, _ = _smooth_pd_setup(st, params=engine.params)
                _, pvalid = raster_ops.triangle_planes(
                    st.vtx_uv, st.vtx_x, st.tris, tri_fresh)
                args = (st.vtx_uv, st.tris, pvalid)
                kw = dict(height=cam.height, width=cam.width)
                if not torch.equal(rc.rasterize_tri_ids_v4_ref(*args, **kw),
                                   st.last_idmap):
                    raise AssertionError(f"frame {i - 1}: main-path id "
                                         "buffer differs from plain v4")
                n_px, explained = order_split(
                    torch, rc, st.vtx_uv, st.tris, st.last_idmap,
                    raster_ops.rasterize_tri_ids(*args, **kw))
                if not explained:
                    raise AssertionError(
                        f"frame {i - 1}: the id buffer differs from the "
                        "plain formulation beyond evaluation order")
                split.append(n_px)
                checked.append(i - 1)
                inputs.append((st.vtx_uv.clone(), st.tris.clone(), pvalid))
                v3_fits.append(v3_budgets_hold(rc, args, cam.height, {}))
            starts.append(time.perf_counter())
            yield f
        ends.append(time.perf_counter())

    res = run_offline(frames(), cam, engine.params, out_dir=out_dir,
                      engine=engine)
    with open(os.path.join(out_dir, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ms = (np.asarray(ends) - np.asarray(starts)) * 1e3
    return res, ms, checked, split, v3_fits, inputs, recs


def launch_counts(rc, dev):
    """Wrapper launch counts and device work counters, by kernel."""
    return ({"v4": rc.rasterize_tri_ids_v4.launches,
             "v2": rc.rasterize_tri_ids_v2.launches,
             "v3": rc.rasterize_tri_ids_v3.launches},
            dict(zip(rc.WORK_SLOTS, rc.work_counters(dev).tolist())))


def stream_windows(engine, frames, gts, win, depth=2):
    """The streaming loop of bench.py's run_sustained: windows of `win`
    host frames, each prefetched `depth` windows ahead (pinned pack and
    copy-stream upload), dispatched with update_window(prefetched=...),
    and its stats read back (flush_window_stats, one device-to-host copy
    that waits for the window). Returns per window the host seconds from
    the prefetch that starts its iteration to its stats read, and its
    per-frame stats rows."""
    n_win = len(frames) // win

    def prefetch(w):
        s = slice(w * win, (w + 1) * win)
        return engine.prefetch_window(frames[s], gts[s])

    pending = [prefetch(w) for w in range(min(depth, n_win))]
    secs, rows = [], []
    for w in range(n_win):
        t0 = time.perf_counter()
        if w + depth < n_win:
            pending.append(prefetch(w + depth))
        assert engine.update_window(prefetched=pending.pop(0))
        rows.append(engine.flush_window_stats())
        secs.append(time.perf_counter() - t0)
    return secs, rows


def jax_band(res, ref):
    """A run's distance from the JAX package's numbers (rmse relative,
    recall and coverage absolute) and whether each is within JAX_BAND."""
    diff = {"idepth_rmse": abs(res.mean_rmse - ref["idepth_rmse"])
            / ref["idepth_rmse"],
            "recall": abs(res.mean_recall - ref["recall"]),
            "coverage": abs(res.final_coverage - ref["coverage"])}
    return diff, all(diff[k] <= JAX_BAND[k] for k in diff)


def pctl(np, xs, q):
    return float(np.percentile(np.asarray(xs, float), q))


def drive_nodelet(node, seq, n, pace_s=0.0):
    """Push n frames of seq (images and depths stay on the card) from a
    producer thread, every pace_s seconds (0: a burst), while the
    nodelet's consumer thread runs, and wait for every stats record.
    Returns (accepted flags, stats records, meshes' frame ids, heartbeat
    transitions, health before the first and after the last frame)."""
    import threading
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    stats, mesh_ids, beats, accepted = [], [], [], []
    done = threading.Event()

    def on_stats(rec):
        stats.append(rec)
        if len(stats) == n:
            done.set()

    def produce():
        for i in range(n):
            accepted.append(node.push_frame(
                i, float(seq.timestamps[i]), q[i], t[i], seq.images[i],
                seq.depths[i]))
            if pace_s:
                time.sleep(pace_s)

    node.on_stats.append(on_stats)
    node.on_mesh.append(lambda i, _t, _m: mesh_ids.append(i))
    node.on_heartbeat.append(beats.append)
    health0 = node.health
    node.start()
    producer = threading.Thread(target=produce)
    producer.start()
    producer.join()
    if not done.wait(timeout=300):
        raise AssertionError(f"nodelet processed {len(stats)} of {n}")
    health1 = node.health
    node.stop()
    return accepted, stats, mesh_ids, beats, health0, health1


def run_engine(engine, seq, lo, hi, SE3):
    """Frames lo..hi-1 of seq through Flame.update as run_offline feeds
    them (a poseframe every poseframe_subsample_factor frames, GT depth),
    each frame's stats read back. Returns the stats records."""
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    pf_every = engine.params.input.poseframe_subsample_factor
    recs = []
    for i in range(lo, hi):
        assert engine.update(float(seq.timestamps[i]), i,
                             SE3.from_quat_trans(q[i], t[i]), seq.images[i],
                             i % pf_every == 0, gt_depth=seq.depths[i])
        recs.append(engine.flush_stats())
        assert recs[-1]["health"] == 1.0, (i, recs[-1])
    return recs


def serve_round_trip(srv, seq, n):
    """Client 1 streams n uint8 frames to the running server `srv` and
    reads every stats message, then the idepth map; client 2 polls meshes
    meanwhile. Then srv.stop(), and each client must see its connection
    closed. Returns (stats headers, idepth map, the serving engine's own
    map read before stop, meshes polled, connections closed)."""
    import io
    import socket
    import threading
    import numpy as np
    import torch
    from flame_ros_torch.frontends.serve import recv_msg, send_msg
    imgs = torch.clamp(seq.images[:n], 0, 255).to(torch.uint8).cpu().numpy()
    q = seq.poses.q.cpu().numpy()
    t = seq.poses.t.cpu().numpy()
    c1, c2 = (socket.create_connection(("127.0.0.1", srv.port), timeout=60)
              for _ in range(2))
    meshes, polling = [], threading.Event()
    polling.set()

    def poll():
        while polling.is_set():
            send_msg(c2, {"type": "get_mesh"})
            while True:
                h, payload = recv_msg(c2)
                if h is None:
                    return
                if h["type"] == "mesh":
                    meshes.append(dict(np.load(io.BytesIO(payload))))
                    break
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        for i in range(n):
            send_msg(c1, {"type": "frame", "img_id": i,
                          "time": float(seq.timestamps[i]),
                          "quat": q[i].tolist(), "trans": t[i].tolist(),
                          "shape": list(imgs[i].shape), "dtype": "uint8"},
                     imgs[i].tobytes())
        stats = []
        while len(stats) < n:
            h, _ = recv_msg(c1)
            assert h is not None, "server closed the stream early"
            if h["type"] == "stats":
                stats.append(h)
        polling.clear()
        poller.join(60)
        send_msg(c1, {"type": "get_idepth"})
        while True:
            h, payload = recv_msg(c1)
            if h["type"] == "idepth":
                break
        m = np.frombuffer(payload, np.float32).reshape(h["shape"])
        own = srv.node.engine.get_inverse_depth_map()
    finally:
        polling.clear()
        srv.stop()

    def closed(c):
        c.settimeout(20)
        try:
            while recv_msg(c)[0] is not None:
                pass
            return True
        except ConnectionResetError:
            return True
        except OSError:
            return False
        finally:
            c.close()

    return stats, m, own, meshes, [closed(c1), closed(c2)]


def write_tum_asl(seq, cam, root, np, torch):
    """phase 4's frames as a TUM tree (association file, RGB and 16-bit
    depth PNGs, a CameraInfo YAML) and an EuRoC/ASL tree (camera, depth
    and pose sensor folders, identity extrinsics). Returns the paths."""
    import cv2
    import yaml
    n = len(seq)
    g8 = torch.clamp(seq.images, 0, 255).to(torch.uint8).cpu().numpy()
    d16 = np.round(seq.depths.cpu().numpy() * 5000.0).astype(np.uint16)
    q = seq.poses.q.cpu().numpy().astype(np.float64)
    t = seq.poses.t.cpu().numpy().astype(np.float64)
    tum = os.path.join(root, "tum")
    asl = os.path.join(root, "asl", "mav0")
    dirs = {k: os.path.join(asl, k) for k in
            ("cam0", "depth0", "state_groundtruth_estimate0")}
    for d in (os.path.join(tum, "rgb"), os.path.join(tum, "depth"),
              os.path.join(dirs["cam0"], "data"),
              os.path.join(dirs["depth0"], "data"),
              dirs["state_groundtruth_estimate0"]):
        os.makedirs(d, exist_ok=True)
    eye = {"rows": 4, "cols": 4, "data": np.eye(4).ravel().tolist()}
    K = cam.K.astype(np.float64)
    with open(os.path.join(tum, "calib.yaml"), "w") as f:
        yaml.safe_dump({
            "image_width": cam.width, "image_height": cam.height,
            "camera_matrix": {"rows": 3, "cols": 3,
                              "data": K.ravel().tolist()},
            "projection_matrix": {
                "rows": 3, "cols": 4,
                "data": np.hstack([K, np.zeros((3, 1))]).ravel().tolist()},
            "distortion_coefficients": {"rows": 1, "cols": 5,
                                        "data": [0.0] * 5}}, f)
    for k, meta in (("cam0", {"sensor_type": "camera", "T_BS": eye,
                              "intrinsics": [cam.fx, cam.fy, cam.cx, cam.cy],
                              "resolution": [cam.width, cam.height],
                              "distortion_coefficients": [0.0] * 4}),
                    ("depth0", {"sensor_type": "camera", "T_BS": eye,
                                "depth_scale_factor": 5000.0}),
                    ("state_groundtruth_estimate0",
                     {"sensor_type": "visual-inertial", "T_BS": eye})):
        with open(os.path.join(dirs[k], "sensor.yaml"), "w") as f:
            yaml.safe_dump(meta, f)
    lines, cam_rows, pose_rows = [], [], []
    for i in range(n):
        ts = float(seq.timestamps[i])
        ns = 1_000_000_000 + round(ts * 1e9)
        rgb = np.repeat(g8[i][..., None], 3, -1)
        cv2.imwrite(os.path.join(tum, "rgb", f"{i}.png"), rgb)
        cv2.imwrite(os.path.join(tum, "depth", f"{i}.png"), d16[i])
        cv2.imwrite(os.path.join(dirs["cam0"], "data", f"{ns}.png"), g8[i])
        cv2.imwrite(os.path.join(dirs["depth0"], "data", f"{ns}.png"),
                    d16[i])
        # Shortest round-trip decimal of each value.
        qw, qx, qy, qz, tx, ty, tz = (repr(float(v))
                                      for v in (*q[i], *t[i]))
        lines.append(f"{ts!r} {tx} {ty} {tz} {qx} {qy} {qz} {qw} "
                     f"{ts!r} rgb/{i}.png {ts!r} depth/{i}.png")
        cam_rows.append(f"{ns},{ns}.png")
        pose_rows.append(f"{ns},{tx},{ty},{tz},{qw},{qx},{qy},{qz}")
    with open(os.path.join(tum, "assoc.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for k, rows in (("cam0", cam_rows), ("depth0", cam_rows),
                    ("state_groundtruth_estimate0", pose_rows)):
        with open(os.path.join(dirs[k], "data.csv"), "w") as f:
            f.write("#timestamp,data\n" + "\n".join(rows) + "\n")
    return (os.path.join(tum, "assoc.txt"), os.path.join(tum, "calib.yaml"),
            dirs["state_groundtruth_estimate0"], dirs["cam0"],
            dirs["depth0"])


def live_frontend(seq, recs4, res4, params, cam, dev, out):
    """Phase 7 over phase 4's sequence `seq`, whose per-frame telemetry
    is recs4 and whose RunResult is res4."""
    import contextlib
    import io
    import numpy as np
    import torch
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.eval.metrics import TruthStats
    from flame_ros_torch.frontends import offline_runner
    from flame_ros_torch.frontends.nodelet import FlameNodelet, Health
    from flame_ros_torch.frontends.serve import FlameServer
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.models.engine import Flame, state_to_numpy
    from flame_ros_torch.ops import raster_cuda as rc
    n = len(seq)

    def counts_ok(min_frames):
        launches, work = launch_counts(rc, dev)
        assert launches["v4"] >= min_frames, launches
        assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
        return launches, work

    # (a) nodelet: a burst from a producer thread, then camera rate.
    keys = ("idepth_rmse", "true_pos", "false_pos", "false_neg", "coverage",
            "num_tris")
    node = FlameNodelet(cam, params, queue_size=n, eval_gt_depth=True,
                        device=dev)
    rc.reset_counters()
    accepted, stats, mesh_ids, beats, h0, h1 = drive_nodelet(node, seq, n)
    launches_a, work_a = counts_ok(n)
    assert all(accepted) and node.queue.num_dropped == 0, accepted
    assert [r["img_id"] for r in stats] == list(range(n))
    assert mesh_ids == list(range(n)), mesh_ids
    assert h0 == Health.READY and h1 == Health.READY, (h0, h1, beats)
    assert Health.FAIL not in beats, beats
    differ = [(i, k) for i, (a, b) in enumerate(zip(stats, recs4))
              for k in keys if a[k] != b[k]]
    assert not differ, f"nodelet != phase 4 at (frame, key) {differ[:8]}"
    truth = [TruthStats.from_record(r) for r in stats]
    node_p = FlameNodelet(cam, params, queue_size=n, eval_gt_depth=True,
                          device=dev)
    accepted_p, stats_p, _, beats_p, _, h1_p = drive_nodelet(
        node_p, seq, n, pace_s=1.0 / 30)
    assert all(accepted_p) and len(stats_p) == n
    steady, steady_p = stats[5:], stats_p[5:]
    phase("live_nodelet", frames=len(stats), dropped=node.queue.num_dropped,
          health_start=h0.name, health_end=h1.name,
          heartbeats=[b.name for b in beats],
          equal_to_main_path_keys=list(keys),
          mean_rmse=float(np.nanmean([t.rmse for t in truth])),
          mean_recall=float(np.nanmean([t.recall for t in truth])),
          final_coverage=stats[-1]["coverage"],
          main_path_mean_rmse=res4.mean_rmse,
          main_path_mean_recall=res4.mean_recall,
          main_path_final_coverage=res4.final_coverage,
          process_frame_ms_p50=pctl(np, [r["process_frame_ms"]
                                         for r in steady], 50),
          process_frame_ms_p95=pctl(np, [r["process_frame_ms"]
                                         for r in steady], 95),
          latency_ms_p50=pctl(np, [r["latency_ms"] for r in steady], 50),
          latency_ms_p95=pctl(np, [r["latency_ms"] for r in steady], 95),
          fps_end=stats[-1]["fps"], launches=launches_a, work=work_a,
          paced_fps_in=30, paced_dropped=node_p.queue.num_dropped,
          paced_health_end=h1_p.name,
          paced_heartbeats=[b.name for b in beats_p],
          paced_process_frame_ms_p50=pctl(
              np, [r["process_frame_ms"] for r in steady_p], 50),
          paced_process_frame_ms_p95=pctl(
              np, [r["process_frame_ms"] for r in steady_p], 95),
          paced_latency_ms_p50=pctl(np, [r["latency_ms"] for r in steady_p],
                                    50),
          paced_latency_ms_p95=pctl(np, [r["latency_ms"] for r in steady_p],
                                    95))

    # (b) pose-graph edits and a checkpoint at frame 30.
    mid = n // 2
    ckpt = os.path.join(out, f"frame{mid}.npz")
    rc.reset_counters()
    eng_a = Flame(cam.width, cam.height, cam=cam, params=params, device=dev)
    recs_a = run_engine(eng_a, seq, 0, mid, SE3)
    eng_a.save_checkpoint(ckpt)
    eng_b = Flame(cam.width, cam.height, cam=cam, params=params, device=dev)
    eng_b.load_checkpoint(ckpt)
    sa, sb = state_to_numpy(eng_a.state), state_to_numpy(eng_b.state)
    assert all(np.array_equal(sa[k], sb[k]) for k in sa), "load != save"
    node_c = FlameNodelet(cam, params, device=dev)
    node_c.engine.load_checkpoint(ckpt)
    s0 = state_to_numpy(node_c.engine.state)
    slots = np.flatnonzero(s0["kf_valid"])
    slots = slots[np.argsort(s0["kf_ids"][slots])]
    ids = s0["kf_ids"][slots]
    tau = [0.01, -0.005, 0.002, 0.002, -0.001, 0.003]
    step = SE3.exp(np.array(tau, np.float32))
    moved = SE3(torch.from_numpy(s0["kf_q"][slots]),
                torch.from_numpy(s0["kf_t"][slots])) @ step
    node_c.poseframe_callback(ids, moved)
    s1 = state_to_numpy(node_c.engine.state)
    want = {k: s0[k].copy() for k in ("kf_q", "kf_t")}
    want["kf_q"][slots] = moved.q.numpy()
    want["kf_t"][slots] = moved.t.numpy()
    for k in ("kf_q", "kf_t"):
        assert np.array_equal(s1[k], want[k]), k
    for k in ("kf_valid", "feat.valid"):
        assert np.array_equal(s1[k], s0[k]), k
    node_c.poseframe_callback(ids[1:], SE3(moved.q[1:], moved.t[1:]))
    s2 = state_to_numpy(node_c.engine.state)
    dead = ~np.isin(s1["kf_ids"], ids[1:])
    assert np.array_equal(s2["kf_valid"], s1["kf_valid"] & ~dead)
    assert np.array_equal(s2["feat.valid"],
                          s1["feat.valid"] & ~dead[s1["feat.kf_idx"]])
    for k in ("kf_q", "kf_t"):
        assert np.array_equal(s2[k], s1[k]), k
    assert node_c._pf_subsample == int(ids[1] - ids[0])
    recs_c = run_engine(node_c.engine, seq, mid, n, SE3)
    recs_a += run_engine(eng_a, seq, mid, n, SE3)
    recs_b = run_engine(eng_b, seq, mid, n, SE3)
    launches_b, work_b = counts_ok(n + 2 * (n - mid))
    assert torch.equal(eng_a.state.last_idmap, eng_b.state.last_idmap)
    ia, ib = eng_a.get_inverse_depth_map(), eng_b.get_inverse_depth_map()
    assert np.array_equal(ia, ib, equal_nan=True), "resumed idepth differs"
    sa, sb = state_to_numpy(eng_a.state), state_to_numpy(eng_b.state)
    state_differs = [k for k in sa if not np.array_equal(sa[k], sb[k])]
    phase("live_posegraph_checkpoint", checkpoint_frame=mid,
          checkpoint_bytes=os.path.getsize(ckpt),
          live_poseframe_ids=ids.tolist(),
          moved_step=tau,
          pruned_id=int(ids[0]),
          features_killed=int(s1["feat.valid"].sum() - s2["feat.valid"].sum()),
          edits_equal_numpy=True, resumed_idmap_equal=True,
          resumed_idepth_equal=True, resumed_state_differs=state_differs,
          uninterrupted_equals_main_path=all(
              a[k] == b[k] for a, b in zip(recs_a, recs4) for k in keys),
          edited_mean_rmse_after=float(np.nanmean(
              [TruthStats.from_record(r).rmse for r in recs_c])),
          uninterrupted_mean_rmse_after=float(np.nanmean(
              [TruthStats.from_record(r).rmse for r in recs_a[mid:]])),
          launches=launches_b, work=work_b)

    # (c) the server on 127.0.0.1.
    n_srv = min(30, n)
    srv = FlameServer(cam, params, port=0, queue_size=n_srv + 2, device=dev)
    rc.reset_counters()
    t0 = time.perf_counter()
    srv.start()
    warmup_s = time.perf_counter() - t0
    sstats, m, own, meshes, closed = serve_round_trip(srv, seq, n_srv)
    launches_c, work_c = counts_ok(n_srv)
    assert [h["img_id"] for h in sstats] == list(range(n_srv))
    assert np.array_equal(m, own, equal_nan=True), "idepth over the wire"
    assert meshes and all(
        {"vertices_px", "idepths", "normals", "triangles", "tri_validity",
         "edges", "K"} <= set(x) for x in meshes)
    assert np.array_equal(meshes[-1]["K"], cam.K)
    assert closed == [True, True], closed
    assert all(a[k] == b[k] for a, b in zip(sstats, recs4)
               for k in ("coverage", "num_tris")), "server != phase 4"
    phase("live_server", frames=len(sstats), warmup_s=warmup_s,
          meshes_polled=len(meshes),
          idepth_equal=True, connections_closed_on_stop=closed,
          coverage_equals_main_path=True,
          process_frame_ms_p50=pctl(np, [h["process_frame_ms"]
                                         for h in sstats[5:]], 50),
          latency_ms_p50=pctl(np, [h["latency_ms"] for h in sstats[5:]],
                              50),
          launches=launches_c, work=work_c)

    # (d) patch-mode epipolar and the truth harness against the JAX runs.
    patch = FlameParams.from_yaml(os.path.join(REPO, "cfg",
                                               "epipolar_patch.yaml"))
    assert patch.engine.epipolar_mode == "patch"
    rows = {}
    for name, prm, truth_in, ref in (("patch", patch, False, JAX_PATCH_VGA),
                                     ("truth", params, True, JAX_TRUTH_VGA)):
        rc.reset_counters()
        r = offline_runner.run_offline(
            offline_runner.synthetic_frames(seq), cam, prm,
            pass_in_truth=truth_in, device=dev)
        launches_d, work_d = counts_ok(n)
        diff, ok = jax_band(r, ref)
        assert r.frames_processed == n and r.frames_failed == 0, r
        assert ok, (name, r, diff)
        rows[name] = dict(mean_rmse=r.mean_rmse, mean_recall=r.mean_recall,
                          mean_precision=r.mean_precision,
                          final_coverage=r.final_coverage,
                          final_abs_rel=r.final_abs_rel,
                          final_delta1=r.final_delta1, jax_cpu=ref,
                          diff=diff, launches=launches_d, work=work_d)
    phase("live_patch_truth", band=JAX_BAND, **rows)

    # (e) the TUM and ASL loaders and CLI routes.
    assoc, calib, pose_dir, rgb_dir, depth_dir = write_tum_asl(
        seq, cam, os.path.join(out, "datasets"), np, torch)
    runs = {}
    for name, fn, argv in (
            ("tum", offline_runner.main_tum,
             ["--input", assoc, "--calib", calib]),
            ("asl", offline_runner.main_asl,
             ["--pose-path", pose_dir, "--rgb-path", rgb_dir,
              "--depth-path", depth_dir])):
        rc.reset_counters()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            r = fn(argv + ["--device", str(dev)])
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        launches_e, work_e = counts_ok(n)
        assert set(summary) == {"frames", "failed", "fps", "idepth_rmse",
                                "precision", "recall", "coverage",
                                "abs_rel", "delta1"}, summary
        assert r.frames_processed == n and r.frames_failed == 0, r
        runs[name] = (r, summary, launches_e, work_e)
    rt, ra = runs["tum"][0], runs["asl"][0]
    assert (rt.mean_rmse, rt.mean_recall, rt.final_coverage) == \
        (ra.mean_rmse, ra.mean_recall, ra.final_coverage), (rt, ra)
    # Same images and poses as phase 4; only the depth is quantized to
    # 1/5000 m, which moves the GT metrics and not the state.
    assert rt.final_coverage == res4.final_coverage, (rt, res4)
    assert abs(rt.mean_rmse - res4.mean_rmse) <= 0.01 * res4.mean_rmse
    phase("live_datasets", **{k: dict(summary=s, launches=la, work=w)
                              for k, (_, s, la, w) in runs.items()},
          tum_equals_asl=True, coverage_equals_main_path=True,
          rmse_rel_diff_main_path=abs(rt.mean_rmse - res4.mean_rmse)
          / res4.mean_rmse)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import flame_ros_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the flame_ros_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    import numpy as np
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence
    from flame_ros_torch.eval.metrics import TruthStats
    from flame_ros_torch.frontends.offline_runner import (
        run_offline, run_offline_windowed, synthetic_frames)
    from flame_ros_torch.geometry.camera import Pinhole
    from flame_ros_torch.geometry.se3 import SE3
    from flame_ros_torch.graph.delaunay import native_available, triangulate
    from flame_ros_torch.models.engine import Flame, state_to_numpy
    from flame_ros_torch.ops import raster_cuda as rc
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")

    # 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    max_sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    phase("environment", card=smi, kind=kind, max_sm_clock=max_sm_clock,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          tf32_matmul=False, tf32_cudnn=False)

    # 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    so = rc.build(force=True)
    t_nvcc = time.perf_counter() - t0
    rc._get_lib()
    t0 = time.perf_counter()
    assert native_available(), "native Delaunay failed to build"
    phase("build", library=os.path.relpath(so, REPO),
          nvcc_seconds=round(t_nvcc, 3),
          delaunay_seconds=round(time.perf_counter() - t0, 3))

    # 3. kernels vs plain versions -------------------------------------
    H, W = VGA.height, VGA.width
    meshes = make_meshes(triangulate, np, H, W)
    names = ("v4", "v2", "v3")
    funcs = {"v4": (rc.rasterize_tri_ids_v4, rc.rasterize_tri_ids_v4_ref),
             "v2": (rc.rasterize_tri_ids_v2, rc.rasterize_tri_ids_v2_ref),
             "v3": (rc.rasterize_tri_ids_v3, rc.rasterize_tri_ids_v3_ref)}
    rows = {n: {} for n in names}
    max_err = {n: 0 for n in names}
    for case, ((pos, tp, tv), kws) in meshes.items():
        args = [torch.from_numpy(a).to(dev) for a in (pos, tp, tv)]
        fits3 = v3_budgets_hold(rc, args, H, kws.get("v3", {}))
        if case == "forced_fallback":
            assert not fits3
        _, lo_pos, hi_pos, counts = rc.v4_setup(*args, height=H, row_tile=2,
                                                long_thresh=48.0)
        n_short, n_live = counts.tolist()
        v4_range = int((hi_pos - lo_pos).max()) + n_live - n_short
        if case == "multi_chunk":
            assert v4_range > 2 * rc.STAGE_CHUNK, v4_range
        pairs = bbox_pairs(torch, *args, H, W)
        outs = {}
        for name in names:
            kern, ref = funcs[name]
            kk = port_kw(kws.get(name, {}))
            rc.reset_counters()
            out = kern(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            one_call, work = launch_counts(rc, dev)
            outs[name] = out
            plain = ref(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            err = int((out.long() - plain.long()).abs().max())
            max_err[name] = max(max_err[name], err)
            if not torch.equal(out, plain):
                raise AssertionError(
                    f"{name} kernel != plain on {case}: "
                    f"{int((out != plain).sum())} pixels differ")
            # One launch of the kernel called, none of another, whatever
            # the TPU v3's budgets would have done.
            expect = {n: int(n == name) for n in names}
            assert one_call == expect and work == expect, \
                (case, name, one_call, work)
            eq_v2 = name == "v3" and bool(torch.equal(out, outs["v2"]))
            if name == "v3" and not (fits3 or eq_v2):
                # Where the JAX wrapper answers with v2, so must v3.
                raise AssertionError(
                    f"v3 != v2 on {case} (TPU budgets overflow): "
                    f"{int((out != outs['v2']).sum())} pixels differ")
            ms = cuda_median_ms(lambda: kern(*args, height=H, width=W, **kk))
            bare = bare_launch(rc, name, args, H, W, kk)
            kernel_ms = cuda_median_ms(bare)
            kernel_dev_ms = device_ms(bare)
            plain_ms = cuda_median_ms(
                lambda: ref(*args, height=H, width=W, **kk), reps=5,
                warmup=1)
            b_ops = pairs * INSTR_PER_TEST[name] / F32_INSTR_RATE * 1e3
            b_bytes = (bare.slab_bytes + H * W * 4) / PEAK_BYTES * 1e3
            rows[name][case] = dict(
                ms=ms, kernel_only_ms=kernel_ms,
                kernel_device_ms=kernel_dev_ms, plain_ms=plain_ms,
                bound_ms=max(b_ops, b_bytes),
                bound_by="operations" if b_ops >= b_bytes else "bytes",
                bound_ops_ms=b_ops, bound_bytes_ms=b_bytes,
                bbox_pairs=pairs,
                candidate_tests=y_overlap_tests(torch, *args, H, W),
                v4_max_tile_range=v4_range,
                fits=fits3 if name == "v3" else None,
                equals_v2=eq_v2 if name == "v3" else None, work=work,
                covered=float((out >= 0).float().mean()))
            phase("kernel", kernel=name, case=case, equal=True,
                  **rows[name][case])

    # 4. the main path -------------------------------------------------
    n_frames = 60
    params = FlameParams()
    t0 = time.perf_counter()
    seq = make_sequence(n_frames, VGA, motion="strafe", scene="room",
                        device=dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    engine = Flame(W, H, cam=VGA, params=params, device=dev)
    assert engine.params.engine.use_pallas_raster is True
    assert engine.params.engine.pallas_raster_kernel == "v4"
    rc.reset_counters()
    res, ms, checked, split, v3_fits, inputs, recs = drive_main_path(
        engine, seq, OUT)
    launches, work = launch_counts(rc, dev)
    assert res.frames_processed == n_frames and res.frames_failed == 0
    health = [r["health"] for r in recs]
    assert len(health) == n_frames and all(h == 1.0 for h in health), health
    assert launches["v4"] >= n_frames, launches
    assert launches["v2"] == 0 and launches["v3"] == 0, launches
    assert work == {"v4": launches["v4"], "v2": 0, "v3": 0}, work
    assert len(checked) == 6, checked
    # The v4 and v2 kernels on the checked frames' inputs: each equal to
    # its plain version; kernel-only (one launch, and back to back on the
    # card) and wrapper medians per frame.
    frame_ms = {"v4": [], "v2": []}
    for args in inputs:
        for name in frame_ms:
            kern, ref = funcs[name]
            out = kern(*args, height=H, width=W)
            if not torch.equal(out, ref(*args, height=H, width=W)):
                raise AssertionError(f"{name} kernel != plain on a "
                                     "main-path frame")
            bare = bare_launch(rc, name, args, H, W, {})
            frame_ms[name].append({
                "kernel_only_ms": cuda_median_ms(bare),
                "kernel_device_ms": device_ms(bare),
                "ms": cuda_median_ms(
                    lambda: kern(*args, height=H, width=W)),
                "bbox_pairs": bbox_pairs(torch, *args, H, W)})
    assert np.isfinite(res.mean_rmse) and res.mean_rmse < 0.1, res
    assert res.final_coverage > 0.3, res
    steady = ms[5:]
    phase("main_path", frames=res.frames_processed,
          render_s=round(t_render, 3),
          ms_per_frame_p50=float(np.percentile(steady, 50)),
          ms_per_frame_p95=float(np.percentile(steady, 95)),
          ms_first_frame=float(ms[0]),
          mean_rmse=res.mean_rmse, mean_precision=res.mean_precision,
          mean_recall=res.mean_recall, final_coverage=res.final_coverage,
          final_abs_rel=res.final_abs_rel, final_delta1=res.final_delta1,
          launches=launches, work=work, idmap_checked_frames=checked,
          idmap_order_split_px=split,
          v3_fits_checked_frames=v3_fits,
          checked_frame_times=frame_ms,
          num_tris_last=recs[-1]["num_tris"])

    # 5. the windowed streaming path -----------------------------------
    # (a) windows of 6, synchronous triangulation, the phase-4 sequence,
    # against the JAX package's CPU run of it.
    out_a = os.path.join(OUT, "window_sync")
    os.makedirs(out_a, exist_ok=True)
    eng_a = Flame(W, H, cam=VGA, params=params, device=dev)
    rc.reset_counters()
    t0 = time.perf_counter()
    res_a = run_offline_windowed(synthetic_frames(seq), VGA, params,
                                 out_dir=out_a, window=6, engine=eng_a)
    wall_a = time.perf_counter() - t0
    launches_a, work_a = launch_counts(rc, dev)
    with open(os.path.join(out_a, "telemetry.jsonl")) as f:
        health_a = [json.loads(line)["health"] for line in f]
    assert res_a.frames_processed == n_frames and res_a.frames_failed == 0
    assert health_a == [1.0] * n_frames, health_a
    assert launches_a["v4"] >= n_frames, launches_a
    assert launches_a["v2"] == 0 and launches_a["v3"] == 0, launches_a
    assert work_a == {"v4": launches_a["v4"], "v2": 0, "v3": 0}, work_a
    ref = JAX_WINDOWED_VGA
    band = {"rmse_rel_diff": abs(res_a.mean_rmse - ref["idepth_rmse"])
            / ref["idepth_rmse"],
            "coverage_diff": abs(res_a.final_coverage - ref["coverage"])}
    assert band["rmse_rel_diff"] <= 0.15 and band["coverage_diff"] <= 0.05, \
        (res_a, band)

    # (b) streaming: host frames, prefetch depth 2, deferred triangulation.
    n_b, win = 120, 6
    seq_b = make_sequence(n_b, VGA, motion="strafe", scene="room",
                          device=dev)
    imgs_b = torch.clamp(seq_b.images, 0, 255).to(torch.uint8).cpu().numpy()
    q_b = seq_b.poses.q.cpu().numpy()
    t_b = seq_b.poses.t.cpu().numpy()
    frames_b = [(float(seq_b.timestamps[i]), i,
                 SE3.from_quat_trans(q_b[i], t_b[i]), imgs_b[i], i % 6 == 0)
                for i in range(n_b)]
    eng_b = Flame(W, H, cam=VGA, params=params, device=dev,
                  deferred_triangulation=True)
    rc.reset_counters()
    secs, wrows = stream_windows(eng_b, frames_b, seq_b.depths, win)
    launches_b, work_b = launch_counts(rc, dev)
    pending_at_end = len(eng_b._pending_tri)
    eng_b._apply_pending_triangulation(block=True)
    eng_b.shutdown()
    health_b = [r["health"] for rs in wrows for r in rs]
    assert len(health_b) == n_b and all(h == 1.0 for h in health_b)
    assert eng_b.num_failed_frames == 0
    assert launches_b["v4"] >= n_b, launches_b
    assert launches_b["v2"] == 0 and launches_b["v3"] == 0, launches_b
    assert work_b == {"v4": launches_b["v4"], "v2": 0, "v3": 0}, work_b
    covs = [rs[-1]["coverage"] for rs in wrows]
    cov_steady = covs[4:]               # after the map build-up
    assert max(cov_steady) > 0.4, covs
    assert min(cov_steady) > 0.5 * max(cov_steady), covs
    w_steady = 2                        # timing: after allocator warm-up
    ms_frame = np.asarray(secs[w_steady:]) * 1e3 / win
    truth = [TruthStats.from_record(r) for rs in wrows[4:] for r in rs]
    # The per-frame path over the same frames, for the steady accuracy
    # of the two paths on the same frames (windows 4 on).
    eng_f = Flame(W, H, cam=VGA, params=params, device=dev)
    truth_f = []
    for i, f in enumerate(frames_b):
        assert eng_f.update(*f, gt_depth=seq_b.depths[i])
        rec = eng_f.flush_stats()
        if i >= 4 * win:
            truth_f.append(TruthStats.from_record(rec))
    # The copy-stream upload changes nothing: with synchronous
    # triangulation, prefetched windows leave the state bit for bit as
    # plain update_window calls do.
    eng_p, eng_q = (Flame(W, H, cam=VGA, params=params, device=dev)
                    for _ in range(2))
    n_cmp = 4 * win
    stream_windows(eng_p, frames_b[:n_cmp], seq_b.depths[:n_cmp], win)
    for w in range(0, n_cmp, win):
        assert eng_q.update_window(frames_b[w:w + win],
                                   seq_b.depths[w:w + win])
    sp, sq = state_to_numpy(eng_p.state), state_to_numpy(eng_q.state)
    differ = [k for k in sp if not np.array_equal(sp[k], sq[k],
                                                  equal_nan=True)]
    assert not differ, f"prefetched != plain in {differ}"
    phase("window_path",
          sync_frames=res_a.frames_processed, sync_wall_s=wall_a,
          sync_mean_rmse=res_a.mean_rmse,
          sync_mean_precision=res_a.mean_precision,
          sync_mean_recall=res_a.mean_recall,
          sync_final_coverage=res_a.final_coverage,
          sync_final_abs_rel=res_a.final_abs_rel,
          sync_final_delta1=res_a.final_delta1, sync_jax_cpu=ref,
          sync_band=band, sync_launches=launches_a, sync_work=work_a,
          stream_frames=n_b, stream_window=win, stream_prefetch_depth=2,
          stream_ms_per_frame_p50=float(np.percentile(ms_frame, 50)),
          stream_ms_per_frame_p95=float(np.percentile(ms_frame, 95)),
          stream_frames_per_s=float(len(ms_frame) * win
                                    / np.sum(secs[w_steady:])),
          stream_coverage_per_window=covs,
          stream_topo_installs=eng_b._topo_installs,
          stream_tri_superseded=eng_b._tri_superseded,
          stream_tri_dropped=eng_b._tri_dropped,
          stream_stale_tri_windows=eng_b._stale_tri_windows,
          stream_pending_at_end=pending_at_end,
          stream_steady_mean_rmse=float(np.nanmean(
              [t.rmse for t in truth])),
          stream_steady_mean_recall=float(np.nanmean(
              [t.recall for t in truth])),
          perframe_steady_mean_rmse=float(np.nanmean(
              [t.rmse for t in truth_f])),
          perframe_steady_mean_recall=float(np.nanmean(
              [t.recall for t in truth_f])),
          prefetch_equals_plain_frames=n_cmp,
          stream_perf_s=eng_b.perf, stream_launches=launches_b,
          stream_work=work_b)

    # 6. small-input agreement: card path vs CPU path --------------------
    cam = Pinhole(105.0, 105.0, 63.5, 47.5, 128, 96)
    small = FlameParams.from_dict({"engine": {"max_features": 256,
                                              "max_keyframes": 4}})
    sseq = make_sequence(10, cam, device="cpu")
    r_gpu = run_offline(synthetic_frames(sseq), cam, small, device=dev)
    r_cpu = run_offline(synthetic_frames(sseq), cam, small, device="cpu")
    assert abs(r_gpu.mean_rmse - r_cpu.mean_rmse) <= 0.15 * r_cpu.mean_rmse
    assert abs(r_gpu.final_coverage - r_cpu.final_coverage) <= 0.05
    phase("small_agreement", rmse_gpu=r_gpu.mean_rmse,
          rmse_cpu=r_cpu.mean_rmse, coverage_gpu=r_gpu.final_coverage,
          coverage_cpu=r_cpu.final_coverage)

    # 7. the live frontend ---------------------------------------------
    live_frontend(seq, recs, res, params, VGA, dev, OUT)

    # Result lines -----------------------------------------------------
    replaces = {"v4": "flame_ros_tpu/ops/raster_pallas.py:458",
                "v2": "flame_ros_tpu/ops/raster_pallas.py:128",
                "v3": "flame_ros_tpu/ops/raster_pallas.py:288"}
    kernels = []
    for name in names:
        r = rows[name]["engine_density"]   # y-sorted, as the engine's
        kernels.append({
            "name": f"raster_{name}", "route": "cuda",
            "source": "flame_ros_torch/csrc/raster.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
