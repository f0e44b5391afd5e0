#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (flame_ros_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one line:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, TF32 off;
2. kernel build: csrc/raster.cu compiled from this checkout with nvcc;
3. kernels vs plain versions at VGA with T = 4096 triangle slots
   (Delaunay of 2048 seeded random points, and of 1300 of them for the
   engine's density): the v4 and v2 raster kernels must equal their plain
   PyTorch versions bit for bit on an unsorted, a y-sorted, an
   engine-density, a long-triangle, a forced-fallback and an empty mesh;
   kernel, plain and bound times (CUDA events, medians);
4. the main path: `run_offline` at VGA with the default FlameParams over
   60 frames rendered on the card — health on every frame, the v4 kernel
   launched on every frame, the id buffer of several frames recomputed by
   the plain version from the engine's own state, ms/frame and accuracy;
5. small-input agreement: the same 96x128 frames through the card path
   (CUDA kernels) and the CPU path (plain versions).

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
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_TEST = 12      # 3 edges x (2 multiplies + 2 adds)


def phase(name, **kv):
    print(json.dumps({"phase": name, **kv}), flush=True)


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


def make_meshes(triangulate, np, H=480, W=640, n=2048, T=4096, seed=0):
    """The phase-3 meshes, padded to T triangles. At 2048 uniform points
    (~4070 triangles) a 2-row tile has up to ~520 short candidates, over
    v4's 384 budget, so v4 hands those frames to v2; the engine's own
    topology is sparser (~2.6k triangles at VGA), which the 1300-point
    meshes match."""
    rng = np.random.default_rng(seed)

    def pad(pts, tris):
        tp = np.zeros((T, 3), np.int32)
        tp[:len(tris)] = tris[:T]
        tv = np.zeros(T, bool)
        tv[:min(len(tris), T)] = True
        pos = np.zeros((n, 2), np.float32)
        pos[:len(pts)] = pts
        return pos, tp, tv

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
    return {"unsorted": (base, {}), "ysorted": (ysort(base), {}),
            "engine_density": (ysort(pad(sparse, triangulate(sparse))), {}),
            "long_triangles": (pad(band, triangulate(band)), {}),
            "forced_fallback": (base, {"cand_s": 128,
                                       "long_thresh": 1000.0}),
            "empty": (empty, {})}


def bare_launch(rc, name, args, H, W, kw):
    """A launch of the kernel alone, its inputs prepared once (for the
    split of the wrapper's time between setup and kernel)."""
    import torch
    lib = rc._get_lib()
    out = torch.empty(H * W, dtype=torch.int32, device=args[0].device)
    work = torch.zeros(2, dtype=torch.int32, device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    T = args[1].shape[0]
    if name == "v4":
        cs, cl = min(kw.get("cand_s", 384), T), min(128, T)
        M, lo_pos, _, counts, fits = rc.v4_setup(
            *args, height=H, row_tile=2, cand_s=kw.get("cand_s", 384),
            cand_l=128, long_thresh=kw.get("long_thresh", 48.0))
        keep = (M, lo_pos, counts, fits, out, work)

        def fn():
            lib.raster_v4_launch(M.data_ptr(), T, lo_pos.data_ptr(),
                                 counts.data_ptr(), fits.data_ptr(),
                                 out.data_ptr(), H, W, 2, cs, cl,
                                 work.data_ptr(), stream)
    else:
        C, bounds, B = rc.v2_setup(*args, height=H, width=W, row_tile=2,
                                   tri_block=512)
        keep = (C, bounds, out, work)

        def fn():
            lib.raster_v2_launch(C.data_ptr(), T, bounds.data_ptr(), B,
                                 None, out.data_ptr(), H, W, 2,
                                 work.data_ptr(), stream)
    fn.keep = keep
    return fn


def needed_tests(torch, pos, tris, tv, H, W, rt=2):
    """Candidate tests the id buffer needs on this data: per tile of rt
    rows, the valid triangles whose y-range overlaps it, times its
    pixels."""
    t = tris.long()
    ys = torch.stack([pos[t[:, k], 1] for k in range(3)], -1)
    ymin = torch.sort(ys.min(-1).values[tv]).values
    ymax = torch.sort(ys.max(-1).values[tv]).values
    y0 = torch.arange(H // rt, device=pos.device, dtype=torch.float32) * rt
    n = (torch.searchsorted(ymin, y0 + rt)
         - torch.searchsorted(ymax, y0)).clamp(min=0)
    return int(n.sum()) * rt * W


def drive_main_path(engine, seq, out_dir):
    """run_offline over `seq` with `engine`. Times each frame on the host
    clock from its start to the end of its stats read (a device sync);
    after each non-poseframe, recomputes that frame's id buffer with the
    plain v4 version from the engine's own state and checks equality.
    Returns (RunResult, ms per frame, checked frame ids, telemetry)."""
    import numpy as np
    import torch
    from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                          synthetic_frames)
    from flame_ros_torch.models.engine import _smooth_pd_setup
    from flame_ros_torch.ops import raster as raster_ops
    from flame_ros_torch.ops import raster_cuda as rc
    cam = engine.cam
    pf_every = engine.params.input.poseframe_subsample_factor
    starts, ends, checked = [], [], []

    def frames():
        for i, f in enumerate(synthetic_frames(seq)):
            if i:
                ends.append(time.perf_counter())
            # After a non-poseframe the state still holds the inputs of
            # that frame's raster (no topology install since).
            if i >= 2 and (i - 1) % pf_every != 0 and len(checked) < 6:
                st = engine.state
                tri_fresh, _, _ = _smooth_pd_setup(st, params=engine.params)
                _, pvalid = raster_ops.triangle_planes(
                    st.vtx_uv, st.vtx_x, st.tris, tri_fresh)
                plain = rc.rasterize_tri_ids_v4_ref(
                    st.vtx_uv, st.tris, pvalid, height=cam.height,
                    width=cam.width)
                if not torch.equal(plain, st.last_idmap):
                    raise AssertionError(
                        f"frame {i - 1}: main-path id buffer differs from "
                        "the plain version")
                checked.append(i - 1)
            starts.append(time.perf_counter())
            yield f
        ends.append(time.perf_counter())

    res = run_offline(frames(), cam, engine.params, out_dir=out_dir,
                      engine=engine)
    with open(os.path.join(out_dir, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ms = (np.asarray(ends) - np.asarray(starts)) * 1e3
    return res, ms, checked, recs


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
    from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                          synthetic_frames)
    from flame_ros_torch.geometry.camera import Pinhole
    from flame_ros_torch.graph.delaunay import native_available, triangulate
    from flame_ros_torch.models.engine import Flame
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
    kind = torch.cuda.get_device_name(0)
    phase("environment", card=smi, kind=kind,
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
    rows = {"v4": {}, "v2": {}}
    max_err = {"v4": 0, "v2": 0}
    for case, ((pos, tp, tv), kw) in meshes.items():
        args = [torch.from_numpy(a).to(dev) for a in (pos, tp, tv)]
        *_, fits = rc.v4_setup(*args, height=H, row_tile=2,
                               cand_s=kw.get("cand_s", 384), cand_l=128,
                               long_thresh=kw.get("long_thresh", 48.0))
        for name, kern, ref, kk in (
                ("v4", rc.rasterize_tri_ids_v4, rc.rasterize_tri_ids_v4_ref,
                 kw),
                ("v2", rc.rasterize_tri_ids_v2, rc.rasterize_tri_ids_v2_ref,
                 {})):
            rc.reset_counters()
            out = kern(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            work = rc.work_counters(dev).tolist()
            plain = ref(*args, height=H, width=W, **kk)
            torch.cuda.synchronize()
            err = int((out.long() - plain.long()).abs().max())
            max_err[name] = max(max_err[name], err)
            if not torch.equal(out, plain):
                raise AssertionError(
                    f"{name} kernel != plain on {case}: "
                    f"{int((out != plain).sum())} pixels differ")
            if name == "v4":
                expect = [1, 0] if bool(fits) else [0, 1]
            else:
                expect = [0, 1]
            assert work == expect, (case, name, work, expect)
            if case == "forced_fallback" and name == "v4":
                assert work == [0, 1], "v2 must do the work on fallback"
            ms = cuda_median_ms(lambda: kern(*args, height=H, width=W, **kk))
            kernel_ms = cuda_median_ms(bare_launch(rc, name, args, H, W, kk))
            plain_ms = cuda_median_ms(
                lambda: ref(*args, height=H, width=W, **kk), reps=5,
                warmup=1)
            tests = needed_tests(torch, *args, H, W)
            nbytes = (args[0].numel() * 4 + args[1].numel() * 4
                      + args[2].numel() + H * W * 4)
            b_ops = tests * FLOPS_PER_TEST / PEAK_F32_FLOPS * 1e3
            b_bytes = nbytes / PEAK_BYTES * 1e3
            if case in ("engine_density", "long_triangles"):
                assert bool(fits), f"v4 budgets must hold on {case}"
            rows[name][case] = dict(
                ms=ms, kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(b_ops, b_bytes),
                bound_by="operations" if b_ops >= b_bytes else "bytes",
                candidate_tests=tests, fits=bool(fits), work=work,
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
    res, ms, checked, recs = drive_main_path(engine, seq, OUT)
    launches = {"v4": rc.rasterize_tri_ids_v4.launches,
                "v2": rc.rasterize_tri_ids_v2.launches}
    work = rc.work_counters(dev).tolist()
    assert res.frames_processed == n_frames and res.frames_failed == 0
    health = [r["health"] for r in recs]
    assert len(health) == n_frames and all(h == 1.0 for h in health), health
    assert launches["v4"] >= n_frames, launches
    assert len(checked) >= 3, checked
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
          launches=launches, work_v4_v2=work, idmap_checked_frames=checked,
          num_tris_last=recs[-1]["num_tris"])

    # 5. small-input agreement: card path vs CPU path --------------------
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

    # Result lines -----------------------------------------------------
    replaces = {"v4": "flame_ros_tpu/ops/raster_pallas.py:458",
                "v2": "flame_ros_tpu/ops/raster_pallas.py:128"}
    kernels = []
    for name in ("v4", "v2"):
        r = rows[name]["engine_density"]   # y-sorted, as the engine's
        kernels.append({
            "name": f"raster_{name}", "route": "cuda",
            "source": "flame_ros_torch/csrc/raster.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
