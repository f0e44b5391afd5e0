"""Offline dataset frontends: TUM / EuRoC-ASL / synthetic batch runners.

Counterpart of `run_offline`, `run_offline_windowed` and `main` (external
poses) in `flame_ros_tpu/frontends/offline_runner.py` (reference
src/flame_offline_tum.cc, src/flame_offline_asl.cc): drive the engine
frame by frame, or in poseframe-aligned windows of frames, optionally at
a throttled rate or with ground-truth inverse depth passed in (the truth
harness), compute GT truth stats per frame (confusion matrix +
stats.txt, reference protocol), stream per-frame telemetry as JSONL, and
print one summary JSON line.

Usage:
  python -m flame_ros_torch.frontends.offline_runner --dataset synthetic \\
      --frames 60 --resolution vga --out /tmp/flame_out [--device cuda] \\
      [--window 6] [--save-products] [--pass-in-truth]
  python -m flame_ros_torch.frontends.offline_runner --dataset tum \\
      --input assoc.txt --calib calib.yaml --input-frame RDF --out out/
  python -m flame_ros_torch.frontends.offline_runner --dataset asl \\
      --pose-path mav0/state_groundtruth_estimate0 --rgb-path mav0/cam0 \\
      --world-frame RDF --out out/

Not ported yet (ROADMAP.md queue 1, items 11-12): pose estimation
(`--pose-source tracking`, `--ba-refine`), the tracking stress and noise
harnesses (`--occlude`, `--pose-noise-*`), `--profile-stages`, and the
synthetic stress knobs `--texture-gain` / `--exposure-amp`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time as time_mod
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from flame_ros_torch.config import FlameParams
from flame_ros_torch.eval.metrics import (StatsFileWriter, TruthStats,
                                          depth_metrics, has_ground_truth)
from flame_ros_torch.geometry.se3 import SE3
from flame_ros_torch.models.engine import Flame
from flame_ros_torch.utils.device import resolve_device
from flame_ros_torch.utils.load_tracker import LoadTracker


@dataclass
class RunResult:
    frames_processed: int = 0
    frames_failed: int = 0
    fps: float = 0.0
    mean_rmse: float = float("nan")
    mean_precision: float = float("nan")
    mean_recall: float = float("nan")
    final_coverage: float = 0.0
    # Monodepth metrics on the final frame's dense map (meters).
    final_abs_rel: float = float("nan")
    final_delta1: float = float("nan")
    stats_path: Optional[str] = None


@dataclass
class Frame:
    img_id: int
    time: float
    gray: object        # [H, W] numpy array or tensor
    depth: object       # [H, W] meters, 0 where invalid
    quat: np.ndarray    # (w, x, y, z)
    trans: np.ndarray


def _truth_idepth(depth):
    """GT inverse depth, 0 where the depth is invalid (on the depth's
    device when it is a tensor)."""
    if isinstance(depth, torch.Tensor):
        d = depth.to(torch.float32)
        return torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-6),
                           torch.zeros_like(d))
    d = np.asarray(depth)
    return np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0).astype(np.float32)


def _final_depth_metrics(res: RunResult, engine: Flame, last_gt) -> None:
    if last_gt is None:
        return
    gt = (last_gt.detach().cpu() if isinstance(last_gt, torch.Tensor)
          else torch.from_numpy(np.asarray(last_gt, np.float32)))
    m = depth_metrics(torch.from_numpy(engine.get_inverse_depth_map()),
                      gt.to(torch.float32))
    res.final_abs_rel = float(m["abs_rel"])
    res.final_delta1 = float(m["delta1"])


def _finish(res: RunResult, engine: Flame, last_gt, rmses, precs, recs,
            writer, out_dir, save_products, cam) -> RunResult:
    if rmses:
        res.mean_rmse = float(np.mean(rmses))
    if precs:
        res.mean_precision = float(np.mean(precs))
    if recs:
        res.mean_recall = float(np.mean(recs))
    _final_depth_metrics(res, engine, last_gt)
    res.final_coverage = float(engine.stats_.stats("coverage"))
    if writer:
        res.stats_path = writer.path
    if out_dir and save_products:
        uv, x, normals, tris, keep, edges = engine.get_inverse_depth_mesh()
        np.savez(os.path.join(out_dir, "final_mesh.npz"),
                 vertices_px=uv, idepths=x, normals=normals,
                 triangles=tris, tri_validity=keep, edges=edges, K=cam.K)
        np.save(os.path.join(out_dir, "final_idepth.npy"),
                engine.get_inverse_depth_map())
    return res


def run_offline_windowed(frames: Iterable, cam, params: FlameParams,
                         out_dir: Optional[str] = None, window: int = 6,
                         max_frames: Optional[int] = None,
                         save_products: bool = False, device=None,
                         engine: Optional[Flame] = None) -> RunResult:
    """Window-batched offline run: frames go to the engine in
    poseframe-aligned windows of up to `window` frames (`update_window`),
    with device-side GT evaluation; the stats of a window come back in
    one read. Telemetry still lands per frame."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if engine is None:
        engine = Flame(cam.width, cam.height, cam=cam, params=params,
                       device=device)
    writer = StatsFileWriter(out_dir) if out_dir else None
    jsonl = open(os.path.join(out_dir, "telemetry.jsonl"), "w") \
        if out_dir else None
    pf_every = params.input.poseframe_subsample_factor
    sub = params.input.subsample_factor
    res = RunResult()
    rmses, precs, recs = [], [], []
    last_gt = None
    t_start = time_mod.perf_counter()
    n_proc = 0
    buf, gts = [], []

    def flush():
        nonlocal n_proc
        if not buf:
            return
        has_gt = all(g is not None for g in gts)
        if not engine.update_window(list(buf), gts if has_gt else None):
            res.frames_failed += len(buf)
            buf.clear()
            gts.clear()
            return
        for (t, fid, _, _, _), rec in zip(buf,
                                          engine.flush_window_stats()):
            if has_gt and rec.get("true_pos", -1) >= 0:
                ts = TruthStats.from_record(rec)
                rmses.append(ts.rmse)
                if np.isfinite(ts.precision):
                    precs.append(ts.precision)
                if np.isfinite(ts.recall):
                    recs.append(ts.recall)
                if writer:
                    writer.append(n_proc, t, 0.0, int(rec["num_vtx"]),
                                  int(rec["num_tris"]), ts,
                                  rec["total_photo_error"],
                                  rec["avg_photo_error"])
            if jsonl:
                jsonl.write(json.dumps({"img_id": fid, "timestamp": t,
                                        **rec}) + "\n")
            n_proc += 1
        buf.clear()
        gts.clear()

    try:
        for frame in frames:
            if max_frames is not None and frame.img_id >= max_frames:
                break
            if frame.img_id % sub:
                continue
            is_pf = (n_proc + len(buf)) % pf_every == 0
            if is_pf and buf:
                flush()
            pose = SE3.from_quat_trans(frame.quat, frame.trans)
            buf.append((frame.time, frame.img_id, pose, frame.gray, is_pf))
            gts.append(frame.depth if has_ground_truth(frame.depth) else None)
            if gts[-1] is not None:
                last_gt = gts[-1]
            if len(buf) >= window:
                flush()
        flush()
    finally:
        if jsonl:
            jsonl.close()
    res.frames_processed = n_proc
    res.fps = n_proc / max(time_mod.perf_counter() - t_start, 1e-6)
    return _finish(res, engine, last_gt, rmses, precs, recs, writer,
                   out_dir, save_products, cam)


def run_offline(frames: Iterable, cam, params: FlameParams,
                out_dir: Optional[str] = None,
                pass_in_truth: bool = False,
                rate: float = 0.0,
                max_frames: Optional[int] = None,
                save_products: bool = False,
                quiet: bool = True,
                device=None, engine: Optional[Flame] = None) -> RunResult:
    """Drive the engine over frames with (img_id, time, gray, depth, quat,
    trans) attributes. Runs on the card unless `device` says otherwise;
    `engine` lets a caller pass (and afterwards inspect) its own engine.
    pass_in_truth feeds each frame's GT inverse depth into the engine's
    filter (the truth harness); rate > 0 throttles to that many frames
    a second. save_products writes the final mesh and dense idepth map
    to out_dir."""
    if engine is None:
        engine = Flame(cam.width, cam.height, cam=cam, params=params,
                       device=device)
    writer = StatsFileWriter(out_dir) if out_dir else None
    jsonl = open(os.path.join(out_dir, "telemetry.jsonl"), "w") \
        if out_dir else None
    load = LoadTracker()
    pf_every = params.input.poseframe_subsample_factor
    sub = params.input.subsample_factor
    res = RunResult()
    rmses, precs, recs = [], [], []
    last_gt = None
    t_start = time_mod.perf_counter()
    n_proc = 0
    try:
        for frame in frames:
            if max_frames is not None and frame.img_id >= max_frames:
                break
            if frame.img_id % sub:
                continue
            pose = SE3.from_quat_trans(frame.quat, frame.trans)
            is_pf = (n_proc % pf_every) == 0
            has_gt = has_ground_truth(frame.depth)
            if has_gt:
                last_gt = frame.depth
            truth = (_truth_idepth(frame.depth) if pass_in_truth and has_gt
                     else None)
            engine.stats_.tick("sense")
            ok = engine.update(frame.time, frame.img_id, pose, frame.gray,
                               is_pf, idepths_truth=truth,
                               gt_depth=frame.depth if has_gt else None)
            engine.stats_.tock("sense")
            if not ok:
                res.frames_failed += 1
                continue
            n_proc += 1
            st = engine.stats_
            rec = engine.flush_stats()  # one small device-to-host copy
            if has_gt:
                ts = TruthStats.from_record(rec)
                rmses.append(ts.rmse)
                if np.isfinite(ts.precision):
                    precs.append(ts.precision)
                if np.isfinite(ts.recall):
                    recs.append(ts.recall)
                if writer:
                    writer.append(
                        n_proc - 1, frame.time, st.timings("sense"),
                        int(rec["num_vtx"]), int(rec["num_tris"]), ts,
                        rec["total_photo_error"], rec["avg_photo_error"])
            elapsed = time_mod.perf_counter() - t_start
            st.set("fps", n_proc / max(elapsed, 1e-6))
            st.set("fps_max", 1e3 / max(st.timings("update"), 1e-6))
            if n_proc % params.output.load_integration_factor == 0:
                snap = load.get()
                st.set("pid_load_cpu", snap.pid_load.cpu)
                st.set("pid_load_mem", snap.pid_load.mem)
                st.set("sys_load_cpu", snap.sys_load.cpu)
            if jsonl:
                st.dump_jsonl(jsonl, frame.img_id, frame.time)
            if not quiet:
                print(f"frame {frame.img_id}: feats="
                      f"{int(st.stats('num_feats'))} "
                      f"tris={int(st.stats('num_tris'))} "
                      f"coverage={st.stats('coverage'):.2f} "
                      f"update={st.timings('update'):.1f}ms")
            if rate > 0:
                budget = 1.0 / rate - (time_mod.perf_counter() - t_start
                                       - (n_proc - 1) / rate)
                if budget > 0:
                    time_mod.sleep(budget)
    finally:
        if jsonl:
            jsonl.close()

    res.frames_processed = n_proc
    res.fps = n_proc / max(time_mod.perf_counter() - t_start, 1e-6)
    return _finish(res, engine, last_gt, rmses, precs, recs, writer,
                   out_dir, save_products, cam)


def synthetic_frames(seq):
    """Frames of a SyntheticSequence (images stay on its device)."""
    q = seq.poses.q.detach().cpu().numpy()
    t = seq.poses.t.detach().cpu().numpy()
    for i in range(len(seq)):
        yield Frame(i, float(seq.timestamps[i]), seq.images[i],
                    seq.depths[i], q[i], t[i])


def _round(x, nd):
    return round(x, nd) if np.isfinite(x) else None


def _build_frames(args, device):
    """(frames, cam) of the dataset that args name."""
    if args.dataset == "synthetic":
        from flame_ros_torch.datasets.synthetic import (QVGA, VGA,
                                                        make_sequence)
        cam = VGA if args.resolution == "vga" else QVGA
        seq = make_sequence(n_frames=args.frames or 60, cam=cam,
                            motion=args.motion, scene=args.scene,
                            device=device)
        return synthetic_frames(seq), cam
    if args.dataset == "tum":
        from flame_ros_torch.datasets.tum import (TUMRGBDStream,
                                                  load_camera_info_yaml)
        calib = load_camera_info_yaml(args.calib) if args.calib else None
        stream = TUMRGBDStream(args.input, calib=calib,
                               input_frame=args.input_frame,
                               depth_scale_factor=args.depth_scale_factor,
                               resize_factor=args.resize_factor)
        return iter(stream), stream.cam
    if args.dataset == "asl":
        from flame_ros_torch.datasets.asl import ASLRGBDStream
        stream = ASLRGBDStream(args.pose_path, args.rgb_path,
                               depth_path=args.depth_path,
                               world_frame=args.world_frame,
                               resize_factor=args.resize_factor)
        return iter(stream), stream.cam
    raise ValueError(args.dataset)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["tum", "asl", "synthetic"],
                   required=True)
    p.add_argument("--input", help="TUM association file")
    p.add_argument("--calib", help="ROS CameraInfo YAML")
    p.add_argument("--input-frame", default="RDF")
    p.add_argument("--depth-scale-factor", type=float, default=5000.0)
    p.add_argument("--pose-path", help="ASL pose sensor folder")
    p.add_argument("--rgb-path", help="ASL camera folder")
    p.add_argument("--depth-path", help="ASL depth folder")
    p.add_argument("--world-frame", default="RDF")
    p.add_argument("--config", help="FlameParams YAML")
    p.add_argument("--out", help="output directory")
    p.add_argument("--frames", type=int, help="max frames")
    p.add_argument("--rate", type=float, default=0.0,
                   help="throttle to N fps (0 = unthrottled)")
    p.add_argument("--pass-in-truth", action="store_true",
                   help="feed each frame's GT inverse depth into the "
                        "filter (the truth harness)")
    p.add_argument("--resize-factor", type=int, default=1)
    p.add_argument("--motion", default="strafe",
                   help="synthetic trajectory: strafe/forward/rotation/"
                        "mav/static")
    p.add_argument("--scene", default="room", choices=["room", "primitives"])
    p.add_argument("--zero-mean-ssd", action="store_true",
                   help="brightness-offset-invariant epipolar matching "
                        "(engine.zero_mean_ssd; for auto-exposure input)")
    p.add_argument("--resolution", default="qvga", choices=["qvga", "vga"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--window", type=int, default=0,
                   help="batch N frames per update_window call, in "
                        "poseframe-aligned windows (0 = per-frame)")
    p.add_argument("--save-products", action="store_true",
                   help="write final_mesh.npz and final_idepth.npy to "
                        "--out")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.dataset == "tum" and not args.input:
        p.error("--dataset tum requires --input <association file>")
    if args.dataset == "asl" and not (args.pose_path and args.rgb_path):
        p.error("--dataset asl requires --pose-path and --rgb-path")
    if args.window < 0:
        p.error("--window must be >= 0")
    if args.window > 0 and (args.pass_in_truth or args.rate > 0):
        p.error("--window is incompatible with --pass-in-truth/--rate")
    if args.save_products and not args.out:
        p.error("--save-products needs --out")

    device = resolve_device(args.device)
    params = (FlameParams.from_yaml(args.config) if args.config
              else FlameParams())
    if args.zero_mean_ssd:
        params = dataclasses.replace(params, engine=dataclasses.replace(
            params.engine, zero_mean_ssd=True))
    frames, cam = _build_frames(args, device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.window > 0:
        res = run_offline_windowed(
            frames, cam, params, out_dir=args.out, window=args.window,
            max_frames=args.frames, save_products=args.save_products,
            device=device)
    else:
        res = run_offline(frames, cam, params, out_dir=args.out,
                          pass_in_truth=args.pass_in_truth, rate=args.rate,
                          max_frames=args.frames,
                          save_products=args.save_products,
                          quiet=not args.verbose, device=device)
    summary = {
        "frames": res.frames_processed,
        "failed": res.frames_failed,
        "fps": round(res.fps, 2),
        "idepth_rmse": _round(res.mean_rmse, 5),
        "precision": _round(res.mean_precision, 4),
        "recall": _round(res.mean_recall, 4),
        "coverage": round(res.final_coverage, 4),
        "abs_rel": _round(res.final_abs_rel, 4),
        "delta1": _round(res.final_delta1, 4),
    }
    print(json.dumps(summary))
    return res


def _console_argv(argv):
    # A console entry point calls its function with no arguments.
    return sys.argv[1:] if argv is None else list(argv)


def main_tum(argv=None):
    return main(["--dataset", "tum"] + _console_argv(argv))


def main_asl(argv=None):
    return main(["--dataset", "asl"] + _console_argv(argv))


if __name__ == "__main__":
    main()
