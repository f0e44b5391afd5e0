"""Offline dataset frontends: TUM / EuRoC-ASL / synthetic batch runners.

Counterpart of `run_offline`, `run_offline_windowed`,
`run_offline_tracking` and `main` in
`flame_ros_tpu/frontends/offline_runner.py` (reference
src/flame_offline_tum.cc, src/flame_offline_asl.cc): drive the engine
frame by frame, or in poseframe-aligned windows of frames, optionally at
a throttled rate or with ground-truth inverse depth passed in (the truth
harness), or with poses estimated online by the tracking nodelet (input
poses then only feed the ATE/RPE evaluation); compute GT truth stats per
frame (confusion matrix + stats.txt, reference protocol), stream
per-frame telemetry as JSONL, and print one summary JSON line. The
stress harnesses `with_occlusion` and `with_pose_noise` wrap a frame
stream.

Usage:
  python -m flame_ros_torch.frontends.offline_runner --dataset synthetic \\
      --frames 60 --resolution vga --out /tmp/flame_out [--device cuda] \\
      [--window 6] [--save-products] [--pass-in-truth]
  python -m flame_ros_torch.frontends.offline_runner --dataset synthetic \
      --frames 60 --resolution vga --pose-source tracking [--occlude 24:30]
  python -m flame_ros_torch.frontends.offline_runner --dataset tum \\
      --input assoc.txt --calib calib.yaml --input-frame RDF --out out/
  python -m flame_ros_torch.frontends.offline_runner --dataset asl \\
      --pose-path mav0/state_groundtruth_estimate0 --rgb-path mav0/cam0 \\
      --world-frame RDF --out out/
  python -m flame_ros_torch.frontends.offline_runner --dataset synthetic \
      --pose-source tracking --ba-refine [--profile-stages]
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
                                          ate_rmse, depth_metrics,
                                          has_ground_truth, rpe)
from flame_ros_torch.frontends.nodelet import FlameNodelet
from flame_ros_torch.geometry.se3 import SE3, random_se3
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
    # Tracking mode (no GT poses in): ate_rmse is Horn/SE3-aligned (scale
    # errors count — the bootstrap depth anchors the scale); sim3 removes
    # scale (drift); raw is origin-aligned (both start at identity).
    ate_rmse: float = float("nan")
    ate_rmse_sim3: float = float("nan")
    ate_rmse_raw: float = float("nan")
    gt_path_length: float = float("nan")
    # Relative pose error (TUM evaluate_rpe): per frame pair (delta 1)
    # and over 30 frames (~1 s at 30 fps).
    rpe_trans_rmse: float = float("nan")      # m, delta = 1 frame
    rpe_rot_rmse_deg: float = float("nan")    # deg, delta = 1 frame
    rpe30_trans_rmse: float = float("nan")    # m, delta = 30 frames
    rpe30_rot_rmse_deg: float = float("nan")  # deg, delta = 30 frames
    # Frames the tracking gate rejected (dropped) and recoveries through
    # the keyframe-ring re-search.
    track_failed_frames: int = 0
    relocalizations: int = 0


@dataclass
class Frame:
    img_id: int
    time: float
    gray: object        # [H, W] numpy array or tensor
    depth: object       # [H, W] meters, 0 where invalid
    quat: Optional[np.ndarray]    # (w, x, y, z)
    trans: Optional[np.ndarray]


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


def run_offline_tracking(frames: Iterable, cam, params: FlameParams,
                         out_dir: Optional[str] = None,
                         ba_refine: bool = False,
                         max_frames: Optional[int] = None,
                         quiet: bool = True, device=None,
                         node: Optional[FlameNodelet] = None) -> RunResult:
    """Online streaming with no GT poses: poses are estimated by the
    nodelet's direct tracker and windowed pose graph, and with ba_refine
    refined on every poseframe by windowed photometric bundle adjustment
    over the keyframe ring. Input poses, where
    the stream has them, are used only as the GT trajectory for ATE/RPE;
    the first frame's depth fixes the monocular scale (RGB-D-style
    bootstrap); depth on later frames feeds only the GT confusion matrix.
    Runs on the card unless `device` says otherwise; `node` lets a caller
    pass (and afterwards inspect) its own tracking nodelet.

    Reports the same stats.txt/JSONL products as `run_offline` plus the
    ATE and RPE block (eval/metrics.py states the protocols)."""
    if node is None:
        # trajectory_cap=0: unbounded, so the ATE window covers the run.
        node = FlameNodelet(cam, params, pose_source="tracking",
                            ba_refine=ba_refine, eval_gt_depth=True,
                            trajectory_cap=0, device=device)
    writer = StatsFileWriter(out_dir) if out_dir else None
    jsonl = open(os.path.join(out_dir, "telemetry.jsonl"), "w") \
        if out_dir else None

    res = RunResult()
    rmses, precs, recs = [], [], []
    last_gt = None
    gt_poses: dict[int, tuple] = {}   # img_id -> GT (q, t)
    n_seen = 0

    def on_stats(rec):
        nonlocal n_seen
        if rec.get("true_pos", -1) >= 0:
            ts = TruthStats.from_record(rec)
            rmses.append(ts.rmse)
            if np.isfinite(ts.precision):
                precs.append(ts.precision)
            if np.isfinite(ts.recall):
                recs.append(ts.recall)
            if writer:
                writer.append(n_seen, rec["timestamp"],
                              rec.get("update_ms", 0.0),
                              int(rec["num_vtx"]), int(rec["num_tris"]),
                              ts, rec["total_photo_error"],
                              rec["avg_photo_error"])
        if jsonl:
            jsonl.write(json.dumps(rec) + "\n")
        n_seen += 1

    node.on_stats.append(on_stats)
    t_start = time_mod.perf_counter()
    try:
        for frame in frames:
            if max_frames is not None and frame.img_id >= max_frames:
                break
            if frame.quat is not None:
                gt_poses[frame.img_id] = (
                    np.asarray(frame.quat, np.float64),
                    np.asarray(frame.trans, np.float64))
            if has_ground_truth(frame.depth):
                last_gt = frame.depth
            node.push_frame(frame.img_id, frame.time, gray=frame.gray,
                            depth=frame.depth)
            node.run_until_idle(idle_timeout=0.01)
            if not quiet and node.trajectory:
                fid, _, pose = node.trajectory[-1]
                print(f"frame {fid}: est_t={np.round(pose.t.numpy(), 3)}")
    finally:
        node.on_stats.remove(on_stats)
        node.engine.shutdown()
        if jsonl:
            jsonl.close()

    res.frames_processed = len(node.trajectory)
    res.frames_failed = node.engine.num_failed_frames
    res.track_failed_frames = node.n_track_failed_frames
    res.relocalizations = node.n_relocalizations
    res.fps = res.frames_processed / max(
        time_mod.perf_counter() - t_start, 1e-6)
    _finish(res, node.engine, last_gt, rmses, precs, recs, writer, out_dir,
            False, cam)

    pairs = [(p.q.numpy().astype(np.float64), p.t.numpy().astype(np.float64),
              gt_poses[fid])
             for fid, _, p in node.trajectory if fid in gt_poses]
    if len(pairs) >= 3:
        est_q = np.stack([q for q, _, _ in pairs])
        est_t = np.stack([t for _, t, _ in pairs])
        gt_q = np.stack([g[0] for _, _, g in pairs])
        gt_t = np.stack([g[1] for _, _, g in pairs])
        res.ate_rmse = ate_rmse(est_t, gt_t, align="se3")
        res.ate_rmse_sim3 = ate_rmse(est_t, gt_t, align="sim3")
        res.ate_rmse_raw = ate_rmse(est_t, gt_t, align="none")
        res.gt_path_length = float(
            np.sum(np.linalg.norm(np.diff(gt_t, axis=0), axis=1)))
        r1 = rpe(est_q, est_t, gt_q, gt_t, delta=1)
        res.rpe_trans_rmse = r1["trans_rmse"]
        res.rpe_rot_rmse_deg = r1["rot_rmse_deg"]
        if len(pairs) > 30:
            r30 = rpe(est_q, est_t, gt_q, gt_t, delta=30)
            res.rpe30_trans_rmse = r30["trans_rmse"]
            res.rpe30_rot_rmse_deg = r30["rot_rmse_deg"]
    return res


def with_occlusion(frames: Iterable, start: int, end: int,
                   value: float = 250.0):
    """Tracking-killer injection: replace the gray content of frames
    [start, end] (inclusive) with a uniform flash (a full-frame occlusion
    or white-out no photometric tracker can align), leaving poses and
    depths untouched so the ATE ground truth stays valid. Drives the
    tracking failure gate and the keyframe-ring relocalization."""
    for frame in frames:
        if start <= frame.img_id <= end:
            frame.gray = (torch.full_like(frame.gray, value)
                          if isinstance(frame.gray, torch.Tensor)
                          else np.full_like(np.asarray(frame.gray), value))
        yield frame


def with_pose_noise(frames: Iterable, sigma_trans: float,
                    sigma_rot_deg: float, seed: int = 0):
    """Pose-noise ablation (reference: the Gaussian SE3 noise block in
    src/flame_offline_tum.cc:438-489): right-perturb every input pose by
    a random SE3 tangent draw, leaving images and depths clean, so a run
    measures the depth estimate's robustness to odometry error. The draws
    are the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    sr = np.radians(sigma_rot_deg)
    for frame in frames:
        noise = random_se3(rng, sigma_rot=sr, sigma_trans=sigma_trans)
        noisy = SE3.from_quat_trans(frame.quat, frame.trans) @ noise
        frame.quat = noisy.q.numpy()
        frame.trans = noisy.t.numpy()
        yield frame


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
                            motion=args.motion,
                            texture_gain=args.texture_gain,
                            exposure_amp=args.exposure_amp,
                            scene=args.scene, device=device)
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
    p.add_argument("--texture-gain", type=float, default=1.0,
                   help="synthetic: contrast scale about mid-gray "
                        "(0.15 = low-texture stress regime)")
    p.add_argument("--exposure-amp", type=float, default=0.0,
                   help="synthetic: auto-exposure oscillation amplitude "
                        "(0.5 = exposure stress regime)")
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
    p.add_argument("--pose-source", default="external",
                   choices=["external", "tracking"],
                   help="tracking: estimate poses online (direct tracker "
                        "+ pose graph); input poses are used only for "
                        "ATE/RPE")
    p.add_argument("--ba-refine", action="store_true",
                   help="tracking mode: windowed photometric BA over the "
                        "keyframe ring at poseframe rate")
    p.add_argument("--profile-stages", action="store_true",
                   help="populate the reference's stage-timing vocabulary "
                        "at debug rate (debug.profile_stages; costs host "
                        "syncs)")
    p.add_argument("--pose-noise-sigma", type=float, default=0.0,
                   help="pose-noise ablation: translation sigma in "
                        "meters applied to every input pose")
    p.add_argument("--pose-noise-rot-sigma", type=float, default=0.0,
                   help="pose-noise ablation: rotation sigma in degrees")
    p.add_argument("--pose-noise-seed", type=int, default=0)
    p.add_argument("--occlude", default="",
                   help="tracking-killer stress injection: START:END "
                        "(inclusive frame ids) replaced by a uniform "
                        "white flash; images only, poses and depths stay "
                        "valid for evaluation")
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
    noisy = args.pose_noise_sigma > 0 or args.pose_noise_rot_sigma > 0
    if args.pose_source == "tracking":
        if args.window > 0 or args.pass_in_truth or args.rate > 0:
            p.error("--pose-source tracking is incompatible with "
                    "--window/--pass-in-truth/--rate")
        if noisy:
            # The input poses are the ATE ground truth in tracking mode.
            p.error("--pose-source tracking is incompatible with "
                    "--pose-noise-* (the input poses are the ATE ground "
                    "truth)")

    device = resolve_device(args.device)
    params = (FlameParams.from_yaml(args.config) if args.config
              else FlameParams())
    if args.profile_stages:
        params = dataclasses.replace(params, debug=dataclasses.replace(
            params.debug, profile_stages=True))
    if args.zero_mean_ssd:
        params = dataclasses.replace(params, engine=dataclasses.replace(
            params.engine, zero_mean_ssd=True))
    frames, cam = _build_frames(args, device)
    if args.occlude:
        occ_start, occ_end = (int(x) for x in args.occlude.split(":"))
        frames = with_occlusion(frames, occ_start, occ_end)
    if noisy:
        frames = with_pose_noise(frames, args.pose_noise_sigma,
                                 args.pose_noise_rot_sigma,
                                 seed=args.pose_noise_seed)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.pose_source == "tracking":
        res = run_offline_tracking(frames, cam, params, out_dir=args.out,
                                   ba_refine=args.ba_refine,
                                   max_frames=args.frames,
                                   quiet=not args.verbose, device=device)
    elif args.window > 0:
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
    if args.pose_source == "tracking":
        summary.update({
            "ate_rmse": _round(res.ate_rmse, 5),
            "ate_rmse_sim3": _round(res.ate_rmse_sim3, 5),
            "ate_rmse_raw": _round(res.ate_rmse_raw, 5),
            "gt_path_length": _round(res.gt_path_length, 4),
            "track_failed_frames": res.track_failed_frames,
            "relocalizations": res.relocalizations,
            "rpe_trans_rmse": _round(res.rpe_trans_rmse, 5),
            "rpe_rot_rmse_deg": _round(res.rpe_rot_rmse_deg, 4),
            "rpe30_trans_rmse": _round(res.rpe30_trans_rmse, 5),
            "rpe30_rot_rmse_deg": _round(res.rpe30_rot_rmse_deg, 4),
        })
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
