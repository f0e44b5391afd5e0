#!/usr/bin/env python3
"""The JAX package's tracking-mode numbers on the port's rendered frames.

    JAX_PLATFORMS=cpu python scripts/jax_tracking_reference.py --ba-refine
        [--renderer jax] [--port] [--replay N] [--perturb K] [--poses]
    JAX_PLATFORMS=cpu python scripts/jax_tracking_reference.py --run NAME
        [--perturb K[,K...]] [--port] [--cache DIR]
    python scripts/jax_tracking_reference.py --collect FILE [FILE ...]

Renders the phase-4 sequence of `chip_smoke.py` (room scene, strafe,
VGA, 60 frames) with the port's renderer on the CPU, runs the JAX
package's `run_offline_tracking` over those frames on the CPU (default
FlameParams), and prints one JSON line: the JAX runner's summary keys,
and with --ba-refine the number of bundle-adjustment solves
(`ba_solves`, the nodelet's `len(ba_costs)`) and their costs. These are
`chip_smoke.py`'s `JAX_TRACK_BA_VGA`. A first line gives the largest and
mean gray-level difference between the two packages' renderers.

--renderer jax runs on the JAX package's renderer's frames instead (the
frames of the JAX CLI). --port also runs the port's
`run_offline_tracking` on the CPU over the same frames and prints its
line. --replay N keeps the inputs of the JAX run's first
N `hybrid_bundle_adjust` calls, runs the port's on the same inputs and
prints the largest differences of each. --perturb K (K > 0) moves a
random half of the pixels of every frame one float32 step up (seed K):
a change at the size of the rounding by which two implementations of the
same arithmetic differ, given to both packages alike. --poses adds each
frame's tracked pose (`[img_id, qw, qx, qy, qz, tx, ty, tz]`) to the
summaries.

--run NAME runs one run of `chip_smoke.py`'s TRACK_ACCEPT_RUNS (the
tracking-mode acceptance protocol of tests/test_acceptance_tracking.py:
VGA, 200 frames, its sequence, `--occlude`, `--ba-refine` and `--config`)
on the port's rendered frames, with every frame's pose in its line, the
number of JAX devices and the BA route: the points of each unsharded
and each sharded solve. --perturb takes a list of K there, run one after
the other in one process over one rendering and one set of compiles.
Run with one XLA thread (XLA_FLAGS="--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1") and one CPU device, as the port runs on
one card. --collect reads the lines of such runs (K = 0 and its
perturbed copies) and prints, per run, the unmoved run's summary with
its poses up to the parting frame (the first frame at which any
perturbed run's pose leaves the unmoved one's by more than 1e-4), each
with the largest distance of a perturbed run's pose from it, and the
smallest and largest value of each summary metric over the runs: these
are `chip_smoke.py`'s JAX_TRACK_ACCEPT and JAX_TRACK_ACCEPT_SPREAD (with
the smallest and largest of each of the first three BA costs).

Like the port's tests, this script imports both packages; it is not part
of the port.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Frame:
    def __init__(self, i, t, gray, depth, q, tr):
        self.img_id, self.time, self.gray, self.depth = i, t, gray, depth
        self.quat, self.trans = q, tr


def perturbed(imgs, seed):
    """imgs with a random half of its pixels one float32 step up."""
    if seed <= 0:
        return imgs
    up = np.random.default_rng(seed).random(imgs.shape) < 0.5
    return np.where(up, np.nextafter(imgs, np.float32(np.inf)), imgs)


def _poses(node):
    return [[int(i)] + [float(x) for x in np.asarray(p.q).ravel()]
            + [float(x) for x in np.asarray(p.t).ravel()]
            for i, _, p in node.trajectory]


def _summary(res, node, seconds, poses=False):
    out = {"frames": res.frames_processed, "failed": res.frames_failed,
           "idepth_rmse": res.mean_rmse, "precision": res.mean_precision,
           "recall": res.mean_recall, "coverage": res.final_coverage,
           "ate_rmse": res.ate_rmse, "ate_rmse_sim3": res.ate_rmse_sim3,
           "gt_path_length": res.gt_path_length,
           "rpe_trans_rmse": res.rpe_trans_rmse,
           "rpe_rot_rmse_deg": res.rpe_rot_rmse_deg,
           "rpe30_trans_rmse": res.rpe30_trans_rmse,
           "rpe30_rot_rmse_deg": res.rpe30_rot_rmse_deg,
           "track_failed_frames": res.track_failed_frames,
           "relocalizations": res.relocalizations, "seconds": seconds}
    if node.ba_refine:
        out["ba_solves"] = len(node.ba_costs)
        out["ba_costs"] = [float(c) for c in node.ba_costs]
    if poses:
        out["poses"] = _poses(node)
    return {k: (float(v) if isinstance(v, np.floating) else v)
            for k, v in out.items()}


def _keep_nodes(module):
    """Keep every FlameNodelet the module's class makes."""
    nodes = []
    init = module.FlameNodelet.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        nodes.append(self)

    module.FlameNodelet.__init__ = keep
    return nodes


PART_TOL = 1e-4
# The summary metrics whose smallest and largest values --collect keeps.
SPREAD_KEYS = ("frames", "failed", "idepth_rmse", "precision", "recall",
               "coverage", "ate_rmse", "ate_rmse_sim3", "gt_path_length",
               "rpe_trans_rmse", "rpe_rot_rmse_deg", "rpe30_trans_rmse",
               "rpe30_rot_rmse_deg", "track_failed_frames",
               "relocalizations", "ba_solves")


def parting_frame(ref, runs):
    """The first frame id at which any of runs' poses leaves ref's by
    more than PART_TOL (a frame one run tracked and another failed counts
    as parting); None if none does. Poses are [img_id, q(4), t(3)]."""
    base = {int(p[0]): np.asarray(p[1:]) for p in ref}
    first = None
    for run in runs:
        got = {int(p[0]): np.asarray(p[1:]) for p in run}
        for i in sorted(set(base) | set(got)):
            if (i not in base or i not in got
                    or np.abs(base[i] - got[i]).max() > PART_TOL):
                first = i if first is None else min(first, i)
                break
    return first


def collect(paths):
    """Per run: the unmoved run's summary with its poses before the
    parting frame and its first three BA costs, and the spread of the
    summary metrics over the unmoved and perturbed runs."""
    lines = []
    for path in paths:
        with open(path) as f:
            lines += [json.loads(x) for x in f if x.startswith("{")]
    by_run = {}
    for x in lines:
        if x.get("package") == "jax" and "run" in x:
            by_run.setdefault(x["run"], {})[x["perturb"]] = x
    for name, runs in sorted(by_run.items()):
        ref = runs[0]
        part = parting_frame(ref["poses"], [r["poses"] for k, r in
                                            sorted(runs.items()) if k])
        keep = {k: ref[k] for k in SPREAD_KEYS if k in ref}
        keep.update(perturbed=sorted(k for k in runs if k),
                    parting_frame=part, ba_route=ref["ba_route"],
                    jax_devices=ref["jax_devices"])
        if "ba_costs" in ref:
            keep["ba_costs"] = ref["ba_costs"][:3]
        # Each pose before the parting frame, with the largest distance
        # of a perturbed run's pose from it at that frame.
        moved = [{int(p[0]): np.asarray(p[1:]) for p in r["poses"]}
                 for k, r in sorted(runs.items()) if k]
        keep["poses"] = [
            p + [max((float(np.abs(m[p[0]] - np.asarray(p[1:])).max())
                      for m in moved), default=0.0)]
            for p in ref["poses"] if part is None or p[0] < part]
        spread = {k: (min(r[k] for r in runs.values()),
                      max(r[k] for r in runs.values()))
                  for k in SPREAD_KEYS if k in ref}
        if "ba_costs" in ref:
            spread["ba_costs"] = [
                (min(r["ba_costs"][i] for r in runs.values()),
                 max(r["ba_costs"][i] for r in runs.values()))
                for i in range(min(3, len(ref["ba_costs"])))]
        print(json.dumps({"run": name, "jax_track_accept": keep,
                          "jax_track_accept_spread": spread}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ba-refine", action="store_true")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--renderer", choices=("port", "jax"), default="port")
    p.add_argument("--port", action="store_true")
    p.add_argument("--replay", type=int, default=0)
    p.add_argument("--perturb", default="0",
                   help="K, or with --run a list K,K,...")
    p.add_argument("--poses", action="store_true")
    p.add_argument("--run", default=None)
    p.add_argument("--collect", nargs="+", default=None)
    p.add_argument("--cache", default=None,
                   help="keep the port's rendered frames in this directory "
                        "and read them back on a later call")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.collect:
        return collect(args.collect)
    import chip_smoke
    perturb = [int(k) for k in args.perturb.split(",")]
    if args.run is not None:
        if args.run not in chip_smoke.TRACK_ACCEPT_RUNS:
            p.error(f"--run: one of {sorted(chip_smoke.TRACK_ACCEPT_RUNS)}")
        if args.renderer != "port":
            p.error("--run takes the port's frames")
        seq_kw = chip_smoke.track_sequence(args.run)
        frames_n = args.frames or chip_smoke.ACCEPT_FRAMES
        ba_refine = bool(chip_smoke.track_option(args.run, "--ba-refine"))
        occlude = chip_smoke.track_option(args.run, "--occlude")
        config = chip_smoke.track_option(args.run, "--config")
        config = config and os.path.join(REPO, config)
    else:
        if len(perturb) > 1:
            p.error("a list of --perturb needs --run")
        seq_kw = dict(motion="strafe", scene="room")
        frames_n = args.frames or 60
        ba_refine, occlude, config = args.ba_refine, None, None

    import jax
    import flame_ros_tpu.frontends.nodelet as jnodelet
    import flame_ros_tpu.models.ba as jba
    from flame_ros_tpu.config import FlameParams
    from flame_ros_tpu.datasets import synthetic as jsyn
    from flame_ros_tpu.frontends.offline_runner import (run_offline_tracking,
                                                         with_occlusion)
    from flame_ros_tpu.geometry.camera import Pinhole
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence

    cam = Pinhole(VGA.fx, VGA.fy, VGA.cx, VGA.cy, VGA.width, VGA.height)
    path = args.cache and os.path.join(
        args.cache, chip_smoke.sequence_key(frames_n, seq_kw) + ".npz")
    if path and os.path.exists(path):
        z = np.load(path)
        port = {k: z[k] for k in z.files}
    else:
        pseq = make_sequence(frames_n, VGA, device="cpu", **seq_kw)
        port = {"images": pseq.images.numpy(), "depths": pseq.depths.numpy(),
                "q": pseq.poses.q.numpy(), "t": pseq.poses.t.numpy(),
                "timestamps": np.asarray(pseq.timestamps, np.float64)}
        del pseq
        if path:
            os.makedirs(args.cache, exist_ok=True)
            np.savez(path + ".tmp.npz", **port)
            os.replace(path + ".tmp.npz", path)
    gray = {"port": port["images"]}
    if args.run is None:
        jseq = jsyn.make_sequence(n_frames=frames_n, cam=cam,
                                  motion="strafe", scene="room")
        gray["jax"] = np.asarray(jseq.images)
        d = np.abs(gray["port"] - gray["jax"])
        print(json.dumps({"renderers_gray_abs_diff_max": float(d.max()),
                          "renderers_gray_abs_diff_mean": float(d.mean())}))
    if args.renderer == "port":
        deps, q, t = port["depths"], port["q"], port["t"]
        stamps = [float(s) for s in port["timestamps"]]
    else:
        deps = np.asarray(jseq.depths)
        q, t = np.asarray(jseq.poses.q), np.asarray(jseq.poses.t)
        stamps = [float(s) for s in jseq.timestamps]
    params = FlameParams.from_yaml(config) if config else FlameParams()

    def frames(imgs):
        out = (Frame(i, stamps[i], imgs[i], deps[i], q[i], t[i])
               for i in range(len(stamps)))
        return with_occlusion(out, *map(int, occlude.split(":"))) \
            if occlude else out

    calls, route = [], {"unsharded": [], "sharded": [], "frames": []}
    hybrid, sharded = jba.hybrid_bundle_adjust, \
        jba.hybrid_bundle_adjust_sharded

    def keep_call(*a, **kw):
        route["unsharded"].append(int(a[4].shape[0]))
        route["frames"].append(int(nodes[-1].trajectory[-1][0]))
        res = hybrid(*a, **kw)
        if len(calls) < args.replay:
            calls.append(([np.asarray(x) for x in a],
                          {k: v for k, v in kw.items() if k != "cam"},
                          {f: np.asarray(getattr(res, f))
                           for f in res._fields}))
        return res

    def keep_sharded(*a, **kw):
        route["sharded"].append(int(a[5].shape[0]))
        route["frames"].append(int(nodes[-1].trajectory[-1][0]))
        return sharded(*a, **kw)

    jba.hybrid_bundle_adjust = keep_call
    jba.hybrid_bundle_adjust_sharded = keep_sharded
    nodes = _keep_nodes(jnodelet)
    head = {"renderer": args.renderer}
    if args.run is not None:
        head = {"run": args.run, "argv": chip_smoke.track_argv(args.run),
                "jax_devices": len(jax.devices())}
    for k in perturb:
        imgs = perturbed(gray[args.renderer], k)
        for v in route.values():
            v.clear()
        t0 = time.perf_counter()
        res = run_offline_tracking(frames(imgs), cam, params,
                                   ba_refine=ba_refine)
        line = {"package": "jax", **head, "perturb": k,
                **_summary(res, nodes[-1], time.perf_counter() - t0,
                           args.poses or args.run is not None)}
        if args.run is not None:
            line["ba_route"] = {r: {"solves": len(route[r]), "points": sorted(
                set(route[r]))} for r in ("unsharded", "sharded")}
            line["ba_frames"] = list(route["frames"])
        print(json.dumps(line), flush=True)

    if args.port or calls:
        import torch
        import flame_ros_torch.frontends.nodelet as tnodelet
        from flame_ros_torch.config import FlameParams as TParams
        from flame_ros_torch.frontends.offline_runner import \
            run_offline_tracking as t_run
        from flame_ros_torch.models.ba import hybrid_bundle_adjust
    for i, (a, kw, ref) in enumerate(calls):
        out = hybrid_bundle_adjust(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in a),
            cam=VGA, **kw)
        diff = {f: float(np.abs(getattr(out, f).numpy() - ref[f]).max())
                for f in ("q", "t", "idepths", "gains", "offsets")}
        diff["final_cost"] = [float(out.final_cost),
                              float(ref["final_cost"])]
        diff["final_cost_rel"] = abs(float(out.final_cost)
                                     / float(ref["final_cost"]) - 1.0)
        print(json.dumps({"replay": i, "port_minus_jax": diff}))
    if args.port:
        tparams = TParams.from_yaml(config) if config else TParams()
        nodes = _keep_nodes(tnodelet)
        imgs = perturbed(gray[args.renderer], perturb[0])
        t0 = time.perf_counter()
        res = t_run(frames(imgs), VGA, tparams, ba_refine=ba_refine,
                    device="cpu")
        print(json.dumps({"package": "torch (CPU)", **head,
                          "perturb": perturb[0],
                          **_summary(res, nodes[-1],
                                     time.perf_counter() - t0,
                                     args.poses or args.run is not None)}))


if __name__ == "__main__":
    main()
