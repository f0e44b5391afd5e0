#!/usr/bin/env python3
"""The JAX package's tracking-mode numbers on the port's rendered frames.

    JAX_PLATFORMS=cpu python scripts/jax_tracking_reference.py --ba-refine
        [--renderer jax] [--port] [--replay N] [--perturb K] [--poses]

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
           "rpe_trans_rmse": res.rpe_trans_rmse,
           "rpe_rot_rmse_deg": res.rpe_rot_rmse_deg,
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ba-refine", action="store_true")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--renderer", choices=("port", "jax"), default="port")
    p.add_argument("--port", action="store_true")
    p.add_argument("--replay", type=int, default=0)
    p.add_argument("--perturb", type=int, default=0)
    p.add_argument("--poses", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)

    import flame_ros_tpu.frontends.nodelet as jnodelet
    import flame_ros_tpu.models.ba as jba
    from flame_ros_tpu.config import FlameParams
    from flame_ros_tpu.datasets import synthetic as jsyn
    from flame_ros_tpu.frontends.offline_runner import run_offline_tracking
    from flame_ros_tpu.geometry.camera import Pinhole
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence

    cam = Pinhole(VGA.fx, VGA.fy, VGA.cx, VGA.cy, VGA.width, VGA.height)
    pseq = make_sequence(args.frames, VGA, motion="strafe", scene="room",
                         device="cpu")
    jseq = jsyn.make_sequence(n_frames=args.frames, cam=cam,
                              motion="strafe", scene="room")
    gray = {"port": pseq.images.numpy(), "jax": np.asarray(jseq.images)}
    d = np.abs(gray["port"] - gray["jax"])
    print(json.dumps({"renderers_gray_abs_diff_max": float(d.max()),
                      "renderers_gray_abs_diff_mean": float(d.mean())}))
    if args.renderer == "port":
        seq, deps = pseq, pseq.depths.numpy()
        q, t = pseq.poses.q.numpy(), pseq.poses.t.numpy()
    else:
        seq, deps = jseq, np.asarray(jseq.depths)
        q, t = np.asarray(jseq.poses.q), np.asarray(jseq.poses.t)
    imgs = perturbed(gray[args.renderer], args.perturb)
    stamps = [float(s) for s in seq.timestamps]

    def frames():
        return (Frame(i, stamps[i], imgs[i], deps[i], q[i], t[i])
                for i in range(len(stamps)))

    calls = []
    hybrid = jba.hybrid_bundle_adjust

    def keep_call(*a, **kw):
        res = hybrid(*a, **kw)
        if len(calls) < args.replay:
            calls.append(([np.asarray(x) for x in a],
                          {k: v for k, v in kw.items() if k != "cam"},
                          {f: np.asarray(getattr(res, f))
                           for f in res._fields}))
        return res

    jba.hybrid_bundle_adjust = keep_call
    nodes = _keep_nodes(jnodelet)
    t0 = time.perf_counter()
    res = run_offline_tracking(frames(), cam, FlameParams(),
                               ba_refine=args.ba_refine)
    print(json.dumps({"package": "jax", "renderer": args.renderer,
                      "perturb": args.perturb,
                      **_summary(res, nodes[-1], time.perf_counter() - t0,
                                 args.poses)}), flush=True)

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
        diff["final_cost_rel"] = abs(float(out.final_cost)
                                     / float(ref["final_cost"]) - 1.0)
        print(json.dumps({"replay": i, "port_minus_jax": diff}))
    if args.port:
        nodes = _keep_nodes(tnodelet)
        t0 = time.perf_counter()
        res = t_run(frames(), VGA, TParams(), ba_refine=args.ba_refine,
                    device="cpu")
        print(json.dumps({"package": "torch (CPU)",
                          "renderer": args.renderer,
                          "perturb": args.perturb,
                          **_summary(res, nodes[-1],
                                     time.perf_counter() - t0,
                                     args.poses)}))


if __name__ == "__main__":
    main()
