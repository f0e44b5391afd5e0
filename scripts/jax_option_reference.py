#!/usr/bin/env python3
"""The JAX package's per-frame numbers with one engine option turned on.

    JAX_PLATFORMS=cpu python scripts/jax_option_reference.py \
        --option bfloat16|matmul|none [--port]

Renders the phase-4 sequence of `chip_smoke.py` (room scene, strafe,
VGA, 60 frames) with the port's renderer on the CPU, runs the JAX
package's `run_offline` over those frames on the CPU with the default
FlameParams and the option:

- `bfloat16`: `engine.compute_dtype="bfloat16"` (bf16 copies of the
  image and keyframe pyramids feed the epipolar gathers);
- `matmul`: `engine.nltgv2_adjoint="matmul"` (the NLTGV2 adjoint as one
  product with the [V, 2E] incidence matrix, contributions rounded to
  bf16);
- `none`: neither (the f32 gather run, for scale),

and prints one JSON line with the runner's summary. These are
`chip_smoke.py`'s `JAX_BF16_VGA` and `JAX_MATMUL_VGA`. --port also runs
the port's `run_offline` on the CPU over the same frames with the same
option and prints its line.

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
OPTIONS = {"bfloat16": {"engine": {"compute_dtype": "bfloat16"}},
           "matmul": {"engine": {"nltgv2_adjoint": "matmul"}},
           "none": {}}


class Frame:
    def __init__(self, i, t, gray, depth, q, tr):
        self.img_id, self.time, self.gray, self.depth = i, t, gray, depth
        self.quat, self.trans = q, tr


def _summary(res, seconds):
    out = {"frames": res.frames_processed, "failed": res.frames_failed,
           "idepth_rmse": res.mean_rmse, "precision": res.mean_precision,
           "recall": res.mean_recall, "coverage": res.final_coverage,
           "abs_rel": res.final_abs_rel, "delta1": res.final_delta1,
           "seconds": seconds}
    return {k: (float(v) if isinstance(v, np.floating) else v)
            for k, v in out.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--option", choices=sorted(OPTIONS), required=True)
    p.add_argument("--port", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)

    from flame_ros_tpu.config import FlameParams
    from flame_ros_tpu.frontends.offline_runner import run_offline
    from flame_ros_tpu.geometry.camera import Pinhole
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence

    cam = Pinhole(VGA.fx, VGA.fy, VGA.cx, VGA.cy, VGA.width, VGA.height)
    seq = make_sequence(60, VGA, motion="strafe", scene="room",
                        device="cpu")
    imgs, deps = seq.images.numpy(), seq.depths.numpy()
    q, t = seq.poses.q.numpy(), seq.poses.t.numpy()
    stamps = [float(s) for s in seq.timestamps]

    def frames():
        return (Frame(i, stamps[i], imgs[i], deps[i], q[i], t[i])
                for i in range(len(stamps)))

    option = OPTIONS[args.option]
    t0 = time.perf_counter()
    res = run_offline(frames(), cam, FlameParams.from_dict(option))
    print(json.dumps({"package": "jax", "option": args.option,
                      **_summary(res, time.perf_counter() - t0)}),
          flush=True)
    if args.port:
        from flame_ros_torch.config import FlameParams as TParams
        from flame_ros_torch.frontends.offline_runner import \
            run_offline as t_run
        t0 = time.perf_counter()
        res = t_run(frames(), VGA, TParams.from_dict(option), device="cpu")
        print(json.dumps({"package": "torch (CPU)", "option": args.option,
                          **_summary(res, time.perf_counter() - t0)}))


if __name__ == "__main__":
    main()
