#!/usr/bin/env python3
"""The JAX package's numbers for one run of the external-pose acceptance
protocol, on the port's rendered frames.

    JAX_PLATFORMS=cpu python scripts/jax_acceptance_reference.py \
        --run default|rotation|low_texture|rotation_low_texture|\
exposure_a|exposure_b|mav|primitives|tum|asl [--port] [--frames N]

The runs are `chip_smoke.py`'s `ACCEPT_RUNS`: the ten runs of
tests/test_acceptance.py and tests/test_acceptance_stress.py (VGA, 200
frames, default FlameParams). The script renders the run's sequence
with the port's renderer on the CPU. The synthetic runs go through the
JAX package's `run_offline` (with engine.zero_mean_ssd for
exposure_b). For tum and asl it writes the sequence as a TUM or an ASL
tree with the port's exporters (under run_out/jax_acceptance/<run>) and
runs the JAX package's CLI `main` over that tree, as the JAX tests do.
It prints one JSON line: the runner's summary keys, unrounded, and the
run's CPU seconds. These are `chip_smoke.py`'s `JAX_ACCEPT_VGA200`.

--port also runs the port's `run_offline` on the CPU over the same
frames (the port's CLI `main` for tum and asl) and prints its line.

Like the port's tests, this script imports both packages; it is not part
of the port.
"""
import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


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


def _cli(main, argv):
    """The CLI's RunResult, its printed line swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _dataset(name):
    return chip_smoke.ACCEPT_RUNS[name].get("dataset", "synthetic")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", choices=sorted(chip_smoke.ACCEPT_RUNS),
                   required=True)
    p.add_argument("--frames", type=int, default=chip_smoke.ACCEPT_FRAMES)
    p.add_argument("--port", action="store_true")
    args = p.parse_args(argv)

    from flame_ros_tpu.config import FlameParams
    from flame_ros_tpu.frontends.offline_runner import main as jax_main
    from flame_ros_tpu.frontends.offline_runner import run_offline
    from flame_ros_tpu.geometry.camera import Pinhole
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence

    spec = chip_smoke.ACCEPT_RUNS[args.run]
    seq = make_sequence(args.frames, VGA, device="cpu",
                        **chip_smoke.accept_sequence(args.run))
    option = ({"engine": {"zero_mean_ssd": True}}
              if spec.get("zero_mean_ssd") else {})
    synthetic = _dataset(args.run) == "synthetic"
    if synthetic:
        cam = Pinhole(VGA.fx, VGA.fy, VGA.cx, VGA.cy, VGA.width,
                      VGA.height)
        imgs, deps = seq.images.numpy(), seq.depths.numpy()
        q, t = seq.poses.q.numpy(), seq.poses.t.numpy()
        stamps = [float(s) for s in seq.timestamps]

        def frames():
            return (Frame(i, stamps[i], imgs[i], deps[i], q[i], t[i])
                    for i in range(len(stamps)))
    else:
        root = os.path.join(REPO, "run_out", "jax_acceptance", args.run)
        tree = chip_smoke.accept_tree(args.run, seq, root)
        del seq
    head = {"run": args.run, "seq": spec["seq"],
            "dataset": _dataset(args.run)}
    t0 = time.perf_counter()
    res = (run_offline(frames(), cam, FlameParams.from_dict(option))
           if synthetic else _cli(jax_main, tree))
    print(json.dumps({"package": "jax", **head,
                      **_summary(res, time.perf_counter() - t0)}),
          flush=True)
    if args.port:
        from flame_ros_torch.config import FlameParams as TParams
        from flame_ros_torch.frontends.offline_runner import main as t_main
        from flame_ros_torch.frontends.offline_runner import \
            run_offline as t_run
        t0 = time.perf_counter()
        res = (t_run(frames(), VGA, TParams.from_dict(option), device="cpu")
               if synthetic else _cli(t_main, tree + ["--device", "cpu"]))
        print(json.dumps({"package": "torch (CPU)", **head,
                          **_summary(res, time.perf_counter() - t0)}),
              flush=True)


if __name__ == "__main__":
    main()
