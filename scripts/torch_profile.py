#!/usr/bin/env python3
"""Where a frame's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile.py [--frames 60] [--profile-from 30]
        [--profile-frames 12] [--out run_out/torch_profile]

Runs `run_offline` at VGA with the default FlameParams over a synthetic
room/strafe sequence rendered on the card, and traces frames
[profile-from, profile-from + profile-frames) with torch.profiler. Prints
JSON lines:

- "frames": host ms per traced frame (host clock, each frame ends in the
  stats read, a device sync), device-busy ms per frame (sum of the time
  of device events: kernels, copies, fills) and the idle share, and
  device events per frame;
- "stage": per engine stage (the `flame.*` profiler ranges of
  Flame.update): host ms and the kernel ms it launched, and its span on
  the device timeline, per frame;
- "kernel": the top device events by time per frame, and the raster
  kernels wherever they rank.

Tracing adds host time per launch, so host_ms_per_frame here is higher
than the untraced ms/frame of chip_smoke.py.

The Chrome trace is written under --out. Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev_time(evt, self_time=False):
    for name in (("self_device_time_total", "self_cuda_time_total")
                 if self_time else ("device_time_total", "cuda_time_total")):
        v = getattr(evt, name, None)
        if v is not None:
            return v / 1e3          # us -> ms
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--profile-from", type=int, default=30)
    p.add_argument("--profile-frames", type=int, default=12)
    p.add_argument("--out", default=os.path.join(REPO, "run_out",
                                                 "torch_profile"))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile
    from flame_ros_torch.config import FlameParams
    from flame_ros_torch.datasets.synthetic import VGA, make_sequence
    from flame_ros_torch.frontends.offline_runner import (run_offline,
                                                          synthetic_frames)
    from flame_ros_torch.models.engine import Flame
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    seq = make_sequence(args.frames, VGA, device=dev)
    engine = Flame(VGA.width, VGA.height, cam=VGA, params=FlameParams(),
                   device=dev)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    lo, hi = args.profile_from, args.profile_from + args.profile_frames
    stamps = {}

    def frames():
        for i, f in enumerate(synthetic_frames(seq)):
            if i == lo:
                torch.cuda.synchronize()
                prof.start()
                stamps["t0"] = time.perf_counter()
            if i == hi:
                stamps["t1"] = time.perf_counter()
                prof.stop()
            yield f

    run_offline(frames(), VGA, engine.params, device=dev, engine=engine)
    n = args.profile_frames
    host_ms = (stamps["t1"] - stamps["t0"]) * 1e3 / n
    events = prof.key_averages()

    def on_gpu(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # Kernels (and memcpy/memset) are the events that live on the device;
    # aten ops on the host also carry the device time of what they
    # launched, so only device events are summed.
    kernels = [e for e in events if on_gpu(e)
               and not e.key.startswith("flame.")]
    busy = sum(_dev_time(e, True) for e in kernels) / n
    launches = sum(e.count for e in kernels) / n
    print(json.dumps({"frames": n, "card": torch.cuda.get_device_name(0),
                      "host_ms_per_frame": host_ms,
                      "device_busy_ms_per_frame": busy,
                      "device_idle_share": max(0.0, 1 - busy / host_ms),
                      "device_events_per_frame": launches}))
    # Each flame.* range appears twice: on the host (its host time, and
    # the device time of the kernels it launched) and as a span on the
    # device timeline (first to last of its kernels, idle gaps included).
    for e in sorted((e for e in events if e.key.startswith("flame.")),
                    key=lambda e: (on_gpu(e), -e.cpu_time_total)):
        if on_gpu(e):
            print(json.dumps({"stage": e.key, "calls": e.count,
                              "device_span_ms_per_frame":
                                  _dev_time(e) / n}))
        else:
            print(json.dumps({"stage": e.key, "calls": e.count,
                              "host_ms_per_frame": e.cpu_time_total / 1e3 / n,
                              "kernel_ms_per_frame": _dev_time(e) / n}))
    top = sorted(kernels, key=lambda e: -_dev_time(e, True))
    for e in top[:15] + [e for e in top[15:] if "raster" in e.key]:
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms_per_frame": _dev_time(e, True) / n}))
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
