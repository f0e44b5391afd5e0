#!/usr/bin/env python3
"""A/B of the v4 and v2 raster kernels' design choices, on one GPU.

    python3 scripts/raster_ab.py

Builds `flame_ros_torch/csrc/raster.cu` as it is and with one change at
a time — staging chunks of 128 candidates instead of 256; no per-warp
cull (every warp tests every candidate that survived the block's cull) —
and runs each on tiles of 2 rows, and the source as it is on tiles of 4
rows too. On chip_smoke.py's phase-3 meshes it times each kernel on the
card alone (chip_smoke.device_ms: launches queued back to back) after
holding its output equal to the plain version. Prints one JSON line per
mesh, variant and tile height, then the card's nvidia-smi name and power
limit. The variant libraries are built into csrc/build/.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "as_is": [],
    "chunk_128": [("constexpr int CH = 256;", "constexpr int CH = 128;")],
    "no_warp_cull": [("keep = overlaps(box, warp_rect);", "keep = true;")],
}
CASES = ("engine_density", "unsorted", "sliver", "multi_chunk")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("raster_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from flame_ros_torch.graph.delaunay import triangulate
    from flame_ros_torch.ops import raster_cuda as rc
    src = open(rc._SRC).read()
    os.makedirs(rc._BUILD, exist_ok=True)
    libs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in raster.cu")
            text = text.replace(old, new)
        cu = os.path.join(rc._BUILD, f"ab_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        subprocess.run([rc._nvcc(), *rc.NVCC_FLAGS, "-o", so, cu],
                       check=True, capture_output=True, timeout=600)
        libs[name] = rc.load(so)
    H, W = 480, 640
    meshes = cs.make_meshes(triangulate, np, H, W)
    runs = [(v, 2) for v in VARIANTS] + [("as_is", 4)]
    for case in CASES:
        (pos, tp, tv), _ = meshes[case]
        args = [torch.from_numpy(a).cuda() for a in (pos, tp, tv)]
        for variant, rt in runs:
            row = {"case": case, "variant": variant, "row_tile": rt}
            for kernel, ref in (("v4", rc.rasterize_tri_ids_v4_ref),
                                ("v2", rc.rasterize_tri_ids_v2_ref)):
                fn = cs.bare_launch(rc, kernel, args, H, W, {},
                                    lib=libs[variant], rt=rt)
                fn()
                torch.cuda.synchronize()
                if not torch.equal(fn.out, ref(*args, height=H, width=W,
                                               row_tile=rt)):
                    raise AssertionError(f"{kernel} {variant} rt={rt} != "
                                         f"plain on {case}")
                row[f"{kernel}_device_ms"] = cs.device_ms(fn, reps=40,
                                                          rounds=7)
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
