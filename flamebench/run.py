"""Run one cell of the benchmark once:

    python3 -m flamebench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `check`, each number compared with
its limit (also the last lines of standard error). An earlier line,
`{"info": ...}`, records the run's thread count, pool bytes, peak memory
and the check's own seconds.

`--control bf16` runs the program with its bfloat16 epipolar gathers
(`engine.compute_dtype`), the control whose `correct` must come out
false; the benchmark's own runs never pass it.

Exits non-zero with no result where there is no card, too few cards, or
where `jax`, `jaxlib`, `flax` or `flame_ros_tpu` is loaded once the
window has closed."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

THREADS = 4                      # the harness's own intra-op CPU threads
FORBIDDEN = ("jax", "jaxlib", "flax", "flame_ros_tpu")
CONTROLS = {"bf16": {"engine": {"compute_dtype": "bfloat16"}}}


def _err(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _p50(values):
    return float(np.median(values)) if len(values) else None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, "flamebench", "build")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions")}


def parse(argv):
    p = argparse.ArgumentParser(prog="flamebench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=sorted(CONTROLS))
    return p.parse_args(argv)


def run(config: dict, mix: dict, seed: int, seconds: float, device,
        metric_specs: list, trace: bool = False, override=None,
        t_start: float = T_START):
    """Set-up, the window, the metrics and the check of one run on
    `device`: (result object, info object)."""
    import torch
    from flamebench import check, harness
    from flamebench.manifest import reader
    cuda = torch.device(device).type == "cuda"
    drv = harness.driver(mix["driver"])
    prog = drv.Program(config, mix, seed, seconds, device, override)
    prog.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    res = harness.window(prog, seconds, trace=trace)
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = argparse.Namespace(setup_s=setup_s, window=res,
                             readings=res.readings, trace=res.trace)
    metrics = {}
    for m in metric_specs:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    health = [r["health"] for step in res.steps for r in step.rows]
    lat = {pf: [1e3 * (s.t_stats - s.t_call) for s in res.steps
                if s.is_pf == pf and not s.traced] for pf in (False, True)}
    rounds = res.readings.get("tri_round_s", [])
    every = lat[False] + lat[True]
    spread = {"update_ms_p95": (float(np.percentile(every, 95))
                                if every else None),
              "ordinary_ms_p50": _p50(lat[False]),
              "poseframe_ms_p50": _p50(lat[True]),
              "round_ms_p50": _p50([1e3 * r for r in rounds])}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": False, "attempted": len(health),
           "failed": sum(1 for h in health if h != 1.0),
           "metrics": metrics, "device": device_info}
    if res.trace is not None:
        tr = res.trace
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {
            "device_ops": [[n[:96], v] for n, v in tr["device_ops"]],
            "idle_gaps": [[n, v] for n, v in tr["idle_gaps"]]}
    # The check: the program's answers to the host, the program freed,
    # then the reference.
    streams = drv.check_streams(mix, seed)
    answers = prog.outputs(streams)
    inputs = prog.inputs()
    render_s = prog.render_s
    n_window = len(res.steps)
    prog.close()
    del prog, res, ctx
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = drv.replay(config, mix, inputs, streams, device)
    out["correct"], out["check"] = check.verdict(check.compare(answers, ref))
    info = {"threads": torch.get_num_threads(),
            "pool_bytes": int(inputs["pool"].nbytes),
            "memory_peak_bytes": int(mem_peak), "steps": inputs["steps"],
            "window_steps": n_window, "checked_streams": streams,
            "check_s": time.perf_counter() - t_check, "setup_s": setup_s,
            "render_s": render_s,
            **spread}
    return out, info


def main(argv=None) -> int:
    args = parse(argv)
    from flamebench.manifest import ROOT, Manifest
    os.environ.update(cache_dirs(ROOT))
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available():
        _err("no CUDA device is available")
        return 2
    manifest = Manifest()
    cell = manifest.workload(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        _err(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
        return 2
    torch.set_num_threads(THREADS)
    from flamebench import traffic
    config = manifest.config(cell["config"])
    mix = traffic.load_mix(manifest.mix_path(cell["traffic"]))
    kind = "per_layer" if args.trace else "end_to_end"
    out, info = run(config, mix, args.seed, args.seconds,
                    torch.device("cuda", 0), manifest.data[kind],
                    trace=bool(args.trace),
                    override=CONTROLS.get(args.control))
    found = forbidden_modules()
    if found:
        _err(f"loaded after the window: {found}")
        return 3
    info["control"] = args.control
    print(json.dumps({"info": info}), flush=True)
    print(json.dumps(out), flush=True)
    for k, v in out["check"].items():
        _err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
