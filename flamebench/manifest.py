"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration is `configs[].file`, its mix `traffic/<traffic>.json`, the
program that serves the mix `drivers/<mix's driver>.py`, and each metric
`metrics/<name>.py`, a reader with `read(ctx)` that returns the value or
None where it finds nothing to read. A reader sees `ctx.setup_s`,
`ctx.window` (the window's `harness.Step`s and seconds), `ctx.readings`
(the driver's own counters over the window) and, in a traced run,
`ctx.trace` (`trace.analyse`: the raw device events by step, the kept
call arguments, busy and span seconds), else None."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix_path(self, traffic: str) -> str:
        return os.path.join(HERE, "traffic", f"{traffic}.json")


def reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "flamebench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
