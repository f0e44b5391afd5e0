"""The trace's readers on a hand-made trace: the raw events a metric
file computes its own aggregate from, and the hooks that move a
function's counters to its wrapper and back."""
import types

import pytest
import torch

from flamebench import manifest, roofline
from flamebench.harness import Step
from flamebench.trace import Tracer


def _ctx():
    steps = [Step(0.0, 0.1, 0.2, True, 8, []),
             Step(0.2, 0.3, 0.4, False, 8, []),
             Step(0.4, 0.5, 0.6, False, 8, [])]
    events = [(0.01, 0.02, "fill", 0), (0.21, 0.22, "gemm", 1),
              (0.23, 0.25, "raster_v4_batched_kernel", 1),
              (0.41, 0.42, "gemm", 2), (0.61, 0.62, "copy", -1)]
    pos = torch.tensor([[[0.0, 0.0], [4.0, 0.0], [0.0, 3.0]]])
    tris = torch.tensor([[[0, 1, 2]]], dtype=torch.int32)
    tv = torch.tensor([[True]])
    calls = {"raster_v4_batched": [((pos, tris, tv),
                                    {"height": 4, "width": 6})]}
    trace = {"busy_s": 0.06, "window_s": 0.7, "events": events,
             "steps": steps, "calls": calls}
    return types.SimpleNamespace(trace=trace, readings={}, window=None,
                                 setup_s=1.0)


def test_launches_count_ordinary_steps_only():
    # Steps 1 and 2 are ordinary: 2 + 1 events over 2 steps.
    assert manifest.reader("launches_per_update")(_ctx()) == 1.5


def test_roofline_reads_its_own_calls():
    ctx = _ctx()
    bound, _ = roofline.v4_batched_bound_s(
        *ctx.trace["calls"]["raster_v4_batched"][0][0], 4, 6)
    got = manifest.reader("raster_v4_batched_roofline")(ctx)
    assert got == pytest.approx(100.0 * bound / 0.02)


def test_idle_share():
    got = manifest.reader("device_idle_share")(_ctx())
    assert got == pytest.approx(100.0 * (1 - 0.06 / 0.7))


@pytest.mark.parametrize("name", ["launches_per_update",
                                  "raster_v4_batched_roofline",
                                  "device_idle_share",
                                  "delaunay_ms_per_stream"])
def test_nothing_to_read_gives_none(name):
    ctx = types.SimpleNamespace(trace=None, readings={}, window=None)
    assert manifest.reader(name)(ctx) is None


def test_hooks_keep_the_counters():
    mod = types.ModuleType("m")

    def kernel(x):
        mod.kernel.launches += 1      # through the module name
        return x
    kernel.launches = 5
    mod.kernel = kernel
    tr = Tracer(types.SimpleNamespace())
    tr._wrap(mod, "kernel", lambda orig: lambda *a: orig(*a))
    assert mod.kernel is not kernel and mod.kernel.launches == 5
    mod.kernel(1)
    mod.kernel(2)
    for undo in tr._undo:
        undo()
    assert mod.kernel is kernel and kernel.launches == 7
