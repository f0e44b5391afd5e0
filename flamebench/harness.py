"""Drive one cell: the mix's `driver` key names a module
`drivers/<driver>.py` that builds the program under test and runs one
step of it; this module runs the window around those steps.

A driver module gives:

- `MIX_KEYS`: the mix keys it reads;
- `Program(config, mix, seed, seconds, device, override)` with
  - `setup()`: the inputs (`render_s`: their seconds), the program,
    and the warm-up steps, made through `step()` itself, so every
    kernel the window runs is built;
  - `step() -> Step`: one closed-loop step (send, then read its answers
    back), with the host clock read at the points `Step` names;
  - `mark()` and `readings(mark) -> dict`: the program's own counters
    over the window, which the metric readers see as `ctx.readings`;
  - `hooks() -> (spans, calls)`, for a traced run: `(owner, attribute,
    span name)` of program calls whose host spans label the idle gaps,
    and `(owner, attribute, key)` of calls whose arguments the trace
    keeps under `ctx.trace["calls"][key]`;
  - `inputs()`, `outputs(streams)` and `close()`: what the check reads;
- `check_streams(mix, seed)` and `replay(config, mix, inputs, streams,
  device)`: the streams the check replays and the plain reference's
  answers for them, under the keys of `outputs`.

The window is the loop of `step()` calls and nothing else: no rendering,
no copies for the check, no logging. A traced run wraps the driver's
hooks and runs `torch.profiler` over `TRACE_UPDATES` steps of the window
only (`trace.py`)."""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass

TRACE_SKIP = 12       # window steps before the traced span
TRACE_UPDATES = 24    # steps in the traced span: four poseframe periods


@dataclass
class Step:
    t_call: float          # the step sent
    t_dispatched: float    # the sending call returned
    t_stats: float         # its answers read back on the host
    is_pf: bool            # a poseframe step
    frames: int            # camera frames the step advanced
    rows: list             # its stats rows, one dict a frame
    traced: bool = False


@dataclass
class WindowResult:
    steps: list
    seconds: float
    readings: dict
    trace: dict | None = None        # trace.analyse of a traced run


def driver(name: str):
    """The module `drivers/<name>.py`."""
    return importlib.import_module(f"flamebench.drivers.{name}")


def window(program, seconds: float, trace: bool = False) -> WindowResult:
    """Step `program` in a closed loop until `seconds` have passed (and,
    traced, until the traced span is over)."""
    from flamebench import trace as trace_mod
    steps = []
    mark = program.mark()
    tracer = trace_mod.Tracer(program) if trace else None
    t0 = time.perf_counter()
    while True:
        j = len(steps)
        if tracer is not None and j == TRACE_SKIP:
            tracer.start()
        s = program.step()
        s.traced = tracer is not None and tracer.active
        steps.append(s)
        if tracer is not None and j == TRACE_SKIP + TRACE_UPDATES - 1:
            tracer.stop()
        if s.t_stats - t0 >= seconds and (tracer is None or tracer.done):
            break
    res = WindowResult(steps=steps, seconds=steps[-1].t_stats - t0,
                       readings=program.readings(mark))
    if tracer is not None:
        res.trace = trace_mod.analyse(tracer, res)
    return res


def merge(base: dict, over: dict) -> dict:
    """`base` with the nested entries of `over` put in."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out
