"""The traced span of a `--trace 1` run: `torch.profiler` (device
activity only) over `harness.TRACE_UPDATES` window steps, host spans
around each step and around the driver's span hooks, and the arguments
of the driver's call hooks.

The profiler's clock is tied to the host clock by a marker: with the
device idle, the host clock is read and one fill is launched; the
earliest device event of the trace is that fill. Host spans then place
every device event and every idle gap: a gap is charged to the span that
holds its midpoint (a hook's span name, "update.dispatch",
"flush_stats", or "harness" between a step's read and the next call).

`analyse` hands the metric readers the raw events, so a reader computes
its own aggregate: `events`, (start, end, name, step) in the host clock,
`step` the index into `steps` (the traced steps) of the step whose
[t_call, t_stats) holds the event's start, or -1."""
from __future__ import annotations

import time
from collections import defaultdict


class Tracer:
    def __init__(self, program):
        self.program = program
        self.active = self.done = False
        self.spans = []
        self.calls = defaultdict(list)
        self._undo = []

    def _wrap(self, owner, attr, make):
        orig = getattr(owner, attr)
        own = attr in vars(owner)
        w = make(orig)
        # Counters the original keeps on itself and increments through
        # its module name move to the wrapper, and back at the end.
        w.__dict__.update(getattr(orig, "__dict__", {}))

        def undo():
            for k in getattr(orig, "__dict__", {}):
                setattr(orig, k, w.__dict__[k])
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        setattr(owner, attr, w)
        self._undo.append(undo)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        spans, calls = self.program.hooks()
        for owner, attr, name in spans:
            def make(orig, name=name):
                def span(*a, **kw):
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **kw)
                    finally:
                        self.spans.append((t0, time.perf_counter(), name))
                return span
            self._wrap(owner, attr, make)
        for owner, attr, key in calls:
            def make(orig, key=key):
                def keep(*a, **kw):
                    self.calls[key].append((a, kw))
                    return orig(*a, **kw)
                return keep
            self._wrap(owner, attr, make)
        torch.cuda.synchronize(self.program.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.marker_host = time.perf_counter()
        torch.zeros(1, device=self.program.device)
        self.active = True

    def stop(self):
        import torch
        torch.cuda.synchronize(self.program.device)
        self.end_host = time.perf_counter()
        self.prof.stop()
        for undo in reversed(self._undo):
            undo()
        self.active, self.done = False, True


def device_events(prof) -> list:
    """(start_s, end_s, name) of every device activity of the trace
    (kernels, copies, fills), in the profiler's clock."""
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            out.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                        e.name))
    if not out:
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns() * 1e-9
                out.append((s, s + e.duration_ns() * 1e-9, e.name()))
    out.sort()
    return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def analyse(tracer, res) -> dict:
    raw = device_events(tracer.prof)
    if not raw:
        raise RuntimeError("the profiler recorded no device activity")
    # Host time of a device event: marker launch = first device event.
    off = raw[0][0] - tracer.marker_host
    w0, w1 = tracer.marker_host, tracer.end_host
    traced = [s for s in res.steps if s.traced]

    def step_of(a):
        for i, s in enumerate(traced):
            if s.t_call <= a < s.t_stats:
                return i
        return -1
    events = [(a - off, b - off, n, step_of(a - off))
              for a, b, n in raw[1:]]
    busy = _merge((max(a, w0), min(b, w1)) for a, b, _, _ in events
                  if b > w0 and a < w1)
    busy_s = sum(b - a for a, b in busy)

    spans = []
    for i, s in enumerate(traced):
        spans.append((s.t_call, s.t_dispatched, "update.dispatch"))
        spans.append((s.t_dispatched, s.t_stats, "flush_stats"))

    def label(t):
        for a, b, name in tracer.spans + spans:
            if a <= t < b:
                return name
        return "harness"

    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[label((a + b) / 2)] += b - a
    ops = defaultdict(float)
    for a, b, n, _ in events:
        ops[n] += b - a
    return {
        "busy_s": busy_s, "window_s": w1 - w0,
        "events": events, "steps": traced,
        "calls": dict(tracer.calls),
        "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:10],
    }
