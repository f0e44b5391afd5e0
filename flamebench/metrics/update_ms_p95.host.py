"""95th percentile over the window's steps outside the traced span of
the host time from `update()` being called to its `flush_stats()`
returning: the latency a camera frame sees (numpy's linear percentile).
It falls on poseframe steps, which carry the synchronous Delaunay round.
Per-layer: its spread across runs exceeds what a bound may cover
(PERF.md §2)."""
import numpy as np


def read(ctx):
    lat = [s.t_stats - s.t_call for s in ctx.window.steps if not s.traced]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
