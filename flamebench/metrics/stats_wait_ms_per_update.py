"""Mean host ms of `flush_stats()` (the wait for the step's device work
and the stats copy) over the window's steps outside the traced span."""
import numpy as np


def read(ctx):
    d = [s.t_stats - s.t_dispatched for s in ctx.window.steps
         if not s.traced]
    return float(np.mean(d) * 1e3) if d else None
