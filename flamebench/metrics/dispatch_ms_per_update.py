"""Mean host ms of `update()` (pack, pinned upload, the batched step's
dispatch) over the window's ordinary (non-poseframe) steps outside the
traced span."""
import numpy as np


def read(ctx):
    d = [s.t_dispatched - s.t_call for s in ctx.window.steps
         if not s.is_pf and not s.traced]
    return float(np.mean(d) * 1e3) if d else None
