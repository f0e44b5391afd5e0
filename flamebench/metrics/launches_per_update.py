"""Device activities (kernels, copies, fills) per ordinary (non-poseframe)
step in the traced span, from the profiler's trace: the events whose
start lies in such a step, over the number of such steps."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ordinary = {i for i, s in enumerate(tr["steps"]) if not s.is_pf}
    if not ordinary:
        return None
    return sum(1 for e in tr["events"] if e[3] in ordinary) / len(ordinary)
