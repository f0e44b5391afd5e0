"""Share of its roofline that `raster_v4_batched_kernel` reached in the
traced span: the least time of each launch on its own inputs
(`roofline.v4_batched_bound_s` of the arguments the trace kept), summed,
over the kernel's device time from the trace."""
from flamebench.roofline import v4_batched_bound_s


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls = tr["calls"].get("raster_v4_batched", [])
    dev_s = sum(b - a for a, b, name, _ in tr["events"]
                if "raster_v4_batched" in name)
    if not calls or dev_s <= 0:
        return None
    bound = sum(v4_batched_bound_s(a[0], a[1], a[2], kw["height"],
                                   kw["width"])[0] for a, kw in calls)
    return 100.0 * bound / dev_s
