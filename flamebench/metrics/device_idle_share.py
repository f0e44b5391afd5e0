"""Share of the traced span in which no device activity ran: 1 - the
union of the trace's device intervals over the span's length."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
