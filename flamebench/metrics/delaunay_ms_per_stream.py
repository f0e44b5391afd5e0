"""Host ms of the runner's Delaunay rounds in the window
(`MultiStreamRunner.tri_round_s`, its own clock around a round's
builds) per round and stream."""


def read(ctx):
    r = ctx.readings.get("tri_round_s")
    return 1e3 * sum(r) / (len(r) * ctx.readings["streams"]) if r else None
