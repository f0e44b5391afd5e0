"""Camera frames whose stats reached the host in the window, over the
window's seconds (host clock, from the window's start to the last
step's read)."""


def read(ctx):
    return sum(s.frames for s in ctx.window.steps) / ctx.window.seconds
