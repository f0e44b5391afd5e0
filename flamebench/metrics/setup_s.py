"""Process start to the window: imports, kernel and library builds or
loads, rendering the pool, building the runner and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
