"""Seconds from the process's start to the first timed call: imports,
making the pages, building or loading the kernels and the native library,
and the warm-up of the cell's one shape (host clock)."""


def read(ctx):
    return ctx.window.setup_s
