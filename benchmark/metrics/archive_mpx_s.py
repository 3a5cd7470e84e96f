"""Megapixels archived a second: every page of every archive job that
finished in the window, over the window's time (host clock)."""


def read(ctx):
    w = ctx.window
    return w.pixels / w.seconds / 1e6
