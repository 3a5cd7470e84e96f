"""Milliseconds a page, closed loop: the window's time over the pages it
finished (host clock; the window closes with the page in flight)."""


def read(ctx):
    w = ctx.window
    return w.seconds * 1e3 / w.pages
