"""How busy the codec-8 pack pool keeps its threads, %: the thread time of
the program's ``pack.page`` spans over the wall time of their ``pack``
span (``compress.pack_pages``) times the pool's threads (min(pages of the
batch, os.cpu_count()), as ``pack_pages`` sizes the pool).  Time a page's
thread waits for the interpreter's lock counts as busy."""

import os

from core import program_spans


def read(ctx):
    got = program_spans.window(ctx)
    if not got:
        return None
    pages: dict = {}
    for s in got[0]:
        if s.name == "pack.page" and s.parent is not None:
            pages.setdefault(id(s.parent), []).append(s.end - s.start)
    busy = offered = 0
    for s in got[0]:
        if s.name == "pack" and id(s) in pages:
            busy += sum(pages[id(s)])
            workers = min(len(pages[id(s)]), os.cpu_count() or 1)
            offered += (s.end - s.start) * workers
    return 100.0 * busy / offered if offered else None
