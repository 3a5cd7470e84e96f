"""Closed loop, one client: the pool's pages one at a time, in turn,
through the program's ``page_entry`` (the entry its CLI's ``compress``
takes for a PBM page).  Set-up warms the entry on the first two pages;
the window closes with the page in flight at ``--seconds``.

``correct``: every served answer is the first answer for its page again;
every answer's BIC1 header names its page; the pages drawn from the seed
are the reference's streams, byte for byte.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import numpy as np

from core import checks


def run(cell, pool, seconds, device, program, win):
    entry = program.page_entry(cell.config, device, win.profile)
    entry(pool[0])                                        # warm the shape
    entry(pool[1 % len(pool)])
    first: dict[int, bytes] = {}
    inconsistent = collections.Counter()
    n, ends = 0, []
    win.begin(device)
    while True:
        i = n % len(pool)
        out = entry(pool[i])
        ends.append(time.perf_counter())
        n += 1
        if i not in first:
            first[i] = out
        elif out != first[i]:
            inconsistent[i] += 1
        if ends[-1] - win.t0 >= seconds:
            break
    win.end()
    served = [k % len(pool) for k in range(n)]
    return SimpleNamespace(
        t_window=win.t0, seconds=win.t1 - win.t0, pages=n, served=served,
        steps=np.diff([win.t0] + ends),
        pixels=sum(pool[i].size for i in served), first=first,
        inconsistent=inconsistent)


def compare(cell, w, pool, seed, device, ck, reference) -> None:
    pick = checks.sample(w.served, cell.traffic["check_pages"], seed)
    ck.add("pages_unlike_first", sum(w.inconsistent.values()))
    counts = collections.Counter(w.served)
    heads = sum(counts[i] * checks.header_faults(b, pool[i])
                for i, b in w.first.items())
    ck.add("header_faults", heads)
    wrong = sum(counts[i] for i in pick
                if reference.stream(pool[i], cell.config, device)
                != w.first[i])
    ck.add("sampled_pages_wrong", wrong)
    w.failed = wrong + heads + sum(w.inconsistent.values())
    ck.add("no_page_checked", int(not pick))
