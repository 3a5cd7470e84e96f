"""The spans of every rank of a multi-rank cell, job by job, for the
readers of the sharded archive's layer.

The loop of such a cell (``loops/archive_x4.py``) adds the other ranks'
spans to the program's recorder in this process, rank 0's, after the
window, with the rank in the high bits of their request ids
(``RANK_SHIFT``); ``program_spans.window`` then keeps every rank's spans
that started inside the window, on the host's one clock.  Where the
program keeps no spans, or a rank ran no job in the window, there is
nothing to read and ``jobs`` returns None.
"""

from __future__ import annotations

import collections
import statistics

from core import program_spans
from loops.archive_x4 import RANK_SHIFT


def jobs(ctx):
    """Per job of the window, in order: {rank: {span name: seconds summed
    over that rank's part of the job}}, for the jobs that every rank ran
    in the window; None where there are none."""
    got = program_spans.window(ctx)
    if not got:
        return None
    spans = got[0]
    roots: dict[int, list] = collections.defaultdict(list)
    for s in spans:
        if s.name == "archive_job" and s.parent is None:
            roots[s.request >> RANK_SHIFT].append(s)
    if len(roots) < ctx.cell.config["ranks"]:
        return None
    seconds: dict[int, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for s in spans:
        seconds[s.request][s.name] += (s.end - s.start) / 1e9
    order = {r: sorted(v, key=lambda s: s.start) for r, v in roots.items()}
    n = min(len(v) for v in order.values())
    return [{r: seconds[v[k].request] for r, v in order.items()}
            for k in range(n)] or None


def median_over_jobs(ctx, of_job):
    """The median over the window's jobs of of_job(job), or None."""
    js = jobs(ctx)
    return statistics.median(of_job(j) for j in js) if js else None
