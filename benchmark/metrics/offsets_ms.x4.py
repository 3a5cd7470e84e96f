"""The all-gather of the page byte counts, ms a job: per job, the shortest
of the ranks' ``archive.offsets`` spans (``multihost.gather_page_bytes``).
The ranks meet there, so the others' spans hold their wait for the
slowest rank's encode; the slowest rank's, the shortest, holds the
collective's own time.  The median over the window's jobs."""

from core import rank_spans


def read(ctx):
    return rank_spans.median_over_jobs(
        ctx, lambda job: 1e3 * min(r["archive.offsets"]
                                   for r in job.values()))
