"""How far the slowest rank's encode trails the fastest's, %: per job, the
longest of the ranks' ``archive.shard`` spans (a rank's encode of its page
range, journal included) less the shortest, over the shortest; the median
over the window's jobs."""

from core import rank_spans


def _skew(job):
    t = [r["archive.shard"] for r in job.values()]
    return 100.0 * (max(t) - min(t)) / min(t)


def read(ctx):
    return rank_spans.median_over_jobs(ctx, _skew)
