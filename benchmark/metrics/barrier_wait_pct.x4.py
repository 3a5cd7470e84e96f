"""Share of the ranks' time spent waiting for each other, %: where the
sharded archive's ranks meet, the counts' all-gather (``archive.offsets``,
which waits for the slowest rank's encode) and the job barriers
(``job.barrier``: after the writes, after rank 0's fsync), summed over
every rank's jobs in the window, over the ranks times the window."""

from core import rank_spans


def read(ctx):
    js = rank_spans.jobs(ctx)
    if not js:
        return None
    waited = sum(r.get("job.barrier", 0.0) + r.get("archive.offsets", 0.0)
                 for j in js for r in j.values())
    return 100.0 * waited / (ctx.cell.config["ranks"] * ctx.window.seconds)
