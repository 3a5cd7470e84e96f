"""Writing the archive file, ms a job: per job, the slowest rank's
``archive.write`` (its streams written at their offsets; on rank 0 also
the header) plus ``archive.fsync`` (rank 0: the file and its directory);
the median over the window's jobs."""

from core import rank_spans


def read(ctx):
    return rank_spans.median_over_jobs(
        ctx, lambda job: 1e3 * max(r["archive.write"]
                                   + r.get("archive.fsync", 0.0)
                                   for r in job.values()))
