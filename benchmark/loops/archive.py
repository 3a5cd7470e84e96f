"""Closed loop of archive jobs, one after another: a job archives the
whole pool through the program's ``archive_entry``
(``archive.encode_archive``, batched on the device, the checkpoint journal
under ``TMPDIR``).  Set-up warms one batch of the first shape; the window
closes at the end of the first job to finish after ``--seconds``, so no
job is cut.

``correct``: every job's BICA frame is sound and holds the first job's
streams; every stream's BIC1 header names its page; the pages drawn from
the seed are the reference's streams, byte for byte; after every batch the
journal holds exactly the pages finished so far, and it is removed once
the archive is written.
"""

from __future__ import annotations

import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from core import checks
from reference import archive as ref_archive


def job_batches(pool, batch: int) -> list[list[int]]:
    """The pool's indices in the batches the archive codes: pages of one
    shape together, shapes in order of first appearance."""
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(pool):
        groups.setdefault(p.shape, []).append(i)
    return [g[s:s + batch] for g in groups.values()
            for s in range(0, len(g), batch)]


def run(cell, pool, seconds, device, program, win):
    entry = program.archive_entry(cell.config, device)
    journal = os.path.join(tempfile.gettempdir(), "benchmark-archive.journal")
    if os.path.exists(journal):
        os.remove(journal)
    batches = job_batches(pool, cell.config["archive_batch_size"])

    def job(pages):
        progress = []

        def seen(n_done):
            size = os.path.getsize(journal) if os.path.exists(journal) else -1
            progress.append((n_done, size))
        blob = entry(pages, journal, seen)
        return blob, progress, os.path.exists(journal)

    job([pool[i] for i in batches[0]])                    # warm one batch
    jobs, ends = [], []
    win.begin(device)
    while True:
        jobs.append(job(pool))
        ends.append(time.perf_counter())
        if ends[-1] - win.t0 >= seconds:
            break
    win.end()
    return SimpleNamespace(
        t_window=win.t0, seconds=win.t1 - win.t0, jobs=len(jobs),
        pages=len(jobs) * len(pool), job_batches=batches,
        batches=len(jobs) * len(batches),
        pixels=len(jobs) * sum(p.size for p in pool), records=jobs,
        served=list(range(len(pool))) * len(jobs),
        steps=np.diff([win.t0] + ends))


def compare(cell, w, pool, seed, device, ck, reference) -> None:
    pick = checks.sample(w.served, cell.traffic["check_pages"], seed)
    layout = sum(checks.archive_layout_errors(b, len(pool))
                 for b, _, _ in w.records)
    ck.add("archive_frame_faults", layout)
    pages0 = (ref_archive.split(w.records[0][0]) if layout == 0
              else [b""] * len(pool))
    differ = sum(sum(a != b for a, b in zip(ref_archive.split(blob), pages0))
                 for blob, _, _ in w.records[1:]) if layout == 0 else 0
    ck.add("pages_unlike_first_job", differ)
    heads = sum(checks.header_faults(b, pool[i])
                for i, b in enumerate(pages0))
    ck.add("header_faults", heads * w.jobs)
    in_order = [pages0[i] for b in w.job_batches for i in b]
    ck.add("journal_bytes_off", sum(
        checks.journal_errors(prog, in_order, len(w.job_batches))
        for _, prog, _ in w.records))
    ck.add("journals_left", sum(left for _, _, left in w.records))
    wrong = sum(reference.stream(pool[i], cell.config, device) != pages0[i]
                for i in pick)
    ck.add("sampled_pages_wrong", wrong * w.jobs)
    w.failed = (wrong + heads) * w.jobs + differ
    w.first = dict(enumerate(pages0))
    ck.add("no_page_checked", int(not pick))
