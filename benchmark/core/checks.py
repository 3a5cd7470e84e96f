"""What decides ``correct``: every number compared, beside its limit.

Each check is a count that a sound run leaves at 0 (an exact comparison
has the limit 0).  The configuration's reference (``reference/<name>.py``,
its ``stream(page, config, device)``) codes the sampled pages itself from
the same pages the program was given; it takes nothing that the program
made.  Each loop (``loops/<name>.py``) adds the checks of what it drives.
"""

from __future__ import annotations

import numpy as np

from reference import archive as ref_archive
from reference import codec8 as ref8


class Checks:
    def __init__(self):
        self.items: dict[str, tuple[float, float]] = {}

    def add(self, name: str, value, limit=0) -> None:
        self.items[name] = (value, limit)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.items.values())

    def as_dict(self) -> dict:
        return {k: {"value": v, "limit": lim}
                for k, (v, lim) in self.items.items()}

    def lines(self) -> list[str]:
        return [f"check {k}: {v} (limit {lim})"
                for k, (v, lim) in self.items.items()]


def sample(served: list[int], k: int, seed: int) -> list[int]:
    """k of the served pool indices, drawn from the seed."""
    pool = sorted(set(served))
    rng = np.random.default_rng([seed, 1])
    return sorted(rng.choice(pool, size=min(k, len(pool)),
                             replace=False).tolist())


def archive_layout_errors(blob: bytes, n_pages: int) -> int:
    """Faults in a BICA container's frame: magic, page count, offsets that
    are not the running sums of non-empty page streams that each start
    with a BIC1 header."""
    try:
        pages = ref_archive.split(blob)
    except ValueError:
        return 1
    errors = int(len(pages) != n_pages)
    errors += sum(1 for p in pages if p[:4] != ref8.MAGIC)
    return errors


def journal_errors(progress: list[tuple[int, int]], streams: list[bytes],
                   n_batches: int) -> int:
    """Bytes by which the journal's size after each batch differs from
    what a journal holding every finished page must hold (a missed or
    short append shows), summed, plus 1 where there were not `n_batches`
    batches; the record lists (pages done, journal size) as seen after
    each batch, and `streams` are the pages' streams in the order coded."""
    off = 0
    for n_done, size in progress:
        want = ref_archive.journal_size(streams[:n_done])
        off += abs(size - want)
    if len(progress) != n_batches:
        off += 1
    return off


def header_faults(stream: bytes, page: np.ndarray) -> int:
    """1 where a stream's BIC1 header does not name this page: its CRC and
    its rows and columns (a stream coded from another page, or from an
    altered one, shows)."""
    if len(stream) < 28 or stream[:4] != ref8.MAGIC:
        return 1
    crc = int.from_bytes(stream[4:8], "little")
    rows = int.from_bytes(stream[12:16], "little")
    cols = int.from_bytes(stream[16:20], "little")
    return int((crc, rows, cols) != (ref8.image_crc(page), *page.shape))
