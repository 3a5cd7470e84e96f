"""The control: the reference put in the program's place with one of the
configuration's guarantees broken, which the comparison has to refuse.

Neither configuration states a precision, so the control breaks the
guarantee both state, that the stream is lossless: it codes the page with
every black pixel that has no black neighbour cleared (a despeckling
coder: a valid stream of a cleaned page, such as a faster or smaller
coder might be tempted to write).  ``Control`` offers the entries of a
program module (``programs/<name>.py``), so any loop drives it; the
archive entry runs it page by page through the reference archive, journal
and all.  The benchmark's own runs never run it; ``control.py`` does, and
the tests at a small size.
"""

from __future__ import annotations

import numpy as np

from core.cell import load
from reference import archive as ref_archive


def despeckle(img: np.ndarray) -> np.ndarray:
    p = np.pad(img, 1)
    rows, cols = img.shape
    neighbours = sum(p[1 + dr:1 + dr + rows, 1 + dc:1 + dc + cols]
                     for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                     if dr or dc)
    return img & (neighbours > 0)


class Control:
    """The configuration's reference, lossless broken, as a program."""

    def __init__(self, config: dict):
        self.reference = load("reference", config["reference"])

    def page_entry(self, config: dict, device, profile):
        return lambda img: self.reference.stream(despeckle(img), config,
                                                 device)

    def archive_entry(self, config: dict, device):
        stream = self.page_entry(config, device, None)
        return lambda pages, checkpoint, on_progress: \
            ref_archive.encode_archive(
                pages, stream, batch_size=config["archive_batch_size"],
                checkpoint=checkpoint, on_progress=on_progress)
