"""Plain reference of the configuration ``c8_causal_w16_x4``: the windowed
codec's streams (``reference/codec8``) in page order, in the BICA
container of ``reference/archive``.  However the pages are split over
ranks, the archive holds exactly these bytes.  Imports nothing of the
program."""

from __future__ import annotations

from reference.archive import build
from reference.codec8 import stream  # noqa: F401


def archive(pages, config: dict, device="cpu") -> bytes:
    """The BICA archive of `pages` under the configuration's settings."""
    return build([stream(p, config, device) for p in pages])
