"""The traffic's pool of pages, made from the seed by one general generator.

A traffic file's ``pages`` lists kinds of page, each ``{"rows", "cols",
"content", "count"}``; the pool holds every kind's pages in the listed
order, so that every seed gives the same sizes and the same ink.  Content:

  * ``text``: the benchmark's own copy of a dense text page
    (``data/doc512.pbm``, 512 x 512, 18 % ink) tiled to the page, then
    cyclically rolled by row and column offsets drawn from the seed (only
    where the text falls moves);
  * ``blank``: an empty page, such as the back of a one-sided sheet in a
    duplex scan."""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def read_pbm(path: str) -> np.ndarray:
    """A P4 PBM as bool [rows, cols] (no comments in the header)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P4":
        raise ValueError(f"{path}: not a P4 PBM")
    off, fields = 2, []
    while len(fields) < 2:
        while data[off:off + 1].isspace():
            off += 1
        end = off
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[off:end]))
        off = end
    cols, rows = fields
    off += 1                                  # the one whitespace byte
    bpr = (cols + 7) // 8
    raster = np.frombuffer(data, np.uint8, bpr * rows, off).reshape(rows, bpr)
    return np.unpackbits(raster, axis=1)[:, :cols].astype(bool)


@lru_cache(maxsize=None)
def text_page() -> np.ndarray:
    return read_pbm(os.path.join(DATA, "doc512.pbm"))


def _text(rows: int, cols: int, n: int, rng) -> np.ndarray:
    doc = text_page()
    base = np.tile(doc, (-(-rows // doc.shape[0]),
                         -(-cols // doc.shape[1])))[:rows, :cols]
    offs = rng.integers(0, (rows, cols), size=(n, 2))
    return np.stack([np.roll(base, tuple(o), axis=(0, 1)) for o in offs])


def _blank(rows: int, cols: int, n: int, rng) -> np.ndarray:
    return np.zeros((n, rows, cols), dtype=bool)


CONTENT = {"text": _text, "blank": _blank}


def make_pages(rows: int, cols: int, n: int, seed: int) -> np.ndarray:
    """bool [n, rows, cols]: the text page tiled to rows x cols, each page
    rolled by its own (dy, dx) from the seed."""
    return _text(rows, cols, n, np.random.default_rng(seed))


def make_pool(kinds: list[dict], seed: int) -> list[np.ndarray]:
    """The pool of a traffic's ``pages``: each kind's ``count`` pages in
    turn, bool [rows, cols] each, drawn from one stream of the seed."""
    rng = np.random.default_rng(seed)
    pool: list[np.ndarray] = []
    for k in kinds:
        pool += list(CONTENT[k["content"]](k["rows"], k["cols"], k["count"],
                                           rng))
    return pool
