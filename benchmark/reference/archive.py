"""Plain reference of the BICA archive and its checkpoint journal.

Archive: "BICA" | u32 n_pages | u64 offsets[n_pages] (each page stream's
byte offset from the end of the offsets) | the page streams.
Journal: "BICJ" | u32 fingerprint bytes | the fingerprint (32 bytes, a
SHA-256) | per finished page, in the order appended: u32 index | u32
bytes | the stream.  It is appended and flushed to the disk after every
batch, and removed once the archive is written.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"BICA"
JOURNAL_MAGIC = b"BICJ"
FINGERPRINT_BYTES = 32


def build(streams: list[bytes]) -> bytes:
    sizes = np.asarray([len(s) for s in streams], dtype=np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.uint64)
    return (MAGIC + struct.pack("<I", len(streams)) + offsets.tobytes()
            + b"".join(streams))


def split(blob: bytes) -> list[bytes]:
    """The page streams of an archive; ValueError if its frame is bad."""
    if blob[:4] != MAGIC or len(blob) < 8:
        raise ValueError("not a BICA archive")
    n = struct.unpack("<I", blob[4:8])[0]
    base = 8 + 8 * n
    if len(blob) < base:
        raise ValueError("truncated offsets")
    offs = np.frombuffer(blob, dtype=np.uint64, count=n, offset=8).tolist()
    ends = offs[1:] + [len(blob) - base]
    if any(a > b for a, b in zip(offs, ends)) or (n and offs[0] != 0):
        raise ValueError("offsets out of order")
    return [blob[base + a:base + b] for a, b in zip(offs, ends)]


def journal_size(streams: list[bytes]) -> int:
    """Bytes of a journal that holds these finished page streams."""
    return (8 + FINGERPRINT_BYTES
            + sum(8 + len(s) for s in streams))


def encode_archive(pages, encode_page, *, batch_size: int, checkpoint: str,
                   on_progress=None) -> bytes:
    """The archive of `pages`, each coded by encode_page(page) -> stream,
    with the journal appended and synced after every batch."""
    streams = []
    with open(checkpoint, "wb") as f:
        f.write(JOURNAL_MAGIC + struct.pack("<I", FINGERPRINT_BYTES)
                + bytes(FINGERPRINT_BYTES))
    for s in range(0, len(pages), batch_size):
        new = [encode_page(p) for p in pages[s:s + batch_size]]
        with open(checkpoint, "ab") as f:
            for i, b in enumerate(new, start=s):
                f.write(struct.pack("<II", i, len(b)) + b)
            f.flush()
            os.fsync(f.fileno())
        streams += new
        if on_progress is not None:
            on_progress(len(streams))
    os.remove(checkpoint)
    return build(streams)
