"""BICA multi-page archive with a crash-safe checkpoint journal.

Counterpart of ``binary_image_compression_tpu/models/archive.py``:
``encode_pages`` (causal codec 8 batched on the device, every other codec
and mode through ``codec.encode``, as in JAX), ``encode_archive``
with its journal
(``_corpus_fingerprint``, ``_journal_read``, ``_journal_append``),
``page_count``, ``decode_page`` and ``decode_archive``.  The journaled
encode (``encode_journaled``) and the container's header
(``container_header``) are shared with the page-sharded archive of
``parallel/multihost.encode_archive_sharded``, which writes each rank's
streams into one file at their offsets.

Layout:  "BICA" | u32 n_pages | u64 offsets[n_pages] (byte offset of each
page blob from payload start) | page blobs (each a standalone BIC1 stream).
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.profiling import span
from . import codec as codec_mod
from . import compress as compress_mod
from .codec import CodecParams

MAGIC = b"BICA"
JOURNAL_MAGIC = b"BICJ"


def encode_pages(pages, params: CodecParams | None = None, *,
                 batch_size: int = 8, device="cuda",
                 done: dict[int, bytes] | None = None,
                 after_batch=None) -> list[bytes]:
    """Encode a page list in batches of `batch_size`.  Causal codec-8 pages
    of one shape go through the device together (one search and one K2
    launch per batch, ``compress.encode_batch``); every other codec and
    mode, causal codecs 4/6/7 and strict pages included, goes to
    ``codec.encode`` page by page (the native host encoder for the windowed
    codecs; codec 11 learns on `device`), as JAX sends them (JAX
    archive.py:57-76).

    done: already-encoded {index: blob} to skip (resume).
    after_batch(new: dict[int, bytes]): called after every finished batch."""
    params = params or CodecParams(codec=8, strict=False)
    if params.codec not in codec_mod.VALID_CODECS:
        raise ValueError(f"unknown codec id {params.codec}; "
                         f"valid: {codec_mod.VALID_CODECS}")
    batched = params.codec == 8 and not params.strict
    pages = [np.asarray(p, dtype=bool) for p in pages]
    blobs: list[bytes] = [b""] * len(pages)
    for i, b in (done or {}).items():
        if 0 <= i < len(pages):
            blobs[i] = b
    groups: dict[tuple, list[int]] = {}
    for i in range(len(pages)):
        if not blobs[i]:
            key = pages[i].shape if batched else ()
            groups.setdefault(key, []).append(i)

    def encode(chunk):
        if batched:
            with span("stack"):
                batch = np.stack([pages[i] for i in chunk])
            return compress_mod.encode_batch(batch, params, device=device)
        return [codec_mod.encode(pages[i], params, device=device)
                for i in chunk]

    for idxs in groups.values():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s: s + batch_size]
            new = dict(zip(chunk, encode(chunk)))
            for i, b in new.items():
                blobs[i] = b
            if after_batch is not None:
                after_batch(new)
    return blobs


def _corpus_fingerprint(pages, params: CodecParams,
                        scope: tuple = ()) -> bytes:
    """Identity of (corpus, codec settings) for checkpoint validity (span
    ``fingerprint``); `scope` adds what else the journal depends on (a
    sharded archive's world size and page range)."""
    with span("fingerprint"):
        h = hashlib.sha256()
        h.update(repr((params.codec, params.W, params.T, params.R,
                       params.strict, len(pages)) + tuple(scope)).encode())
        for p in pages:
            h.update(struct.pack("<IIi", p.shape[0], p.shape[1],
                                 zlib.crc32(np.packbits(p).tobytes())
                                 & 0x7FFFFFFF))
        return h.digest()


def _journal_read(path: str, fp: bytes) -> dict[int, bytes]:
    """Blobs recovered from an append-only journal; a truncated tail record
    (crash mid-append) is discarded.  Empty on fingerprint or format
    mismatch (a different corpus or params must not resume from it)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return {}
    if len(data) < 8 or data[:4] != JOURNAL_MAGIC:
        return {}
    (fplen,) = struct.unpack("<I", data[4:8])
    if len(data) < 8 + fplen or data[8:8 + fplen] != fp:
        return {}
    out: dict[int, bytes] = {}
    pos = 8 + fplen
    while pos + 8 <= len(data):
        idx, nb = struct.unpack("<II", data[pos:pos + 8])
        if pos + 8 + nb > len(data):
            break  # truncated tail record: the batch that died mid-write
        out[idx] = data[pos + 8: pos + 8 + nb]
        pos += 8 + nb
    return out


def _journal_append(path: str, fp: bytes, new: dict[int, bytes]) -> None:
    """Append a finished batch to the journal and fsync it (span
    ``journal``)."""
    with span("journal"):
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(JOURNAL_MAGIC + struct.pack("<I", len(fp)) + fp)
        with open(path, "ab") as f:
            for idx, blob in sorted(new.items()):
                f.write(struct.pack("<II", idx, len(blob)) + blob)
            f.flush()
            os.fsync(f.fileno())


def encode_journaled(pages, params: CodecParams, *, batch_size: int,
                     device, checkpoint: str | None, on_progress=None,
                     scope: tuple = ()) -> list[bytes]:
    """The pages' streams through ``encode_pages``, each finished batch
    appended to the journal `checkpoint` (if given) and fsynced; a journal
    left by a killed run with the same fingerprint is resumed from.  The
    journal stays: the caller removes it once what it wrote is durable.
    on_progress(n_done_pages) is called after every batch."""
    pages = [np.asarray(p, dtype=bool) for p in pages]
    done: dict[int, bytes] = {}
    fp = b""
    if checkpoint:
        fp = _corpus_fingerprint(pages, params, scope)
        done = _journal_read(checkpoint, fp)
    n_done = len(done)

    def after_batch(new: dict[int, bytes]) -> None:
        nonlocal n_done
        if checkpoint:
            _journal_append(checkpoint, fp, new)
        n_done += len(new)
        if on_progress is not None:
            on_progress(n_done)

    return encode_pages(pages, params, batch_size=batch_size, device=device,
                        done=done, after_batch=after_batch)


def container_header(offsets) -> bytes:
    """"BICA" | u32 n_pages | u64 offsets: the archive's bytes before its
    first page stream."""
    offsets = np.asarray(offsets, dtype=np.uint64)
    return MAGIC + struct.pack("<I", len(offsets)) + offsets.tobytes()


def encode_archive(pages, params: CodecParams | None = None, *,
                   batch_size: int = 8, device="cuda",
                   checkpoint: str | None = None,
                   on_progress=None) -> bytes:
    """pages: iterable of bool [rows, cols] arrays -> BICA bytes.

    checkpoint: journal path; each finished batch is appended, a killed run
    resumes from it, and the archive is byte-identical to an uninterrupted
    one.  The journal is removed on success.  on_progress(n_done_pages) is
    called after every batch.  The job is one request (span
    ``archive_job``); its spans are ``fingerprint``, ``journal`` (each
    batch's append), each batch's ``stack`` and ``compress.encode_batch``'s,
    and ``container`` (the offsets and the join)."""
    params = params or CodecParams(codec=8, strict=False)
    with span("archive_job"):
        blobs = encode_journaled(pages, params, batch_size=batch_size,
                                 device=device, checkpoint=checkpoint,
                                 on_progress=on_progress)
        with span("container"):
            offsets = np.zeros(len(blobs), dtype=np.uint64)
            pos = 0
            for i, b in enumerate(blobs):
                offsets[i] = pos
                pos += len(b)
            out = container_header(offsets) + b"".join(blobs)
        if checkpoint and os.path.exists(checkpoint):
            os.remove(checkpoint)
        return out


def page_count(blob: bytes) -> int:
    if blob[:4] != MAGIC:
        raise ValueError("not a BICA archive")
    return struct.unpack("<I", blob[4:8])[0]


def decode_page(blob: bytes, index: int) -> np.ndarray:
    """Random-access decode of one page."""
    n = page_count(blob)
    if not 0 <= index < n:
        raise IndexError(index)
    offs = np.frombuffer(blob, dtype=np.uint64, count=n, offset=8)
    payload = 8 + 8 * n
    start = payload + int(offs[index])
    end = payload + int(offs[index + 1]) if index + 1 < n else len(blob)
    return codec_mod.decode(blob[start:end])


def decode_archive(blob: bytes, *, workers: int | None = None
                   ) -> list[np.ndarray]:
    """Decode all pages on host threads (the native decoder releases the
    GIL for the length of its ctypes call)."""
    n = page_count(blob)
    if workers is None:
        workers = min(n, os.cpu_count() or 1)
    if n <= 1 or workers <= 1:
        return [decode_page(blob, i) for i in range(n)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda i: decode_page(blob, i), range(n)))
