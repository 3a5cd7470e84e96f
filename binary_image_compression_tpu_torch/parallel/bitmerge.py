"""Distributed bit-stream assembly: per-rank streams -> one stream.

Counterpart of ``binary_image_compression_tpu/parallel/bitmerge.py``:
``exclusive_offsets`` (:22) and ``merge_bit_streams`` (:41, a copy).
Each rank packs its symbols locally; its bit offset in the merged stream is
the exclusive prefix sum of the ranks' bit counts, from one all-gather of
the [n] counts; the host merge shifts each stream into place and ORs.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh


def exclusive_offsets(mesh: Mesh, axis: str, nbits) -> int:
    """This rank's exclusive prefix sum of the per-rank bit counts `nbits`
    along `axis`: one all-gather of the [n] counts, then the sum of those
    of the ranks before it."""
    t = torch.tensor([int(nbits)], dtype=torch.int64)
    allc = mesh.all_gather_cat(t, axis)                  # [n]
    return int(allc[:mesh.axis_index(axis)].sum())


def merge_bit_streams(words_list, nbits_list) -> tuple[np.ndarray, int]:
    """Host-side final merge of per-shard uint32 bit streams.

    Streams are bit-packed MSB-first; stream s starts at offset
    sum(nbits[:s]).  Shifts each stream into place and ORs."""
    total = int(sum(int(b) for b in nbits_list))
    out_words = np.zeros((total + 31) // 32 + 1, dtype=np.uint64)
    pos = 0
    for words, nbits in zip(words_list, nbits_list):
        nbits = int(nbits)
        if nbits == 0:
            continue
        words = np.asarray(words, dtype=np.uint32)
        nw = (nbits + 31) // 32
        w64 = words[:nw].astype(np.uint64)
        word_off, bit_off = divmod(pos, 32)
        if bit_off == 0:
            out_words[word_off:word_off + nw] |= w64
        else:
            out_words[word_off:word_off + nw] |= w64 >> np.uint64(bit_off)
            out_words[word_off + 1:word_off + 1 + nw] |= \
                (w64 << np.uint64(32 - bit_off)) & np.uint64(0xFFFFFFFF)
        pos += nbits
    return out_words[: (total + 31) // 32].astype(np.uint32), total
