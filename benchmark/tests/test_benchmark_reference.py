"""The plain reference gives the program's streams, byte for byte, at
sizes a CPU test holds: codec 8 (and 4, 7) against the program's native
host encoder, codec 13 mode 2 against its CPU path, the BICA frame and the
journal's size against models/archive."""

import math
import os

import numpy as np
import pytest

from binary_image_compression_tpu_torch.models import archive, codec, compress
from core import pages
from reference import archive as ref_archive
from reference import codec8 as ref8
from reference import codec13 as ref13


def _pages():
    doc = pages.text_page()
    rs = np.random.RandomState(5)
    return {"doc_crop": doc[:100, :130], "rolled": pages.make_pages(
        150, 210, 1, 77)[0], "random": rs.rand(75, 101) < 0.3,
        "blank": np.zeros((40, 50), bool), "tiny": doc[:20, :9]}


@pytest.mark.parametrize("name", sorted(_pages()))
@pytest.mark.parametrize("cid,W,R", [(8, 16, 128), (8, 8, 24), (7, 16, 64),
                                     (4, 16, 32), (8, 12, 20)])
def test_codec8_reference_equals_host_encoder(name, cid, W, R):
    img = _pages()[name]
    want = codec.encode(img, codec.CodecParams(codec=cid, W=W, R=R,
                                               strict=False))
    assert ref8.encode(img, codec=cid, W=W, R=R) == want


@pytest.mark.parametrize("name", sorted(_pages()))
@pytest.mark.parametrize("W,T", [(16, None), (10, None), (12, 3)])
def test_codec13_reference_equals_device_path(name, W, T):
    img = _pages()[name]
    p = codec.CodecParams(codec=13, W=W, T=T, R=128, strict=False)
    want = compress.encode_scab(img, p, entropy="device", device="cpu")
    assert ref13.encode(img, W=W, T=T, R=128) == want


def test_enum_rank_is_the_definition():
    rs = np.random.RandomState(2)
    for n in (1, 7, 64, 256):
        for _ in range(20):
            bits = (rs.rand(n) < rs.rand()).astype(np.uint8)
            rank, rem = 0, int(bits.sum())
            for q in range(n):
                if rem == 0:
                    break
                if bits[q]:
                    rem -= 1
                else:
                    rank += math.comb(n - 1 - q, rem - 1)
            assert ref8.enum_rank(bits) == rank


def test_archive_frame_and_journal(tmp_path):
    pool = pages.make_pages(48, 64, 5, 9)
    params = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    sizes = []
    journal = str(tmp_path / "j")
    blob = archive.encode_archive(
        list(pool), params, batch_size=2, device="cpu", checkpoint=journal,
        on_progress=lambda n: sizes.append((n, os.path.getsize(journal))))
    streams = ref_archive.split(blob)
    assert [ref8.encode(p) for p in pool] == streams
    assert ref_archive.build(streams) == blob
    assert sizes == [(n, ref_archive.journal_size(streams[:n]))
                     for n in (2, 4, 5)]
    assert not os.path.exists(journal)


def test_scanned_counts_the_serial_scan():
    img = pages.make_pages(40, 56, 1, 21)[0]
    W, R, T = 8, 16, ref8.auto_T(8, 16)
    G = np.zeros((40, 56), np.uint8)
    G[:] = img
    want = 0
    for i0 in range(0, 40, W):
        for j0 in range(0, 56, W):
            tile = G[i0:i0 + W, j0:j0 + W]
            cands = [(y, x) for y in range(i0, max(i0 - W, 0) - 1, -1)
                     for x in range(j0 - W, max(j0 - R, 0) - 1, -1)
                     if j0 >= W]
            cands += [(y, x) for y in range(i0 - W, max(i0 - R, 0) - 1, -1)
                      for x in range(min(j0 + R, 56 - W),
                                     max(j0 - R, 0) - 1, -1)]
            best, n = W * W + 1, 0
            for y, x in cands:
                n += 1
                d = int((tile ^ G[y:y + W, x:x + W]).sum())
                d = min(d, W * W - d)
                if d < best:
                    best = d
                    if best <= T:
                        break
            want += n
    assert ref8.scanned(img, W=W, R=R) == want


def test_text_page_is_the_fixture():
    from binary_image_compression_tpu_torch.utils import pnm
    doc = pnm.read_pbm(os.path.join(os.path.dirname(pages.DATA), "..",
                                    "tests", "fixtures", "doc512.pbm"))
    assert np.array_equal(pages.text_page(), doc)
    assert abs(doc.mean() - 0.18) < 0.001
