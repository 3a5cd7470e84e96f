"""The port's codec-8 causal encoder on the CPU (plain kernels) against the
JAX package's device path and host encoder, byte for byte; the archive
writer with its checkpoint journal."""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import bitpack as jbp
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _params(W, R, **kw):
    return (codec.CodecParams(codec=8, W=W, R=R, strict=False, **kw),
            jcodec.CodecParams(codec=8, W=W, R=R, strict=False, **kw))


@pytest.mark.parametrize("rows,cols,W,R", [(64, 64, 16, 32),   # fields
                                           (60, 70, 12, 24),   # dense
                                           (64, 96, 32, 32)])  # fields, W=32
def test_encode_analyze_matches_jax(rows, cols, W, R):
    """K1 + the finish (_finish_selection_fields for 32 % W == 0, else the
    dense _finish_selection) against the JAX encode_analyze."""
    img = np.random.RandomState(rows + W).rand(rows, cols) < 0.3
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.int8)
    grid[:rows, :cols] = img
    kw = dict(W=W, R=R, T_thresh=1, rows=rows, cols=cols)
    want = jax.device_get(jcompress.encode_analyze(jnp.asarray(grid), **kw))
    got = compress.encode_analyze(torch.from_numpy(grid[None] != 0), **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k][0].numpy()
        if k == "residual4":
            g = g.astype(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def test_encode_analyze_decided_block_matches_jax():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    W, R = 8, 32
    packed = jbp.np_pack(img)
    kw = dict(W=W, R=R, T_thresh=_params(W, R)[0].resolved_T(), rows=64,
              cols=64)
    want = np.asarray(jax.device_get(jcompress.encode_analyze_decided(
        jnp.asarray(packed), **kw)))
    got = compress.encode_analyze_decided(
        torch.from_numpy(packed.view(np.int32)[None]), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)
    # the pure-Python record packer agrees with native bic_pack_tiles
    hdr = codec._header(_params(W, R)[0], 64, 64, codec.image_crc(img))
    out = compress._split_decided(got[0].numpy())
    assert compress.pack_records_plain(out, hdr, W * W) == \
        compress._pack_decided(got[0].numpy(), hdr, W * W)


@pytest.mark.parametrize("image,W,R", [("text64.pbm", 8, 32),
                                       ("text256.pbm", 16, 64),
                                       ("ragged75x101.pbm", 8, 16),
                                       ("sparse128.pbm", 16, 32),
                                       ("noise96x80.pbm", 8, 16)])
def test_encode_matches_jax_device_and_host(image, W, R):
    img = pnm.read_pbm(os.path.join(FIX, image))
    p, jp = _params(W, R)
    blob = compress.encode(img, p, device="cpu")
    assert blob == jcompress.encode(img, jp)
    assert blob == jcodec.encode(img, jp)
    np.testing.assert_array_equal(codec.decode(blob), img)


def test_doc512_is_17207_bytes_and_matches_host():
    img = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    p, jp = _params(16, 128)
    blob = compress.encode(img, p, device="cpu")
    assert len(blob) == 17207
    assert blob == jcodec.encode(img, jp)
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("W,R,T", [(12, 24, None), (32, 64, None),
                                   (4, 8, 2), (1, 4, 0), (16, 48, 0)])
def test_encode_other_widths_match_host(W, R, T):
    """W*W < 32 (W <= 4) packs one residual word: the JAX field finish
    fails there (ROADMAP.md Queue 3); the host encoder is the oracle."""
    img = pnm.read_pbm(os.path.join(FIX, "text256.pbm"))[:128, :160]
    p, jp = _params(W, R, T=T)
    assert compress.encode(img, p, device="cpu") == jcodec.encode(img, jp)


def test_encode_batch_matches_single_page():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    pages = np.stack([img, np.roll(img, 3, axis=1), ~img])
    p, _ = _params(8, 32)
    blobs = compress.encode_batch(pages, p, device="cpu")
    for i in range(3):
        assert blobs[i] == compress.encode(pages[i], p, device="cpu")


def test_r_less_than_w_routes_to_host_encoder():
    img = np.random.RandomState(5).rand(48, 64) < 0.3
    p, jp = _params(16, 8)
    before = compress.host_route["pages"]
    blob = compress.encode(img, p, device="cpu")
    assert compress.host_route["pages"] == before + 1
    assert blob == jcodec.encode(img, jp) == jcompress.encode(img, jp)
    assert compress.encode_batch(img[None], p, device="cpu") == [blob]
    np.testing.assert_array_equal(codec.decode(blob), img)
    with pytest.raises(ValueError, match="R >= W"):
        compress.encode_analyze(torch.from_numpy(img[None]), W=16, R=8,
                                T_thresh=1, rows=48, cols=64)


def test_unported_params_and_devices_raise():
    img = np.zeros((32, 32), dtype=bool)
    # codec 6 is a host codec in both packages (codecs 4/7 are ported)
    with pytest.raises(ValueError, match="codec 6 and the host codecs"):
        compress.encode(img, codec.CodecParams(codec=6, strict=False),
                        device="cpu")
    with pytest.raises(ValueError, match="encode_strict"):
        compress.encode(img, codec.CodecParams(codec=8, strict=True),
                        device="cpu")
    # W = 40 takes the banded search now
    p40 = codec.CodecParams(codec=8, W=40, R=64, strict=False)
    np.testing.assert_array_equal(
        codec.decode(compress.encode(img, p40, device="cpu")), img)
    with pytest.raises(ValueError, match="out of range"):
        compress.encode(img, codec.CodecParams(codec=8, W=65, strict=False),
                        device="cpu")
    if not torch.cuda.is_available():
        for cid in (4, 8):
            with pytest.raises(RuntimeError, match="CUDA"):
                compress.encode(img, codec.CodecParams(codec=cid, W=8, R=16,
                                                       strict=False))


def test_params_from_jax_and_header_match():
    jp = jcodec.CodecParams(codec=8, W=16, T=None, R=100, strict=False)
    p = codec.params_from_jax(jp)
    assert p.resolved_T() == jp.resolved_T()
    img = np.random.RandomState(1).rand(33, 47) < 0.5
    assert codec.image_crc(img) == jcodec.image_crc(img)
    assert codec._header(p, 33, 47, 7) == jcodec._header(jp, 33, 47, 7)


PAGES = [np.random.RandomState(3 + i).rand(32, 32) < 0.3 for i in range(6)]


def test_archive_round_trip_resumes_after_truncated_journal(tmp_path):
    p, jp = _params(8, 16)
    expected = archive.encode_archive(PAGES, p, batch_size=2, device="cpu")
    assert archive.page_count(expected) == len(PAGES)
    for i, page in enumerate(archive.decode_archive(expected)):
        np.testing.assert_array_equal(page, PAGES[i])
        assert archive.decode_page(expected, i).shape == (32, 32)
    with pytest.raises(IndexError):
        archive.decode_page(expected, len(PAGES))

    ckpt = str(tmp_path / "corpus.journal")
    fp = archive._corpus_fingerprint(PAGES, p)
    blob0 = jcodec.encode(PAGES[0], jp)
    archive._journal_append(ckpt, fp, {0: blob0})
    blob1 = jcodec.encode(PAGES[1], jp)
    with open(ckpt, "ab") as f:  # record 1 cut off mid-payload
        f.write(struct.pack("<II", 1, len(blob1)) + blob1[: len(blob1) // 2])
    assert archive._journal_read(ckpt, fp) == {0: blob0}
    # a journal of another corpus is ignored
    assert archive._journal_read(ckpt, archive._corpus_fingerprint(
        PAGES[:5], p)) == {}

    progress = []
    blob = archive.encode_archive(PAGES, p, batch_size=2, device="cpu",
                                  checkpoint=ckpt,
                                  on_progress=progress.append)
    assert blob == expected
    assert progress == [3, 5, 6]          # page 0 came from the journal
    assert not os.path.exists(ckpt)
