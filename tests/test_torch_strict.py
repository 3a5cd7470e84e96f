"""Strict mode in the port on the CPU: the plain K3 against the JAX package's
strict Pallas kernel (interpret mode), exact on all 8 per-tile outputs and
the residual words; ``encode_strict`` streams against the native host strict
encoder and the JAX package's ``codec.encode(strict=True)``, byte for byte;
the routing of ``strict.supported``; the CLI's and the archive's strict
mode."""

import os

import jax
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import pallas_strict
from binary_image_compression_tpu_torch import cli, native
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.ops import bitpack, strict
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _feedback_image():
    """Repeated tiles force matches whose residuals earlier tiles
    substituted (the image of tests/test_pallas_strict.py:34-43)."""
    img = np.tile(np.random.RandomState(12345).rand(16, 16) < 0.4, (6, 6))
    img[40:48, 40:48] ^= True
    return img


def _image(name):
    return (_feedback_image() if name == "feedback"
            else pnm.read_pbm(os.path.join(FIX, name)))


def _grid(img, W):
    rows, cols = img.shape
    grid = np.zeros((-(-rows // W) * W, -(-cols // W) * W), dtype=bool)
    grid[:rows, :cols] = img
    return grid


@pytest.mark.parametrize("name,W,R,T", [("text64.pbm", 8, 16, 1),
                                        ("feedback", 8, 40, 2),
                                        ("feedback", 24, 48, 1),
                                        ("text64.pbm", 32, 32, 1)])
def test_plain_k3_matches_jax_strict_kernel(name, W, R, T):
    img = _image(name)
    rows, cols = img.shape
    grid = _grid(img, W)
    gh, gw = grid.shape
    # the kernel's raw [T, 8] block carries bestd, which the public dict
    # of strict_analyze drops
    jout, jres = jax.device_get(pallas_strict._jitted(
        W, R, T, rows, cols, gh, gw, True, True, True, split=2)(
            grid.astype(np.uint32)))
    enb = torch.from_numpy(compress.enb_lut(W * W))
    out, fields = strict.strict_analyze(torch.from_numpy(grid), enb, W=W,
                                        R=R, T_thresh=T, cols=cols)
    assert out.dtype == torch.int32 and out.shape == (gh * gw // W // W, 8)
    jout = np.asarray(jout)
    for c, field in enumerate(strict.OUT_FIELDS):
        np.testing.assert_array_equal(out[:, c].numpy(), jout[:, c],
                                      err_msg=field)
    np.testing.assert_array_equal(
        bitpack.fields_to_words(fields, W).numpy().astype(np.uint32),
        np.asarray(jres))
    # some tiles match; text64 at W=32 is 4 tiles, none of which does
    assert bool((out[:, 0] < 2).any()) == (W < 32)


def _params(W, R):
    return (codec.CodecParams(codec=8, W=W, R=R, strict=True),
            jcodec.CodecParams(codec=8, W=W, R=R, strict=True))


def _host(img, p):
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    return native.encode_windowed(img, hdr, 8, True, p.W, p.resolved_T(), p.R)


@pytest.mark.parametrize("name,W,R", [("text64.pbm", 8, 16),
                                      ("text64.pbm", 8, 32),
                                      ("text64.pbm", 8, 12),
                                      ("text64.pbm", 16, 21),
                                      ("ragged75x101.pbm", 8, 24),
                                      ("feedback", 8, 40),
                                      ("text64.pbm", 24, 32),
                                      ("text64.pbm", 16, 12)])   # R < W
def test_encode_strict_matches_host_and_jax(name, W, R):
    img = _image(name)
    p, jp = _params(W, R)
    assert strict.supported(W, R)
    blob = compress.encode_strict(img, p, device="cpu")
    assert blob == _host(img, p)
    assert blob == jcodec.encode(img, jp)
    assert blob[9] & 1                                   # header: strict
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("name", ["text64.pbm", "ragged75x101.pbm"])
def test_encode_strict_matches_jax_encode_strict(name):
    img = _image(name)
    p, jp = _params(8, 16)
    assert compress.encode_strict(img, p, device="cpu") == \
        jcompress.encode_strict(img, jp)


@pytest.mark.parametrize("W,R", [(8, 16), (8, 12), (8, 1), (16, 9), (16, 8),
                                 (16, 128), (24, 17), (24, 16), (32, 25),
                                 (32, 24), (20, 100), (12, 64), (64, 64),
                                 (1, 8)])
def test_supported_routes_like_jax(W, R):
    assert strict.supported(W, R) == pallas_strict.supported(W, R)


def test_unsupported_shapes_take_the_host_encoder():
    img = _image("text64.pbm")
    p, jp = _params(20, 100)
    before = compress.host_route["pages"]
    blob = compress.encode_strict(img, p, device="cpu")
    assert compress.host_route["pages"] == before + 1
    assert blob == jcodec.encode(img, jp)
    with pytest.raises(ValueError, match="host encoder"):
        strict.strict_analyze(torch.zeros((40, 40), dtype=torch.bool),
                              torch.from_numpy(compress.enb_lut(400)), W=20,
                              R=100, T_thresh=1, cols=40)


def test_strict_params_go_through_encode_strict():
    img = np.zeros((32, 32), dtype=bool)
    with pytest.raises(ValueError, match="encode_strict"):
        compress.encode(img, codec.CodecParams(codec=8, strict=True),
                        device="cpu")
    with pytest.raises(ValueError, match="strict=True"):
        compress.encode_strict(img, codec.CodecParams(codec=8, strict=False),
                               device="cpu")


def test_cli_strict_round_trip(tmp_path):
    src = os.path.join(FIX, "ragged75x101.pbm")
    bic, out = str(tmp_path / "a.bic"), str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, "-W", "8", "-R", "16", "--mode",
              "strict", "--device", "cpu"])
    img = pnm.read_pbm(src)
    with open(bic, "rb") as f:
        assert f.read() == jcodec.encode(img, _params(8, 16)[1])
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()


def test_strict_archive_pages_take_the_host_encoder(tmp_path):
    pages = [np.random.RandomState(i).rand(24, 40) < 0.3 for i in range(3)]
    srcs = []
    for i, page in enumerate(pages):
        srcs.append(str(tmp_path / f"p{i}.pbm"))
        pnm.write_pbm(page, srcs[-1])
    arc = str(tmp_path / "c.bica")
    cli.main(["archive", *srcs, arc, "-W", "8", "-R", "16", "--mode",
              "strict", "--device", "cpu", "--batch-size", "2"])
    with open(arc, "rb") as f:
        blob = f.read()
    p, jp = _params(8, 16)
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(archive.decode_page(blob, i), page)
    assert archive.encode_pages(pages, p, batch_size=2, device="cpu") == \
        [jcodec.encode(page, jp) for page in pages]
