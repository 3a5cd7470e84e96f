"""Codec 11 (the learned-dictionary patch codec) in the port against the JAX
package, byte for byte from JAX's initial state; the decoder both ways; the
header bounds; the CLI's codec 11 and ``bsvd`` on the CPU; and the port's
independence from JAX."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu import native as jnative
from binary_image_compression_tpu import cli as jcli
from binary_image_compression_tpu.models import bsvd as jbsvd
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu_torch import cli, native
from binary_image_compression_tpu_torch.models import bsvd, codec
from binary_image_compression_tpu_torch.ops import _cuda
from binary_image_compression_tpu_torch.utils import pnm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
SEED = 34503498  # codec 11's default seed in both packages


@functools.lru_cache(maxsize=None)
def _jax_stream(name, W):
    """JAX's codec-11 stream of a fixture (learning compiles; computed once
    for the tests that share it)."""
    img = pnm.read_pbm(os.path.join(FIX, name))
    return jcodec.encode(img, jcodec.CodecParams(codec=11, W=W, T=0, R=0))


@pytest.mark.parametrize("name,W,size", [("doc512.pbm", 16, 24209),
                                         ("text64.pbm", 8, None),
                                         ("ragged75x101.pbm", 8, None)])
def test_codec11_from_jax_state_is_byte_identical(name, W, size):
    """JAX's initial (D0, A0) -> the port's learn_from + _write_bsvd gives
    JAX's codec.encode stream; each package decodes the other's."""
    img = pnm.read_pbm(os.path.join(FIX, name))
    want = _jax_stream(name, W)
    if size is not None:
        assert len(want) == size
    X = np.asarray(jbsvd.patchify_to_rows(img, W))
    D0, A0 = jbsvd.INITIALIZERS["random_centroids"](
        jax.random.PRNGKey(SEED), jnp.asarray(X), 64)
    Xt = bsvd.patchify_to_rows(torch.from_numpy(img), W)
    np.testing.assert_array_equal(Xt.numpy(), X)
    D, A = bsvd.state_from_jax(np.asarray(D0), np.asarray(A0), device="cpu")
    E, D, A, _ = bsvd.learn_from(Xt, D, A)
    E, D, A = bsvd.state_to_numpy(E, D, A)
    p = codec.CodecParams(codec=11, W=W, T=0, R=0)
    got = codec._write_bsvd(img, p, E, D, A, 64)
    assert got == want
    np.testing.assert_array_equal(codec.decode(want), img)
    np.testing.assert_array_equal(jcodec.decode(got), img)


@pytest.mark.parametrize("name,W,size", [("doc512.pbm", 16, 24209),
                                         ("text64.pbm", 8, None)])
def test_codec11_encode_is_jax_stream(name, W, size):
    """codec.encode alone gives JAX's stream: the initializer replays JAX's
    threefry draw from the default seed."""
    img = pnm.read_pbm(os.path.join(FIX, name))
    want = _jax_stream(name, W)
    got = codec.encode(img, codec.CodecParams(codec=11, W=W, T=0, R=0),
                       device="cpu")
    assert got == want
    if size is not None:
        assert len(got) == size


def test_codec11_encode_on_cpu_round_trips():
    img = pnm.read_pbm(os.path.join(FIX, "ragged75x101.pbm"))
    p = codec.CodecParams(codec=11, W=8, T=0, R=0)
    blob = codec.encode(img, p, device="cpu")
    assert blob == codec.encode(img, p, device="cpu")   # seeded draw
    np.testing.assert_array_equal(codec.decode(blob), img)
    np.testing.assert_array_equal(jcodec.decode(blob), img)


def test_codec11_refusals(monkeypatch):
    img = np.zeros((16, 16), dtype=bool)
    p = codec.CodecParams(codec=11, W=8)
    with pytest.raises(ValueError, match="unknown codec id"):
        codec.encode(img, codec.CodecParams(codec=9), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        codec.encode(img, codec.CodecParams(codec=11, W=65), device="cpu")
    # no fallback: CUDA asked for and absent raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.encode(img, p, device="cuda")


def test_resolve_device_refuses_missing_cuda(monkeypatch, tmp_path):
    """The entry points share one device check: no CUDA, no fallback."""
    assert _cuda.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        _cuda.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _cuda.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bsvd", os.path.join(FIX, "text64.pbm"), "-w", "8", "-k",
                  "4", "-I", "1", "--out-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


class _Passed(Exception):
    """The header passed the checks and decoding began."""


def _verdict(decode, codec_id, W, rows, cols):
    blob = (codec.MAGIC + bytes(4) + bytes([codec_id, 0])
            + W.to_bytes(2, "little") + rows.to_bytes(4, "little")
            + cols.to_bytes(4, "little") + bytes(8))
    try:
        decode(blob)
    except _Passed:
        return "accept"
    except ValueError:
        return "reject"
    raise AssertionError("decode returned on a header-only stream")


@pytest.mark.parametrize("codec_id,W,rows,cols", [
    (8, 16, 2 ** 15, 2 ** 15),        # 2^30 pixels
    (8, 16, 2 ** 15 + 1, 2 ** 15),    # just over 2^30: the port refused it
    (8, 16, 2 ** 16, 2 ** 15),        # 2^31 pixels, the bound
    (8, 16, 2 ** 16 + 1, 2 ** 15),    # over 2^31
    (8, 0, 2 ** 15 + 1, 2 ** 15),     # W = 0 past the native bound
    (11, 16, 2 ** 15 + 1, 2 ** 15),
    (11, 0, 64, 64), (11, 65, 64, 64), (11, 64, 64, 64),
    (8, 16, 0, 64)])
def test_header_bounds_match_jax(monkeypatch, codec_id, W, rows, cols):
    """The port's decode accepts and rejects the same headers as JAX's,
    pages between 2^30 and 2^31 pixels included; the decoders are stubbed,
    so no page is allocated."""
    def passed(*a, **k):
        raise _Passed

    monkeypatch.setattr(jnative, "decode_windowed", passed)
    monkeypatch.setattr(jcodec, "_decode_bsvd", passed)
    monkeypatch.setattr(native, "decode_windowed", passed)
    monkeypatch.setattr(codec, "_decode_windowed", passed)  # past 2^30
    monkeypatch.setattr(codec, "_decode_bsvd", passed)
    want = _verdict(jcodec.decode, codec_id, W, rows, cols)
    assert _verdict(codec.decode, codec_id, W, rows, cols) == want


def test_cli_codec11_round_trip(tmp_path, capsys):
    src = os.path.join(FIX, "text64.pbm")
    bic, out = str(tmp_path / "a.bic"), str(tmp_path / "b.pbm")
    cli.main(["compress", src, bic, "--codec", "11", "-W", "8", "--device",
              "cpu"])
    assert "B raw ->" in capsys.readouterr().out
    cli.main(["decompress", bic, out])
    with open(src, "rb") as f1, open(out, "rb") as f2:
        assert f1.read() == f2.read()
    arc = str(tmp_path / "c.bica")
    cli.main(["archive", src, arc, "--codec", "11", "-W", "8", "--device",
              "cpu"])
    with open(bic, "rb") as f1, open(arc, "rb") as f2:
        assert f2.read()[16:] == f1.read()   # "BICA", n = 1, offset 0


def test_cli_bsvd_matches_jax_cli(tmp_path):
    """Partition init has no draw, so both CLIs write the same PBMs."""
    src = os.path.join(FIX, "text64.pbm")
    flags = ["-w", "8", "-k", "8", "-I", "1", "-i", "1"]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    cli.main(["bsvd", src, *flags, "--device", "cpu", "--out-dir",
              str(tmp_path / "port")])
    jcli.main(["bsvd", src, *flags, "--backend", "tpu", "--out-dir",
               str(tmp_path / "jax")])
    for f in ("dictionary", "coefficients", "residual", "atoms_mosaic",
              "residual_mosaic"):
        with open(tmp_path / "port" / f"{f}.pbm", "rb") as a, \
                open(tmp_path / "jax" / f"{f}.pbm", "rb") as b:
            assert a.read() == b.read(), f
    X = bsvd.patchify_to_rows(torch.from_numpy(pnm.read_pbm(src)), 8)
    D = torch.from_numpy(pnm.read_pbm(str(tmp_path / "port" /
                                          "dictionary.pbm")))
    A = torch.from_numpy(pnm.read_pbm(str(tmp_path / "port" /
                                          "coefficients.pbm")))
    E = pnm.read_pbm(str(tmp_path / "port" / "residual.pbm"))
    np.testing.assert_array_equal(
        bsvd.residual(X, D.to(torch.int8), A.to(torch.int8)).numpy(), E)


def test_bsvd_and_codec_import_no_jax():
    code = ("import sys\n"
            "from binary_image_compression_tpu_torch.models import bsvd, "
            "codec\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'binary_image_compression_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
