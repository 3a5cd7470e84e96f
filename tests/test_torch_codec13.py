"""Codec 13 in the port against the JAX package, on the CPU, exactly: the
context map, the context counts and the static table, ``pack_varlen``,
the interleaved-rANS loop against JAX's scan, the bytes of both payload
modes (host range coder, device static-table rANS) on the fixtures and edge
geometries, at every template, stripe count and lane count the JAX tests
use, each package decoding the other's streams, the stripe count the port
re-derives where JAX's device mode leaves an empty stripe, and corrupt
streams."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import bitstream as jbitstream
from binary_image_compression_tpu.ops import ransdevice as jrans
from binary_image_compression_tpu_torch.models import codec, compress
from binary_image_compression_tpu_torch.ops import bitstream, ransdevice
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = ("text64.pbm", "text256.pbm", "ragged75x101.pbm", "sparse128.pbm",
            "noise96x80.pbm", "doc512.pbm")
HL = codec.HEADER_LEN


def load(name):
    return pnm.read_pbm(os.path.join(FIX, name))


def params(W=0, T=0):
    return (codec.CodecParams(codec=13, W=W, T=T, R=0),
            jcodec.CodecParams(codec=13, W=W, T=T, R=0))


def jax_ctx(img, tmpl, stripe_rows):
    return np.array(jcompress.scab_ctx_map(
        jnp.asarray(img, jnp.uint8), tmpl=tmpl, stripe_rows=stripe_rows))


@pytest.mark.parametrize("tmpl", [10, 12])
@pytest.mark.parametrize("name", FIXTURES)
def test_ctx_map_matches_jax(name, tmpl):
    """The port's map == JAX's on every fixture, at full-height stripes and
    stripes of 64 and 32 rows (stripe tops read 0)."""
    img = load(name)
    for sr in (img.shape[0], 64, 32):
        got = compress.scab_ctx_map(torch.from_numpy(img), tmpl=tmpl,
                                    stripe_rows=sr)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), jax_ctx(img, tmpl, sr))


@pytest.mark.parametrize("name", FIXTURES)
def test_counts_and_table_match_jax(name):
    """count_contexts and build_table (q, transmit, q_default, p_used) ==
    JAX's on each fixture's template-12 map, whole page and 64-row
    stripes."""
    img = load(name)
    for sr in (img.shape[0], 64):
        ctx = jax_ctx(img, 12, sr)
        jones, jtotal = jrans.count_contexts(ctx, img.astype(np.uint8))
        ones, total = ransdevice.count_contexts(torch.from_numpy(ctx),
                                                torch.from_numpy(img))
        np.testing.assert_array_equal(ones.numpy(), np.asarray(jones))
        np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
        got = ransdevice.build_table(ones, total)
        want = jrans.build_table(jones, jtotal)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(g.numpy().dtype))


def test_quantize_probs_matches_jax_on_a_grid():
    """Every (ones, total) with total < 600: the float32 codes agree."""
    tot = np.repeat(np.arange(600), np.arange(1, 601))
    ones = np.concatenate([np.arange(t + 1) for t in range(600)])
    got = ransdevice.quantize_probs(torch.from_numpy(ones),
                                    torch.from_numpy(tot))
    want = jrans.quantize_probs(ones, tot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_varlen_matches_jax(seed):
    """Random codes of 0-32 bits packed MSB-first == JAX's words and bit
    count; words_to_bytes == JAX's."""
    rs = np.random.RandomState(seed)
    n = 500
    lengths = rs.randint(0, 33, n).astype(np.uint32)
    values = rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    nw = int(lengths.sum()) // 32 + 2
    jw, jb = jbitstream.pack_varlen(values, lengths, nw)
    w, b = bitstream.pack_varlen(torch.from_numpy(values.astype(np.int64)),
                                 torch.from_numpy(lengths.astype(np.int64)),
                                 nw)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert int(b) == int(jb)
    assert bitstream.words_to_bytes(w.numpy(), int(b)) == \
        jbitstream.words_to_bytes(np.asarray(jw), int(jb))


def _random_fb(rs, steps, S, N, pad_from):
    f = rs.randint(1, 4096, (steps, S, N))
    b = (rs.rand(steps, S, N) * (4097 - f)).astype(np.int64)
    order = (np.arange(steps)[:, None, None] * N
             + np.arange(N)[None, None, :])
    pads = np.broadcast_to(order >= pad_from, f.shape)
    return np.where(pads, 4096, f), np.where(pads, 0, b)


@pytest.mark.parametrize("N", [4, 8, 32, 64])
def test_rans_encode_plain_matches_jax_scan(N):
    """The reverse loop == JAX's rans_encode_scan (unrolled by 8) on random
    (f, b) with no-op pads at the stripes' ends."""
    rs = np.random.RandomState(N)
    steps, S = 24, 3
    f, b = _random_fb(rs, steps, S, N, steps * N - 5 * N // 2)
    js, jw, jf = jrans.rans_encode_scan(f.astype(np.uint32),
                                        b.astype(np.uint32))
    s, w, fl = ransdevice.rans_encode_plain(torch.from_numpy(f),
                                            torch.from_numpy(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jf))
    assert int(fl.sum()) > 0


def _both_modes(img, W=0, T=0):
    """(port mode 1, port mode 2, JAX mode 1, JAX mode 2) streams."""
    p, jp = params(W, T)
    return (compress.encode_scab(img, p, device="cpu"),
            compress.encode_scab(img, p, entropy="device", device="cpu"),
            jcodec.encode(img, jp),
            jcompress.encode_scab(img, jp, entropy="device"))


def _check_streams(img, W=0, T=0):
    m1, m2, j1, j2 = _both_modes(img, W, T)
    assert m1 == j1 and m2 == j2
    assert m1 == codec.encode(img, params(W, T)[0])
    assert m1[HL + 1] == 1 and m2[HL + 1] == 2
    for blob in (m1, m2):
        np.testing.assert_array_equal(codec.decode(blob), img)
        np.testing.assert_array_equal(jcodec.decode(blob), img)
    return m1, m2


@pytest.mark.parametrize("W,T", [(10, 0), (12, 2), (12, 4), (0, 0)])
@pytest.mark.parametrize("name", ["text256.pbm", "ragged75x101.pbm",
                                  "text64.pbm"])
def test_streams_match_jax(name, W, T):
    """Both modes byte for byte == JAX's, at both templates and T of 0, 2
    and 4; each package decodes the other's."""
    _check_streams(load(name), W, T)


def _edge_cases():
    rng = np.random.RandomState(7)
    return [np.zeros((33, 65), bool), np.ones((16, 16), bool),
            rng.rand(1, 7) < 0.5, rng.rand(129, 67) < 0.93,
            np.eye(50, dtype=bool)]


@pytest.mark.parametrize("case", range(5))
def test_edge_geometries_match_jax(case):
    """JAX's edge geometries (constant pages, one row, fewer pixels than
    lanes, ragged stripe tails) at T = 2."""
    _check_streams(_edge_cases()[case], 0, 2)


def test_doc512_sizes():
    """doc512: 15,097 B in mode 1 and 14,402 B in mode 2, == JAX's."""
    m1, m2 = _check_streams(load("doc512.pbm"))
    assert (len(m1), len(m2)) == (15097, 14402)


@pytest.mark.parametrize("n_lanes", [1, 4, 8, 33, 64, 255])
def test_lane_counts_match_jax(n_lanes):
    """Mode 2 written with a lane count other than 32 == JAX's stream;
    both packages decode it."""
    img = load("text64.pbm")
    p, jp = params(0, 2)
    tmpl, ns = jcodec.scab_defaults(jp, img.shape[0])
    sr = -(-img.shape[0] // ns)
    got = compress._encode_scab_device(img, p, tmpl, sr, n_lanes=n_lanes,
                                       device="cpu")
    assert got == jcompress._encode_scab_device(img, jp, tmpl, ns, sr,
                                                n_lanes=n_lanes)
    assert got[HL + 8] == n_lanes
    np.testing.assert_array_equal(codec.decode(got), img)
    np.testing.assert_array_equal(jcodec.decode(got), img)


def test_stripe_count_rederived():
    """rows = 6, T = 4: JAX's device mode writes 4 stripes of 2 rows, the
    last one empty, and both decoders reject it; the port writes 3, which
    both decode.  Mode 1 (the native coder re-derives too) is JAX's."""
    img = np.random.RandomState(5).rand(6, 40) < 0.4
    p, jp = params(0, 4)
    jblob = jcompress.encode_scab(img, jp, entropy="device")
    with pytest.raises(ValueError):
        jcodec.decode(jblob)
    with pytest.raises(ValueError):
        codec.decode(jblob)
    blob = compress.encode_scab(img, p, entropy="device", device="cpu")
    assert int.from_bytes(blob[HL + 2:HL + 4], "little") == 3
    np.testing.assert_array_equal(codec.decode(blob), img)
    np.testing.assert_array_equal(jcodec.decode(blob), img)
    assert compress.encode_scab(img, p, device="cpu") == jcodec.encode(img,
                                                                       jp)


@pytest.mark.parametrize("entropy", ["host", "device"])
def test_corrupt_and_truncated_streams_raise(entropy):
    """A flipped byte gives ValueError (the decoder's rc or the CRC) or,
    where it lands in dead pad bits, exactly the page; truncated streams
    and a bad template byte give ValueError."""
    img = load("text64.pbm")
    blob = compress.encode_scab(img, params(0, 2)[0], entropy=entropy,
                                device="cpu")
    rng = np.random.RandomState(3)
    for _ in range(25):
        bad = bytearray(blob)
        bad[rng.randint(HL, len(bad))] ^= 0xFF
        try:
            out = codec.decode(bytes(bad))
        except ValueError:
            continue
        np.testing.assert_array_equal(out, img)
    for cut in (HL + 3, HL + 20, len(blob) // 2):
        with pytest.raises(ValueError):
            codec.decode(blob[:cut])
    bad = bytearray(blob)
    bad[HL] = 7                     # no such template
    with pytest.raises(ValueError, match="rejected"):
        codec.decode(bytes(bad))


def test_rans_encode_wrapper_routes():
    """On CPU tensors the wrapper is the plain version; a lane count past
    the u8 field or a device with no kernel raises."""
    img = load("text64.pbm")
    bits = torch.from_numpy(img)[None]
    ctx = compress.scab_ctx_map(bits[0], tmpl=12, stripe_rows=32)[None]
    p_used = torch.full((1, 4096), 2048, dtype=torch.int16)
    got = ransdevice.rans_encode(bits, ctx, p_used, stripe_rows=32)
    want = ransdevice.rans_stripes_plain(bits, ctx, p_used, stripe_rows=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        ransdevice.rans_encode(bits, ctx, p_used, stripe_rows=32,
                               n_lanes=256)
    with pytest.raises(RuntimeError, match="no kernel"):
        ransdevice.rans_encode(bits.to("meta"), ctx.to("meta"),
                               p_used.to("meta"), stripe_rows=32)
