"""K2's order of work (csrc/decide_modes.cu) on the CPU: the numpy model
``decide.decide_rounds_model`` (windows of 32 tiles, speculative rounds that
commit up to the first tile whose update changes its context's k, serial
steps after ``decide.SHORT_ROUNDS`` rounds in a row that each commit fewer
than ``decide.GUARD`` tiles) against
the plain K2, the host replay and the JAX kernel in interpret mode; and the
kernel's per-lane Golomb-k helper, mirrored by ``decide.golomb_k_lane``,
against the definition.  Equal outputs show, without a card, that deciding
a round under the ks at its start and committing up to the first change is
bit-identical to the serial chain; the pinned round counts are what the
card's round counter must report."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import pallas_decide
from binary_image_compression_tpu_torch.models import compress
from binary_image_compression_tpu_torch.ops import decide
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
U32 = 0xFFFFFFFF


def k_definition(n, acc):
    """pallas_decide.py's k search, vectorized: the least k in 0..31 with
    (n << k) mod 2^32 >= acc, else 31."""
    n = np.asarray(n, dtype=np.uint64)[:, None]
    acc = np.asarray(acc, dtype=np.uint64)[:, None]
    ks = np.arange(32, dtype=np.uint64)[None]
    ok = ((n << ks) & np.uint64(U32)) >= acc
    return np.where(ok, ks, np.uint64(31)).min(axis=1).astype(np.int64)


def lane_k(ns, accs):
    return np.array([decide.golomb_k_lane(int(a), int(b))
                     for a, b in zip(ns, accs)], dtype=np.int64)


def _edges(n):
    """acc values around every shift of n and every power of two."""
    pts = {0, 1, 2, U32, 1 << 31}
    for j in range(32):
        for base in ((n << j) & U32, 1 << j):
            pts.update(((base - 1) & U32, base, (base + 1) & U32))
    return sorted(pts)


@pytest.mark.parametrize("lo", range(0, 4097, 512))
def test_golomb_k_lane_matches_definition_on_edges(lo):
    ns, accs = [], []
    for n in range(lo, min(lo + 512, 4097)):
        e = _edges(n)
        ns += [n] * len(e)
        accs += e
    np.testing.assert_array_equal(lane_k(ns, accs), k_definition(ns, accs))


@pytest.mark.parametrize("seed", range(4))
def test_golomb_k_lane_matches_definition_on_random_pairs(seed):
    rs = np.random.RandomState(seed)
    ns = rs.randint(0, 2 ** 32, size=2000, dtype=np.uint64)
    accs = rs.randint(0, 2 ** 32, size=2000, dtype=np.uint64)
    # small n with large acc, where the k search reaches the top bits
    ns[:500] = rs.randint(0, 64, size=500)
    np.testing.assert_array_equal(lane_k(ns, accs), k_definition(ns, accs))


def test_golomb_k_lane_wraparound_and_zero():
    cases = []
    for n in (1, 3, 5, 7, 0x7FFF, 0x12345, 0x40000001, 0x7FFFFFFF, 3 << 29):
        cn = 32 - n.bit_length()
        top = (n << cn) & U32
        # acc > n << clz(n): only a wrapped shift can reach it, if any
        cases += [(n, a) for a in (top + 1, U32, (top + U32) // 2)
                  if top < a <= U32]
    cases += [(0, a) for a in (0, 1, 2, 1 << 31, U32)]
    assert len(cases) > 20
    ns, accs = zip(*cases)
    want = k_definition(ns, accs)
    np.testing.assert_array_equal(lane_k(ns, accs), want)
    assert decide.golomb_k_lane(0, 0) == 0
    assert decide.golomb_k_lane(0, 5) == 31
    # 3 << 29 has top bit 31: 3 << 30 wraps to 2^31, 3 << 31 to 2^31 too
    assert decide.golomb_k_lane(3 << 29, U32) == 31
    assert 31 in want and (want < 31).any()


def _random_page(M, T, seed, ties=False):
    rs = np.random.RandomState(seed)
    w4 = rs.randint(0, M + 1, size=(T, 4)).astype(np.int32)
    if ties:
        w4[:8] = 0                        # ties: first minimum must win
    hc = rs.rand(T) < 0.8
    il = rs.randint(1, 12, size=T).astype(np.int32)
    return w4, hc, il


def adversarial_page(M, T):
    """Nomatch only, weights alternating M, 0: k changes on every tile."""
    w4 = np.zeros((T, 4), dtype=np.int32)
    w4[:, 2] = w4[:, 3] = np.where(np.arange(T) % 2 == 0, M, 0)
    w4[:, :2] = M
    return w4, np.zeros(T, dtype=bool), np.ones(T, dtype=np.int32)


def _check(w4, hc, il, M, codec_id, guard=decide.GUARD):
    """The model's outputs == the plain K2 == the host replay; returns the
    model's (rounds, serial tiles)."""
    enb = compress.enb_lut(M)
    *got, rounds, serial = decide.decide_rounds_model(
        w4, hc, il, enb, codec_id=codec_id, guard=guard)
    want = decide.decide_modes_plain(
        torch.from_numpy(w4[None]), torch.from_numpy(hc[None].astype(np.int32)),
        torch.from_numpy(il[None]), torch.from_numpy(enb), codec_id=codec_id)
    host = compress._decide_modes(dict(weights4=w4, has_cands=hc,
                                       idx_len=il), M, codec_id)
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(g, w[0].numpy())
        np.testing.assert_array_equal(g, h)
    T = len(w4)
    assert -(-T // decide.ROUND) <= rounds <= T and 0 <= serial < T
    return rounds, serial


@pytest.mark.parametrize("T", [1, 31, 32, 33, 300, 1024])
@pytest.mark.parametrize("M", [64, 256, 4096])
@pytest.mark.parametrize("codec_id", [4, 7, 8])
def test_round_model_matches_plain_and_host(codec_id, M, T):
    w4, hc, il = _random_page(M, T, 1000 * codec_id + T + M)
    _check(w4, hc, il, M, codec_id)


@pytest.mark.parametrize("guard", [0, 1, 8, 33])
@pytest.mark.parametrize("codec_id", [4, 8])
def test_round_model_any_guard_matches_plain(codec_id, guard):
    """Every guard gives the same decisions; 0 and 1 never go serial (a
    round commits at least one tile), 33 goes serial after every second
    round."""
    w4, hc, il = _random_page(256, 300, guard + codec_id)
    rounds, serial = _check(w4, hc, il, 256, codec_id, guard)
    if guard <= 1:
        assert serial == 0
    if guard == 33:
        assert serial > 0 and rounds <= 2 * -(-300 // decide.ROUND)



@pytest.mark.parametrize("codec_id", [4, 7, 8])
def test_round_model_ties_take_the_first_minimum(codec_id):
    w4, hc, il = _random_page(64, 300, codec_id, ties=True)
    _check(w4, hc, il, 64, codec_id)


@pytest.mark.parametrize("guard,rounds,serial",
                         [(0, 1024, 0), (decide.GUARD, 64, 960)])
def test_round_model_adversarial_input(guard, rounds, serial):
    """k flips on every tile: without the guard one round per tile; with it
    two rounds of one tile per window and the rest serial."""
    w4, hc, il = adversarial_page(256, 1024)
    assert _check(w4, hc, il, 256, 8, guard) == (rounds, serial)


@pytest.fixture(scope="module")
def doc512_weights():
    """doc512's weights4, has_cands and idx_len from the port's CPU
    analysis at W = 16 and 32 (R = 128)."""
    doc = torch.from_numpy(pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))[None])
    got = {}
    for W in (16, 32):
        out = compress.encode_analyze(doc, W=W, R=128, T_thresh=1, rows=512,
                                      cols=512)
        got[W] = (out["weights4"][0].to(torch.int32).numpy(),
                  out["has_cands"][0].numpy(),
                  out["idx_len"][0].to(torch.int32).numpy())
    return got


# (W, guard) -> (rounds, serial tiles) of the model on doc512
DOC512_ROUNDS = {(16, 0): (37, 0), (16, decide.GUARD): (37, 0),
                 (32, 0): (11, 0), (32, decide.GUARD): (11, 0)}


@pytest.mark.parametrize("W,guard", sorted(DOC512_ROUNDS))
def test_round_model_on_doc512(doc512_weights, W, guard):
    w4, hc, il = doc512_weights[W]
    assert _check(w4, hc, il, W * W, 8, guard) == DOC512_ROUNDS[(W, guard)]


def test_round_model_matches_jax_kernel(doc512_weights):
    """doc512 at W = 32 and the adversarial input through the JAX kernel in
    interpret mode."""
    pages = [(*doc512_weights[32], 1024), (*adversarial_page(64, 100), 64)]
    for w4, hc, il, M in pages:
        enb = compress.enb_lut(M)
        got = decide.decide_rounds_model(w4, hc, il, enb, codec_id=8)
        dev = jax.device_get(pallas_decide.decide_modes(
            jnp.asarray(w4), jnp.asarray(hc), jnp.asarray(il),
            jnp.asarray(enb), M=M, codec_id=8))
        for k in range(3):
            np.testing.assert_array_equal(got[k], np.asarray(dev[k]))
