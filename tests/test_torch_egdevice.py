"""Codec 10's device coder in the port against the JAX package, on the CPU,
exactly: the EG table, the MED residual and the bitplanes, the run
extraction at its capacity boundaries, the composition scan, the plain K8
against JAX's ``eg_encode_runs_device`` and the native coder, the run
counts and the capacity ladder that sizes the plain K8's run array, and a
numpy model of K8's order of work (``csrc/eg_encode.cu``: chunk ends, their scan, chunk maps walked
from every state, the blocks' composition, one writer per chunk) against
the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu import native as jnative
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import bitpack as jbitpack
from binary_image_compression_tpu.ops import egdevice as jeg
from binary_image_compression_tpu.ops import entropy as jentropy
from binary_image_compression_tpu.ops import predict as jpredict
from binary_image_compression_tpu.utils import bitplanes as jbitplanes
from binary_image_compression_tpu_torch import native
from binary_image_compression_tpu_torch.models import codec, compress
from binary_image_compression_tpu_torch.ops import bitpack, egdevice, entropy
from binary_image_compression_tpu_torch.ops import predict
from binary_image_compression_tpu_torch.ops.bitstream import words_to_bytes
from binary_image_compression_tpu_torch.utils import bitplanes, roofline

# (density, shape) of JAX tests/test_compress_tpu.py:163
CASES = [(0.02, (64, 96)), (0.3, (64, 96)), (0.0, (32, 32)), (1.0, (32, 32)),
         (0.5, (33, 61)), (0.9, (64, 64))]


def packed(img):
    return torch.from_numpy(bitpack.np_pack(img).view(np.int32))


def residual(img):
    return predict.med_forward(packed(img)[None], img.shape[1])


def test_eg_table_equals_jax():
    assert entropy.EGLUT == tuple(jentropy.EGLUT)
    assert entropy.EG_BLOCKS == tuple(int(b) for b in jeg._BLOCKS)
    for n in (1, 2, 64 * 96, 512 * 512, 3300 * 2550):
        assert egdevice._geometry(n) == jeg._geometry(n)


@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (33, 61), (64, 96),
                                   (2, 200)])
def test_med_forward_equals_jax(shape):
    rs = np.random.RandomState(shape[0] * shape[1])
    imgs = rs.rand(3, *shape) < 0.4
    got = predict.med_forward(packed(imgs), shape[1])
    want = jpredict.med_forward(jbitpack.pack(jnp.asarray(imgs)), shape[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    for i in range(3):
        np.testing.assert_array_equal(
            bitpack.np_unpack(got[i].numpy().view(np.uint32), shape[1]),
            codec._med(imgs[i].astype(np.uint8)).astype(bool))


@pytest.mark.parametrize("maxval", [1, 2, 255, 256, 4095, 65535])
def test_bitplanes_equal_jax(maxval):
    rs = np.random.RandomState(maxval)
    gray = rs.randint(0, maxval + 1, (9, 37)).astype(np.uint32)
    assert bitplanes.nplanes_for_maxval(maxval) == \
        jbitplanes.nplanes_for_maxval(maxval)
    planes = bitplanes.decompose(gray, maxval)
    np.testing.assert_array_equal(planes,
                                  jbitplanes.decompose(gray, maxval))
    if planes.shape[0]:
        np.testing.assert_array_equal(bitplanes.recompose(planes),
                                      jbitplanes.recompose(planes))
    pk = bitplanes.decompose_packed(torch.from_numpy(gray.astype(np.int64)),
                                    maxval)
    np.testing.assert_array_equal(
        pk.numpy().view(np.uint32),
        np.asarray(jbitplanes.decompose_packed(jnp.asarray(gray), maxval)))
    if planes.shape[0]:
        np.testing.assert_array_equal(
            bitplanes.recompose_packed(pk, 37).numpy(),
            np.asarray(jbitplanes.recompose_packed(
                jnp.asarray(pk.numpy().view(np.uint32)), 37)))


# JAX's coder compiles once per (run array, n_pixels): every case hands it
# runs padded to one length under one static bound, the largest case's
BOUND = max(r * c for _, (r, c) in CASES)


@pytest.mark.parametrize("dens,shape", CASES)
def test_plain_k8_equals_jax_and_native(dens, shape):
    """The runs by torch.nonzero and the plain coder == the native coder
    byte for byte, and == JAX's device coder word for word on the same
    run array and bound."""
    rs = np.random.RandomState(12345 + int(dens * 100))
    img = rs.rand(*shape) < dens
    res = codec._med(img.astype(np.uint8))
    runs = codec._medrle_runs(img, res)
    n = img.size
    druns, nr = egdevice.runs_from_residual_flat(
        torch.from_numpy(res.ravel()), n_pixels=n)
    assert int(nr) == len(runs)
    np.testing.assert_array_equal(druns[:len(runs)].numpy(), runs)
    words, tb = egdevice.eg_encode_runs_plain(druns, nr, n_pixels=n)
    assert int(tb) <= words.shape[0] * 32
    nat = native.eg_encode_runs(runs)
    assert nat == jnative.eg_encode_runs(runs)
    assert words_to_bytes(words.numpy(), int(tb)) == nat
    padded = torch.cat([druns, druns.new_zeros(BOUND + 1 - druns.shape[0])])
    pw, ptb = egdevice.eg_encode_runs_plain(padded, nr, n_pixels=BOUND)
    jw, jtb = jeg.eg_encode_runs_device(jnp.asarray(padded.numpy()), int(nr),
                                        n_pixels=BOUND)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert int(ptb) == int(jtb) == int(tb)
    w2, b2 = egdevice.eg_encode(residual(img), shape[1])
    assert w2.dtype == torch.int32 and b2.dtype == torch.int64
    np.testing.assert_array_equal(w2[0].numpy().view(np.uint32),
                                  words.numpy())


def test_runs_from_residual_cap_boundaries():
    """JAX tests/test_compress_tpu.py:174: capped == uncapped whenever the
    count fits, and the count reports > cap on overflow, n_ones == cap
    included; each against JAX's capped extraction."""
    rng = np.random.RandomState(12345)
    n, cap = 64, 8
    for n_ones, trailing in [(0, 0), (3, 1), (7, 0), (8, 0), (8, 1),
                             (9, 0), (20, 1)]:
        flat = np.zeros(n, np.uint8)
        pos = np.sort(rng.choice(n - (1 if trailing else 0), size=n_ones,
                                 replace=False)) if n_ones else \
            np.array([], int)
        if n_ones and not trailing:
            pos[-1] = n - 1
        flat[pos] = 1
        full, nr_full = egdevice.runs_from_residual_flat(
            torch.from_numpy(flat), n_pixels=n)
        capd, nr_cap = egdevice.runs_from_residual_flat(
            torch.from_numpy(flat), n_pixels=n, cap=cap)
        jr, jn = jeg.runs_from_residual_flat(jnp.asarray(flat), n_pixels=n,
                                             cap=cap)
        np.testing.assert_array_equal(capd.numpy(), np.asarray(jr))
        assert int(nr_cap) == int(jn)
        if int(nr_full) <= cap:
            assert int(nr_full) == int(nr_cap)
            np.testing.assert_array_equal(full[:int(nr_full)].numpy(),
                                          capd[:int(nr_cap)].numpy())
        else:
            assert int(nr_cap) > cap


@pytest.mark.parametrize("N", [1, 2, 3, 31, 257])
def test_compose_scan_equals_sequential_composition(N):
    rs = np.random.RandomState(N)
    maps = rs.randint(0, 32, (N, 32))
    got = egdevice.compose_scan(torch.from_numpy(maps)).numpy()
    acc = np.arange(32)
    for i in range(N):
        acc = maps[i][acc]
        np.testing.assert_array_equal(got[i], acc)
    a, b = maps, np.roll(maps, 1, axis=0)
    np.testing.assert_array_equal(
        egdevice._compose(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jeg._compose_bitplane(jnp.asarray(a, jnp.uint8),
                                         jnp.asarray(b, jnp.uint8))))


def _plane_with_residual_density(rng, d, n=64):
    res = jnp.asarray(rng.rand(n, n) < d)
    back = jpredict.med_inverse(jbitpack.pack(res), n)
    return np.asarray(jbitpack.unpack(back, n)).astype(bool)


def test_capacity_ladder_routes_each_plane():
    """JAX tests/test_compress_tpu.py:249: the ladder's counts and rungs
    equal JAX's and the host oracle; the plain K8 sizes a sparse plane's run
    array at level 0, a plane between 1/8 and 1/4 ones at level 1 and a
    denser one (JAX's native route) at every pixel, all in one eg_encode
    call over the stack; the bytes equal the native assembly's and JAX's,
    and decode."""
    rng = np.random.RandomState(12345)
    n = 64 * 64
    sparse = rng.rand(64, 64) < 0.01
    mid = _plane_with_residual_density(rng, 0.18)
    dense = _plane_with_residual_density(rng, 0.40)
    planes = np.stack([sparse, mid, dense, sparse])
    res = compress.med_planes(packed(planes), 64)
    counts = egdevice.run_counts(res, 64).numpy()
    np.testing.assert_array_equal(counts, np.asarray(
        jcompress._planes_run_counts(jnp.asarray(planes, jnp.uint8), 64)))
    for i in range(4):
        assert counts[i] == len(codec._medrle_runs(planes[i]))
    assert egdevice.run_cap(n, 0) == jcompress._eg_run_cap(n, 0)
    assert egdevice.run_cap(n, 1) == jcompress._eg_run_cap(n, 1)
    assert counts[0] <= egdevice.run_cap(n, 0) < counts[1] \
        <= egdevice.run_cap(n, 1) < counts[2]
    calls, caps = [], []
    orig_enc, orig_runs = egdevice.eg_encode, egdevice.runs_from_residual_flat
    egdevice.eg_encode = lambda r, cols: (
        calls.append(r.shape[0]) or orig_enc(r, cols))
    egdevice.runs_from_residual_flat = lambda f, n_pixels, cap=None: (
        caps.append(cap) or orig_runs(f, n_pixels=n_pixels, cap=cap))
    try:
        a = compress.encode_planes_device(planes, "device", device="cpu")
    finally:
        egdevice.eg_encode = orig_enc
        egdevice.runs_from_residual_flat = orig_runs
    assert calls == [4]
    assert caps == [egdevice.run_cap(n, 0), egdevice.run_cap(n, 1), None,
                    egdevice.run_cap(n, 0)]
    assert a == compress.encode_planes_device(planes, "native", device="cpu")
    assert a == [codec.encode(p, codec.CodecParams(codec=10, W=0))
                 for p in planes]
    for i, blob in enumerate(a):
        np.testing.assert_array_equal(codec.decode(blob), planes[i])
        np.testing.assert_array_equal(jcodec.decode(blob), planes[i])


def test_dense_stack_goes_native():
    """JAX tests/test_compress_tpu.py:233: residuals past the ladder, which
    JAX sends to the native coder, stay on the device route (the plain K8
    with a run array of every pixel) with the native coder's bytes."""
    planes = np.random.RandomState(5).rand(2, 32, 32) < 0.5
    res = compress.med_planes(packed(planes), 32)
    assert all(egdevice.plain_cap(32 * 32, int(c)) is None
               for c in egdevice.run_counts(res, 32))
    a = compress.encode_planes_device(planes, "device", device="cpu")
    assert a == compress.encode_planes_device(planes, "native", device="cpu")
    for i, blob in enumerate(a):
        np.testing.assert_array_equal(codec.decode(blob), planes[i])


# ---------------------------------------------------------------------------
# a numpy model of K8's order of work (csrc/eg_encode.cu)
# ---------------------------------------------------------------------------

def _eg_run(L, s, first):
    """csrc eg_run: (exit, nb, g, rem) of a run of L zeros from state s."""
    nb = 0
    if first:
        if L == 0:
            return 0, 0, 1, 0
        L, nb, s = L - 1, 1, 1
    g = entropy.EGLUT[s]
    while L >= 1 << g:
        L -= 1 << g
        nb += 1
        s = min(s + 1, 31)
        g = entropy.EGLUT[s]
    return max(s - 1, 0), nb, g, L


def _chunk_ones(words, c, nw, cols):
    for k in range(egdevice.CHUNK_WORDS):
        gi = c * egdevice.CHUNK_WORDS + k
        if gi >= words.size:
            return
        w = int(words[gi])
        base = (gi // nw) * cols + (gi % nw) * 32
        for bit in range(32):
            if w >> (31 - bit) & 1:
                yield base + bit


def _chunk_runs(words, c, nw, cols, prev, n, NC):
    """(L, first) of the runs chunk c codes: one per set bit, from the last
    one before it, and the trailing zero run in the last chunk."""
    pv = prev
    for pos in _chunk_ones(words, c, nw, cols):
        yield pos - pv - 1, pv < 0
        pv = pos
    if c == NC - 1 and n - 1 - pv > 0:
        yield n - 1 - pv, pv < 0


def k8_model(res_plane, rows, cols):
    """K8's phases on one plane of packed words uint32 [rows, nw]:
    (uint32 words [payload_words], total bits)."""
    nw = res_plane.shape[1]
    words = res_plane.reshape(-1)
    n = rows * cols
    NC, NB = egdevice.chunk_geometry(rows, nw)
    CPB = egdevice.CHUNKS_PER_BLOCK
    # 1-2: each chunk's last one, and the exclusive max-scan of those
    last = [max(_chunk_ones(words, c, nw, cols), default=-1)
            for c in range(NC)]
    prev = np.maximum.accumulate([-1] + last)[:-1]
    # 3: each chunk walked from every state; prefixes within each block
    cm, cl = np.zeros((NC, 32), int), np.zeros((NC, 32), int)
    for c in range(NC):
        runs = list(_chunk_runs(words, c, nw, cols, prev[c], n, NC))
        for s0 in range(32):
            s, bits = s0, 0
            for L, first in runs:
                s, nb, g, _ = _eg_run(L, s, first)
                bits += nb + 1 + g
            cm[c, s0], cl[c, s0] = s, bits
    pm, pl = np.zeros((NC, 32), int), np.zeros((NC, 32), int)
    bm, bl = np.zeros((NB, 32), int), np.zeros((NB, 32), int)
    for b in range(NB):
        st, ln = np.arange(32), np.zeros(32, int)
        for c in range(b * CPB, min(NC, (b + 1) * CPB)):
            pm[c], pl[c] = st, ln
            ln = ln + cl[c][st]
            st = cm[c][st]
        bm[b], bl[b] = st, ln
    # 4: the blocks in order from state 0
    bent, boff = np.zeros(NB, int), np.zeros(NB, int)
    st, off = 0, 0
    for b in range(NB):
        bent[b], boff[b] = st, off
        off += bl[b][st]
        st = bm[b][st]
    # 5: each chunk from its true entry state, OR-ed into the payload
    TW = egdevice.payload_words(n)
    out = np.zeros(TW, np.uint64)
    for c in range(NC):
        b = c // CPB
        s, pos = pm[c][bent[b]], boff[b] + pl[c][bent[b]]
        for L, first in _chunk_runs(words, c, nw, cols, prev[c], n, NC):
            s_next, nb, g, rem = _eg_run(L, s, first)
            bits = "1" * nb + "0" + (format(rem, f"0{g}b") if g else "")
            for i, ch in enumerate(bits):
                if ch == "1" and (pos + i) // 32 < TW:
                    out[(pos + i) // 32] |= np.uint64(1 << (31 - (pos + i)
                                                             % 32))
            pos += len(bits)
            s = s_next
        if c + 1 < NC:      # where the next chunk's writer starts
            b1 = (c + 1) // CPB
            assert pos == boff[b1] + pl[c + 1][bent[b1]]
    assert pos == off
    return out.astype(np.uint32), off


@pytest.mark.parametrize("rows,cols,dens,first_one", [
    (64, 96, 0.02, None), (33, 61, 0.5, None), (75, 101, 0.1, None),
    (180, 100, 0.05, 0), (180, 100, 0.05, 5), (300, 64, 0.0, None),
    (40, 200, 0.25, None), (1, 33, 1.0, None)])
def test_k8_model_equals_plain(rows, cols, dens, first_one):
    """The kernel's order of work, in numpy, == the plain K8, over one and
    several blocks of 8 chunks, ragged rows, a plane whose first run is 0 or
    5, an empty plane and a full one."""
    rs = np.random.RandomState(rows * cols)
    res = rs.rand(rows, cols) < dens
    if first_one is not None:
        res.reshape(-1)[:first_one + 1] = False
        res.reshape(-1)[first_one] = True
    r = torch.from_numpy(bitpack.np_pack(res).view(np.int32))[None]
    words, bits = egdevice.eg_encode(r, cols)
    got, gbits = k8_model(r[0].numpy().view(np.uint32), rows, cols)
    assert gbits == int(bits[0])
    np.testing.assert_array_equal(got, words[0].numpy().view(np.uint32))


def test_eg_work_counts():
    nbytes, floor = roofline.eg_work(512 * 512, 1000, 32 * 100)
    assert nbytes == 512 * 512 // 8 + 8 + 400
    assert floor == pytest.approx(10 * 2 * 4 / roofline.H100_CLOCK_HZ * 1e3)
    assert roofline.eg_work(64, 1, 1, planes=2)[0] == 2 * 16 + 4
