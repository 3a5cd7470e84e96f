"""Codec 10's device coder in the port against the JAX package, on the CPU,
exactly: the EG table, the MED residual and the bitplanes, the run
extraction at its capacity boundaries, the composition scan, the plain K8
against JAX's ``eg_encode_runs_device`` and the native coder, the run
counts and the capacity ladder that sizes the plain K8's run array, and a
numpy model of K8's order of work (``csrc/eg_encode.cu``: chunk maps
walked from every state by the closed-form run step, tiles composed, a
segmented scan of the tiles, warps writing their chunks' codes through a
ring of words) against the plain version, and the closed-form step against
the coder's block loop."""

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
    """The native coder's step: (exit, nb, g, rem) of a run of L zeros from
    state s, a block at a time."""
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


# the kernel's constants: step table rows (run lengths), ring words, the
# tile scan's segments (warps)
TAB_RUNS, RING, SCAN_WARPS = egdevice.TAB_RUNS, 64, 32


def _blocks_below(s):
    """csrc blocks_below: C[s], the zeros in the blocks of states < s."""
    if s < 16:
        return 4 * ((1 << (s >> 2)) - 1) + ((s & 3) << (s >> 2))
    if s < 24:
        i = (s - 16) >> 1
        return 60 + 32 * ((1 << i) - 1) + (((s - 16) & 1) << (4 + i))
    return 540 + 256 * ((1 << (s - 24)) - 1)


CS = np.array([_blocks_below(s) for s in range(32)], np.int64)


def _eg_code(L, s):
    """csrc eg_code, on numpy arrays: (exit, nb, g, rem) of runs of L zeros
    from states s, in a fixed number of operations."""
    X = np.asarray(L, np.int64) + CS[np.asarray(s)]
    seg = (X >= 60).astype(np.int64) + (X >= 540)
    base = np.array([0, 60, 540])[seg]
    lu, lg, g0 = 2 + 3 * seg, 2 - seg, 4 * seg
    s0 = np.array([0, 16, 24])[seg]
    d = X - base
    j = np.minimum(np.floor(np.log2((d >> lu) + 1)).astype(np.int64), 7)
    e = d - (((1 << j) - 1) << lu)
    b = g0 + j
    t = s0 + (j << lg) + (e >> b)
    return (np.maximum(np.minimum(t, 31) - 1, 0), t - np.asarray(s), b,
            e & ((1 << b) - 1))


def _eg_first(L):
    if L == 0:
        return 0, 0, 1, 0
    ex, nb, g, rem = (int(v) for v in _eg_code(L - 1, 1))
    return ex, nb + 1, g, rem


def _pack(ex, nb, g):
    """csrc pack: a step as the walks carry it, 4 * exit | bits << 8."""
    return ex << 2 | (nb + 1 + g) << 8


def _exit(v):
    return (v >> 2) & 31


TABLE = np.array([_pack(*_eg_code(L, np.arange(32))[:3])
                  for L in range(TAB_RUNS)])


def _run_step(s, L):
    """csrc run_step: exit << 2 | bits << 8 of a run of L zeros from each
    of s (the step table's entry, or the closed form)."""
    if L < TAB_RUNS:
        return TABLE[L][s]
    return _pack(*_eg_code(L, s)[:3])


def _walk(L, i0, i1, s):
    """csrc walk over L[i0:i1) from states s (an array: the map walk; an
    int: the writer's), a table lookup a run below TAB_RUNS, else the
    closed form (the kernel takes four runs a test; the steps are the
    same).  Returns (exit states, bits, [entry state of each run])."""
    s4, states = np.asarray(s) << 2, []
    acc = 0 * s4
    for i in range(i0, i1):
        states.append(s4 >> 2)
        v = _run_step(s4 >> 2, L[i])
        s4, acc = v & 0x7C, acc + (v >> 8)
    return s4 >> 2, acc, states


def _first_step(L):
    return _pack(*_eg_first(L)[:3])


def _apply(x, agg):
    """csrc apply: the entry (state, last one, bit offset) x, then the
    aggregate agg = (map, bits, f, l), None for the identity."""
    if agg is None:
        return x
    m, b, f, l = agg
    st, lp, off = x
    v = _first_step(f) if lp < 0 else int(_run_step(st, f - lp - 1))
    e = _exit(v)
    return int(m[e]), l, off + (v >> 8) + int(b[e])


def _compose(a, c):
    """a then c (aggregates; None: the identity): the run between a's last
    one and c's first one joins them."""
    if a is None or c is None:
        return c if a is None else a
    v = _run_step(a[0], c[2] - a[3] - 1)
    e = _exit(v)
    return c[0][e], a[1] + (v >> 8) + c[1][e], a[2], c[3]


def _chunk(words, c, nw, cols, cw):
    """k8_chunk_maps for chunk c of cw words: (aggregate or None, its inner
    run lengths, its first and last one)."""
    ones = []
    for k in range(cw):
        gi = c * cw + k
        if gi >= words.size:
            break
        w, base = int(words[gi]), (gi // nw) * cols + (gi % nw) * 32
        ones += [base + bit for bit in range(32) if w >> (31 - bit) & 1]
    if not ones:
        return None, [], -1, -1
    inner = [q - p - 1 for p, q in zip(ones, ones[1:])]
    s, bits, _ = _walk([0] + inner, 1, len(ones), np.arange(32))
    return (s, bits, ones[0], ones[-1]), inner, ones[0], ones[-1]


def _tile_scan(aggs):
    """k8_tile_scan on one plane's tile aggregates: ~sqrt(NT) segments (at
    most SCAN_WARPS) of ceil(NT / segments) tiles each composed, the
    segments run from the plane's start, each segment run again from its
    entry: each tile's entry (state, last one before it, bit offset)."""
    NT = len(aggs)
    nseg = min(SCAN_WARPS, max(1, int(np.ceil(np.sqrt(NT)))))
    seg = -(-NT // nseg)
    spans = [range(min(NT, w * seg), min(NT, w * seg + seg))
             for w in range(nseg)]
    x, starts = (0, -1, 0), []
    for span in spans:
        a = None
        for k in span:
            a = _compose(a, aggs[k])
        starts.append(x)
        x = _apply(x, a)
    entries = []
    for span, x in zip(spans, starts):
        for k in span:
            entries.append(x)
            x = _apply(x, aggs[k])
    return entries


def _word_bits(k, q, nb, g, rem):
    """csrc WarpWriter: the bits of a code at relative bit q (nb ones, '0',
    g-bit rem) that fall in relative word k, MSB-first."""
    kb, last = k << 5, q + nb + g
    a, e = max(q, kb) - kb, min(q + nb, kb + 32) - kb
    v = ((0xFFFFFFFF >> a) & ~(0 if e >= 32 else 0xFFFFFFFF >> e)) \
        if a < e else 0
    d = kb + 31 - last
    if g and -32 < d < 32:
        v |= (rem << d if d >= 0 else rem >> -d) & 0xFFFFFFFF
    return v


def _emit(out, owners, c, cr, s, a0, TW):
    """k8_emit for chunk c: its runs cr = (L, cnt, R, L0, Lt, first0) (run
    0 ends at its first one, or is the trailing run of an empty last chunk;
    runs 1 .. cnt-1 are L[i]; run cnt the trailing run), from state s at bit
    a0, 32 at a time: the walk leaves each run's entry state with its lane
    (run 0 and the trailing run stepped apart), each lane codes its run and
    takes its offset from a scan of the code lengths, ORs its code into a
    ring of RING words; complete words are stored (the chunk's first and
    last words OR-ed).  owners records who stored or OR-ed each word.
    Returns the end bit."""
    L, cnt, R, L0, Lt, first0 = cr
    length = lambda i: L0 if i == 0 else (L[i] if i < cnt else Lt)
    w0, o, rb = a0 >> 5, a0 & 31, 0
    ring = [0] * RING

    def put(k, shared):
        v, ring[k % RING] = ring[k % RING], 0
        if w0 + k < TW:
            owners.setdefault(w0 + k, []).append((c, shared))
            out[w0 + k] = (out[w0 + k] | v) if shared else v

    for i0 in range(0, R, 32):
        i1, states, j = min(R, i0 + 32), [], i0
        if i0 == 0:                      # run 0, stepped apart
            states.append(s)
            s = _exit(_first_step(L0) if first0 else int(_run_step(s, L0)))
            j = 1
        inner = min(i1, cnt)
        if j < inner:
            s, _, st = _walk(L, j, inner, s)
            states += [int(x) for x in st]
        if cnt and inner < i1:           # the trailing run
            states.append(s)
            s = _exit(int(_run_step(s, Lt)))
        assert len(states) == i1 - i0
        codes = [_eg_first(length(i)) if i == 0 and first0 else
                 tuple(int(x) for x in _eg_code(length(i), st))
                 for i, st in zip(range(i0, i1), states)]
        lens = [nb + 1 + g for _, nb, g, _ in codes]
        starts = o + np.concatenate([[0], np.cumsum(lens)[:-1]])
        o += sum(lens)
        codes = list(zip(codes, (int(q) for q in starts)))
        while True:
            top = rb + RING
            for (_, nb, g, rem), q in codes:     # lane i: run i0 + i
                for k in range(max(q >> 5, rb),
                               min((q + nb + g) >> 5, top - 1) + 1):
                    ring[k % RING] |= _word_bits(k, q, nb, g, rem)
            end = min(top, o >> 5)
            for k in range(rb, end):
                put(k, k == 0)
            rb = end
            if end < top:
                break
    if o & 31:
        put(o >> 5, True)
    assert not any(ring)
    return (w0 << 5) + o


def k8_model(res_plane, rows, cols, cw=egdevice.CHUNK_WORDS):
    """K8's kernels on one plane of packed words uint32 [rows, nw] in
    chunks of cw words: (uint32 words [payload_words], total bits)."""
    nw = res_plane.shape[1]
    words = res_plane.reshape(-1)
    n = rows * cols
    CPB = egdevice.CHUNKS_PER_BLOCK
    NC = -(-(rows * nw) // cw)
    NT = -(-NC // CPB)
    # 1. each chunk's aggregate; each tile's composer: the chunks' prefixes
    # within the tile and the tile's aggregate
    chunks = [_chunk(words, c, nw, cols, cw) for c in range(NC)]
    prefix, aggs = [], []
    for b in range(NT):
        pre = None
        for ch in chunks[b * CPB:(b + 1) * CPB]:
            prefix.append(pre)
            pre = _compose(pre, ch[0])
        aggs.append(pre)
    # 2. each tile's entry; the same as one scan in order
    entries = _tile_scan(aggs)
    x = (0, -1, 0)
    for b in range(NT):
        assert entries[b] == x
        x = _apply(x, aggs[b])
    # 3. each chunk from its entry
    TW = egdevice.payload_words(n)
    out, owners, total = np.zeros(TW, np.int64), {}, None
    for c in range(NC):
        agg, inner, f, l = chunks[c]
        x = _apply(entries[c // CPB], prefix[c])
        st, lp, off = x
        cnt = len(inner) + 1 if agg else 0
        Lt = n - 1 - (l if agg else lp)
        R = cnt + (c == NC - 1 and Lt > 0)
        cr = ([0] + inner, cnt, R, f - lp - 1 if agg else Lt, Lt, lp < 0)
        end = _emit(out, owners, c, cr, st, off, TW) if R else off
        if c < NC - 1:
            assert _apply(x, agg)[2] == end
        else:
            total = end
    for wi, who in owners.items():   # a stored word is its chunk's alone
        if any(not shared for _, shared in who):
            assert len({c for c, _ in who}) == 1, (wi, who)
    return out.astype(np.uint32), total


def _closed_form_ref(L, s):
    """_eg_run's block loop on numpy arrays (for every L and s at once)."""
    lut = np.asarray(entropy.EGLUT, np.int32)
    L, s = L.astype(np.int32), s.astype(np.int32)
    nb = np.zeros_like(L)
    g = lut[s]
    take = L >= 1 << g
    while take.any():
        L -= take << g
        nb += take
        s = np.minimum(s + take, 31)
        g = lut[s]
        take = L >= 1 << g
    return np.maximum(s - 1, 0), nb, g, L


def test_closed_form_run_step_equals_eg_run():
    """The kernel's run step (csrc eg_code: a segment of the LUT's block
    prefix, a shift past state 31, no loop) == _eg_run's block loop for
    every state and every L up to 2^17, and == _eg_run itself on a sample
    and near 2^30; C[s] == the prefix sum of EG_BLOCKS."""
    np.testing.assert_array_equal(
        CS, np.concatenate([[0], np.cumsum(entropy.EG_BLOCKS)[:-1]]))
    L = np.repeat(np.arange(2 ** 17 + 1, dtype=np.int64), 32)
    s = np.tile(np.arange(32, dtype=np.int64), 2 ** 17 + 1)
    for got, want in zip(_eg_code(L, s), _closed_form_ref(L, s)):
        np.testing.assert_array_equal(got, want)
    rs = np.random.RandomState(17)
    for Lv in rs.randint(0, 2 ** 17, 20):
        for sv in range(32):
            assert tuple(int(v) for v in _eg_code(Lv, sv)) == \
                _eg_run(int(Lv), sv, False), (Lv, sv)
    # near 2^30 a run takes ~2^15 blocks: a few states, one at a time
    for Lv in [2 ** 30 - 1 - k for k in (0, 1, 32767, 32768)] + \
            list(rs.randint(2 ** 17, 2 ** 30, 2)):
        for sv in (0, 1, 16, 30, 31):
            assert tuple(int(v) for v in _eg_code(Lv, sv)) == \
                _eg_run(int(Lv), sv, False), (Lv, sv)
    for Lv in [0, 1, 2, 5, 1000, 2 ** 30 - 1]:
        assert _eg_first(Lv) == _eg_run(Lv, 0, True)


def test_step_table_equals_eg_run():
    """K8's step table (``egdevice.step_table``, from the plain version's
    transitions) == the coder's step and the kernel's closed form, for
    every state and run below TAB_RUNS."""
    tab = egdevice.step_table(torch.device("cpu")).numpy().reshape(
        TAB_RUNS, 32)
    np.testing.assert_array_equal(tab, TABLE)
    for s in range(32):
        for L in range(TAB_RUNS):
            ex, nb, g, _ = _eg_run(L, s, False)
            assert (tab[L, s] >> 2 & 31, tab[L, s] >> 8) == (ex, nb + 1 + g)


def _stress(kind, rows, cols, rs):
    """Residual planes that stress K8's geometry."""
    res = np.zeros((rows, cols), bool)
    if kind == "last pixel":            # one run across every chunk
        res[-1, -1] = True
    elif kind == "first and last words":
        res[0, :32] = rs.rand(32) < 0.5
        res[-1, (cols - 1) // 32 * 32:] = True
    elif kind == "512 ones":            # whole chunks of ones, in a mix
        res = rs.rand(rows, cols) < 0.05
        res[5:7] = True
    return res


@pytest.mark.parametrize("rows,cols,dens,first_one,kind", [
    (64, 96, 0.02, None, None), (33, 61, 0.5, None, None),
    (75, 101, 0.1, None, None), (180, 100, 0.05, 0, None),
    (180, 100, 0.05, 5, None), (300, 64, 0.0, None, None),
    (40, 200, 0.25, None, None), (1, 33, 1.0, None, None),
    (300, 200, 0, None, "last pixel"),
    (100, 300, 0, None, "first and last words"),
    (64, 512, 0, None, "512 ones"), (37, 70, 0.3, None, None),
    (384, 512, 0.02, None, None), (1400, 96, 0.01, None, None),
    (384, 512, 0.02, None, 64), (37, 70, 0.3, None, 64)])
def test_k8_model_equals_plain(rows, cols, dens, first_one, kind):
    """The kernels' order of work, in numpy, == the plain K8: one tile and
    many, ragged rows and a plane whose words are not a whole number of
    chunks (37 x 70), a first run of 0 or 5, an empty plane and a full one,
    a single one at the last pixel, ones only in the first and last words,
    whole chunks of 512 ones, and tile scans of 48 tiles (7 segments of 7,
    the last of 6) and of 33 (6 of 6, the last of 3); and chunks of 64
    words, as K8 takes on stacks of many chunks."""
    rs = np.random.RandomState(rows * cols)
    cw = kind if isinstance(kind, int) else egdevice.CHUNK_WORDS
    res = _stress(kind, rows, cols, rs) if isinstance(kind, str) \
        else rs.rand(rows, cols) < dens
    if first_one is not None:
        res.reshape(-1)[:first_one + 1] = False
        res.reshape(-1)[first_one] = True
    r = torch.from_numpy(bitpack.np_pack(res).view(np.int32))[None]
    words, bits = egdevice.eg_encode(r, cols)
    got, gbits = k8_model(r[0].numpy().view(np.uint32), rows, cols, cw)
    assert gbits == int(bits[0])
    np.testing.assert_array_equal(got, words[0].numpy().view(np.uint32))


def test_k8_model_stack_of_24():
    """24 planes (a color page's three 8-plane stacks) of mixed densities:
    each plane's model == the plain K8 of the stack."""
    rs = np.random.RandomState(24)
    res = rs.rand(24, 24, 40) < rs.rand(24)[:, None, None]
    r = torch.from_numpy(bitpack.np_pack(res).view(np.int32))
    words, bits = egdevice.eg_encode(r, 40)
    for i in range(24):
        got, gbits = k8_model(r[i].numpy().view(np.uint32), 24, 40)
        assert gbits == int(bits[i])
        np.testing.assert_array_equal(got, words[i].numpy().view(np.uint32))


def test_eg_work_counts():
    nbytes, floor = roofline.eg_work(512 * 512, 1000, 32 * 100)
    assert nbytes == 512 * 512 // 8 + 8 + 400
    assert floor == pytest.approx(10 * 2 * 4 / roofline.H100_CLOCK_HZ * 1e3)
    assert roofline.eg_work(64, 1, 1, planes=2)[0] == 2 * 16 + 4
