"""K9, codec 8's record pack (ops/recpack): the plain version against native
``bic_pack_tiles`` and the port's pure-Python packer, a numpy model of the
kernel's order of work against the plain version, ``pack_pages``' route
choice, and (marked ``cuda``) the kernel and the encode paths on the card.

The file imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest tests/test_torch_recpack.py --noconftest -q
"""

import collections
import os
from functools import lru_cache

import numpy as np
import pytest
import torch

from binary_image_compression_tpu_torch.models import codec, compress
from binary_image_compression_tpu_torch.ops import _cuda, bitpack, recpack
from binary_image_compression_tpu_torch.utils import pnm, profiling

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
U32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CPU analysis below is many small ops, whose
    thread barriers stall when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc_block(W: int):
    """(page, params, the CPU analysis's record block [1, T, 2 + nw]) of
    doc512 at W, or of text64 past W = 16."""
    return _page_block(W, "doc512.pbm" if W <= 16 else "text64.pbm")


@lru_cache(maxsize=None)
def _page_block(W: int, name: str):
    img = pnm.read_pbm(os.path.join(FIX, name))
    p = codec.CodecParams(codec=8, W=W, R=2 * W, strict=False)
    rows, cols = img.shape
    block = compress.encode_analyze_decided(
        compress._upload(img[None], W, "cpu"), W=W, R=p.R,
        T_thresh=p.resolved_T(), rows=rows, cols=cols)
    return img, p, block


def _replay_k(mode, weight):
    """k_used as the host packer replays it: one adaptive Golomb context
    for matches, one for the rest (GolombCoder.cpp; k starts at 1)."""
    k = np.empty_like(weight)
    for b in range(weight.shape[0]):
        ctx = {True: [0, 0, 1], False: [0, 0, 1]}       # samples, acc, k
        for t in range(weight.shape[1]):
            c = ctx[bool(mode[b, t] < 2)]
            k[b, t] = c[2]
            c[0] += 1
            c[1] += int(weight[b, t])
            c[2] = next((kk for kk in range(32)
                         if ((c[0] << kk) & U32) >= c[1]), 31)
    return k


def _synthetic(B, T, W, seed, *, mode=None, weight=None, k=None, il=None,
               ones=None):
    """A record block of B pages of T random tiles at M = W*W; the fields
    not given are drawn (weights mostly small, as on a page), k_used the
    host's replay unless given, each residual of `ones` ones (its weight
    field unless given).  Returns (block, the fields as numpy)."""
    M = W * W
    rng = np.random.RandomState(seed)
    if mode is None:
        mode = rng.randint(0, 4, (B, T))
    if weight is None:
        weight = np.where(rng.rand(B, T) < 0.7, rng.randint(0, 9, (B, T)),
                          rng.randint(0, M + 1, (B, T)))
    weight = np.minimum(weight, M)
    if il is None:
        il = rng.randint(0, 22, (B, T))
    rank = rng.randint(0, 2 ** 31 - 1, (B, T)) & ((1 << np.minimum(il, 31))
                                                  - 1)
    if k is None:
        k = _replay_k(mode, weight)
    keys = rng.rand(B, T, M)
    order = np.argsort(keys, axis=-1)
    bits = np.zeros((B, T, M), dtype=bool)
    ones = weight if ones is None else ones
    np.put_along_axis(bits, order, np.arange(M) < ones[..., None], -1)
    inv = rng.randint(0, 2, (B, T))
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    block = compress._record_block(t(mode), t(inv), t(k), t(il), t(weight),
                                   t(rank), bitpack.pack(torch.from_numpy(
                                       bits.astype(np.int64))))
    return block.contiguous(), dict(mode=mode, k=k)


def _pages(words, nbits):
    """Each page's payload bytes out of (words, nbits)."""
    starts, sizes, _ = recpack.page_layout(nbits)
    buf = words.cpu().numpy().view(np.uint8)
    return [buf[s:s + n].tobytes() for s, n in zip(starts, sizes)]


def _native(block, M):
    """bic_pack_tiles' payload of each page (an empty header)."""
    return [compress._pack_decided(page, b"", M) for page in block.numpy()]


def _twin(block, M):
    """The port's pure-Python packer (it takes k_used from the block)."""
    return [compress.pack_records_plain(compress._split_decided(page), b"",
                                        M) for page in block.numpy()]


def _place(v, end, pos):
    d = end - pos - 32
    if d >= 64 or d <= -32:
        return 0
    return ((v >> d) if d >= 0 else (v << -d)) & U32


def k9_model(block, M):
    """numpy model of csrc/pack_records.cu's order of work.  k9_offsets:
    each record's length from its header word, their scan, the pages'
    first words.  k9_emit, a warp per tile: lane l's ppl positions and
    their bits, the exclusive scan of the lanes' popcounts, each lane's
    64-bit sums of the table's limbs (only the rank's nl limbs, the upper
    four only where nl > 4), the butterfly sum, the carry pass and the low
    e bits; then lane j's output word from the segments by ``_place``,
    byte-swapped, stored where the record covers it whole, else OR-ed.
    Fails where a stored word has another writer, a sum leaves 64 bits or
    a record touches more words than a warp has lanes."""
    blk = block.numpy()
    B, T, C = blk.shape
    nw = C - 2
    enb = recpack.enb_table(M).numpy()
    table = recpack.binom_table(M).numpy().view(np.uint32).astype(object)
    ppl = -(-M // 32)
    h = blk[..., 0].astype(np.int64)
    mode, inv, k, il, w = h & 3, (h >> 2) & 1, (h >> 3) & 31, (h >> 8) & 63, \
        h >> 14
    bad = ((w < 0) | (w > M)).any(1)
    wc = np.clip(w, 0, M)
    pre = np.where(mode < 2, 3 + il, 2)
    ln = np.where(bad[:, None], 0, pre + k + (wc >> k) + 1 + enb[wc])
    nbits = np.where(bad, -1, ln.sum(1))
    page_words = (ln.sum(1) + 31) // 32
    first = np.cumsum(page_words) - page_words
    off = np.cumsum(ln, 1) - ln
    cap = recpack.capacity_words(B, T, M)
    words = np.zeros(cap, dtype=np.uint32)
    writers = np.zeros(cap, dtype=np.int64)
    stored = np.zeros(cap, dtype=bool)
    for b in np.flatnonzero(~bad):
        for t in range(T):
            m, wt, kk, ll = int(mode[b, t]), int(w[b, t]), int(k[b, t]), \
                int(il[b, t])
            e = int(enb[wt])
            nl = (e + 31) >> 5
            limb = [0] * recpack.LIMBS
            if nl:
                res = blk[b, t, 2:].view(np.uint32)
                lanes = []
                for lane in range(32):
                    qs = [lane * ppl + p for p in range(ppl)]
                    lanes.append([(q, (int(res[min(q >> 5, nw - 1)])
                                       >> (31 - (q & 31))) & 1 if q < M
                                   else 0) for q in qs])
                cnt = [sum(bit for _, bit in x) for x in lanes]
                acc = [[0] * recpack.LIMBS for _ in range(32)]
                for lane in range(32):
                    rem = wt - sum(cnt[:lane])
                    for q, bit in lanes[lane]:
                        if q >= M:
                            continue
                        a = M - 1 - q
                        if bit:
                            rem -= 1
                        elif rem > 0 and rem - 1 <= a:
                            c = table[a * (a + 1) // 2 + rem - 1]
                            for j in range(8 if nl > 4 else 4):
                                acc[lane][j] += c[j]
                carry = 0
                for j in range(nl):
                    s = sum(acc[lane][j] for lane in range(32))
                    assert s < 2 ** 64
                    carry += s
                    limb[j] = carry & U32
                    carry >>= 32
                top = e - 32 * (nl - 1)
                limb[nl - 1] &= (1 << top) - 1
            length = int(ln[b, t])
            o = int(first[b]) * 32 + int(off[b, t])
            w0 = o >> 5
            span = ((o + length + 31) >> 5) - w0
            assert span <= 32
            rank = int(blk[b, t, 1])
            for lane in range(span):
                pos = (w0 + lane) * 32 - o
                if m < 2:
                    out = _place(4 | (m & 1) << 1 | int(inv[b, t]), 3, pos)
                    out |= _place(rank & ((1 << ll) - 1), 3 + ll, pos)
                else:
                    out = _place(m & 1, 2, pos)
                p_ = int(pre[b, t])
                out |= _place(wt & ((1 << kk) - 1), p_ + kk, pos)
                out |= _place(1, length - e, pos)
                for j in range(nl):
                    out |= _place(limb[j], length - 32 * j, pos)
                out = int.from_bytes(out.to_bytes(4, "big"), "little")
                if pos >= 0 and pos + 32 <= length:
                    assert writers[w0 + lane] == 0
                    words[w0 + lane] = out
                    stored[w0 + lane] = True
                else:
                    words[w0 + lane] |= out
                writers[w0 + lane] += 1
    assert not (stored & (writers > 1)).any()
    return torch.from_numpy(words.view(np.int32)), torch.from_numpy(nbits)


# name -> (W, block builder, the references it is held to: the native
# packer where k_used is its replay, the port's Python packer where the
# weight field is the residual's)
BOTH, NATIVE, TWIN = ("native", "twin"), ("native",), ("twin",)
CASES = {
    "weights 0 and M": (16, lambda: _synthetic(
        2, 300, 16, 1, weight=np.tile([0, 256, 3, 0, 256, 255, 1], 86)[
            :600].reshape(2, 300)), BOTH),
    "k 0 and long unary runs": (16, lambda: _synthetic(
        1, 120, 16, 2, mode=np.tile([2, 0], 60)[None],
        weight=np.r_[np.zeros(100, int), np.full(20, 256)][None]), BOTH),
    "k 31": (16, lambda: _synthetic(1, 200, 16, 3,
                                    k=np.full((1, 200), 31)), TWIN),
    "idx_len 0 and 63": (16, lambda: _synthetic(
        1, 256, 16, 4, mode=np.zeros((1, 256), int),
        il=np.tile([0, 63], 128)[None]), BOTH),
    "all four modes": (16, lambda: _synthetic(
        1, 400, 16, 5, mode=np.tile(np.arange(4), 100)[None]), BOTH),
    "pages of different lengths": (16, lambda: _synthetic(
        3, 150, 16, 6, weight=np.stack([np.zeros(150, int),
                                        np.full(150, 128),
                                        np.arange(150) % 7])), BOTH),
    "T ragged, W=8": (8, lambda: _synthetic(2, 203, 8, 7), BOTH),
    "W=5 (one word, a position a lane)": (5, lambda: _synthetic(
        2, 97, 5, 8), BOTH),
    "W=12 (5 words, 5 positions a lane)": (12, lambda: _synthetic(
        1, 150, 12, 9), BOTH),
    # the walk counts down from the weight field, and a rank past enb[w]
    # bits is cut to its low bits, as bic_pack_tiles does
    "weights unlike the residual's": (16, lambda: _synthetic(
        1, 300, 16, 10, weight=np.tile([40, 128, 200, 3, 0], 60)[None],
        ones=np.tile([45, 120, 230, 0, 9], 60)[None]), NATIVE),
}


@pytest.mark.parametrize("W", [8, 16])
def test_plain_matches_native_on_doc512(W):
    img, p, block = _doc_block(W)
    M = W * W
    words, nbits = recpack.pack_records(block, M)
    got = _pages(words, nbits)
    assert got == _native(block, M) == _twin(block, M)
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    assert hdr + got[0] == compress.host_encode(img, p)
    assert words.shape == (recpack.capacity_words(1, block.shape[1], M),)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_native_on_edge_cases(case):
    W, build, refs = CASES[case]
    block, f = build()
    words, nbits = recpack.pack_records(block, W * W)
    got = _pages(words, nbits)
    if "twin" in refs:
        assert got == _twin(block, W * W)
    if "native" in refs:
        assert got == _native(block, W * W)
    assert (nbits > 0).all()
    assert int(recpack.page_layout(nbits)[2]) <= words.numel()
    assert not words[recpack.page_layout(nbits)[2]:].any()
    if case.startswith("k 0"):              # each context's first w = M
        assert (f["k"][0, 100:102] == 0).all()      # at k 0: 256 zeros


@pytest.mark.parametrize("case", ["doc512 W=8", "doc512 W=16"] + list(CASES))
def test_k9_model_matches_plain(case):
    if case.startswith("doc512"):
        W = int(case.split("=")[1])
        block = _doc_block(W)[2]
    else:
        W, build, _ = CASES[case]
        block = build()[0]
    want = recpack.pack_records_plain(block, W * W)
    got = k9_model(block, W * W)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_longest_records_fit_the_buffer():
    """Every tile at the longest record (idx_len 63, k 0 and w = M, or the
    widest rank): the pages fill their buffer exactly or less."""
    for W in (4, 8, 16):
        M = W * W
        half = int(recpack.enb_table(M).argmax())
        block, _ = _synthetic(2, 33, W, W, mode=np.zeros((2, 33), int),
                              weight=np.tile([M, half, M], 22).reshape(2, 33),
                              k=np.zeros((2, 33), int),
                              il=np.full((2, 33), 63))
        words, nbits = recpack.pack_records_plain(block, M)
        assert int(nbits.sum()) <= 32 * words.numel()
        assert int(nbits.max()) <= 33 * recpack.record_bits_max(M)
        assert _pages(words, nbits) == _twin(block, M)


def test_k9_bytes():
    """The bound's bytes on doc512 at W=16, R=32: the [1, 1024, 10] block
    read, the 171,564-bit payload's 5,362 words and two int64 written."""
    from binary_image_compression_tpu_torch.utils import roofline
    words, nbits = recpack.pack_records(_doc_block(16)[2], 256)
    used = recpack.page_layout(nbits)[2]
    assert (int(nbits[0]), used) == (171564, 5362)
    assert roofline.k9_bytes(1, 1024, 8, used) == 40960 + 21448 + 16


def test_tables():
    import math
    for M in (1, 4, 25, 64, 144, 256):
        np.testing.assert_array_equal(recpack.enb_table(M).numpy(),
                                      compress.enb_lut(M))
        limbs = recpack.binom_table(M).numpy().view(np.uint32)
        for a in {0, M // 2, M - 1}:
            for r in {0, a // 2, a}:
                v = sum(int(x) << (32 * j)
                        for j, x in enumerate(limbs[a * (a + 1) // 2 + r]))
                assert v == math.comb(a, r)
    with pytest.raises(ValueError):
        recpack.binom_table(257)


def test_weight_outside_range_refuses_its_page_alone():
    block, _ = _synthetic(3, 40, 8, 11)
    bad = block.clone()
    bad[1, 7, 0] = (bad[1, 7, 0] & ((1 << 14) - 1)) | (65 << 14)
    words, nbits = recpack.pack_records_plain(bad, 64)
    assert nbits[1] == -1 and (nbits[[0, 2]] > 0).all()
    pages = _pages(words, nbits)
    assert pages[1] == b""
    ok = _pages(*recpack.pack_records_plain(block, 64))
    assert [pages[0], pages[2]] == [ok[0], ok[2]]
    assert torch.equal(k9_model(bad, 64)[0], words)


def test_wrapper_checks_its_input():
    block = _doc_block(8)[2]
    with pytest.raises(ValueError):
        recpack.pack_records(block, 400)             # M > 256: no table
    with pytest.raises(ValueError):
        recpack.pack_records(block.to(torch.int64), 64)
    with pytest.raises(ValueError):
        recpack.pack_records(block[..., :-1], 64)    # nw != nwords(M)
    with pytest.raises(ValueError):
        recpack.pack_records(block.repeat(1, 1, 2)[..., ::2], 64)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device: drives pack_pages'
    device route on the CPU, with K9's plain version in its place."""

    @property
    def is_cuda(self):
        return True


def _routes(monkeypatch, block, page, p):
    """(stream, the route's page counters, d2h bytes) of pack_pages."""
    monkeypatch.setattr(recpack, "pack_records", recpack.pack_records_plain)
    was = profiling.RECORDER.on
    profiling.record(True)
    profiling.take()
    try:
        out = compress.pack_pages(block, page[None], p)
        _, counts = profiling.take()
    finally:
        profiling.record(was)
    n = collections.Counter()
    for name, k, _, _ in counts:
        n[name] += k
    return out[0], n


@pytest.mark.parametrize("form,W,route", [
    ("numpy", 16, "host"), ("cpu tensor", 16, "host"),
    ("cuda tensor", 16, "device"), ("cuda tensor", 8, "device"),
    ("cuda tensor", 20, "host")])
def test_pack_pages_route_follows_the_block(monkeypatch, form, W, route):
    img, p, block = _doc_block(W)
    want = compress.host_encode(img, p)
    if form == "numpy":
        block = block.numpy()
    elif form == "cuda tensor":
        block = torch.Tensor._make_subclass(_OnCard, block)
    got, n = _routes(monkeypatch, block, img, p)
    assert got == want
    other = "host" if route == "device" else "device"
    assert n[f"pack_pages_{route}"] == 1 and not n[f"pack_pages_{other}"]
    fetched = n["d2h_bytes"]
    if route == "device":        # the bit count and the payload words used
        assert fetched == 8 + 4 * -(-(len(want) - 28) // 4)
    else:
        assert fetched == (0 if form == "numpy" else block.numel() * 4)


def test_pack_pages_device_route_refuses_a_bad_weight(monkeypatch):
    img, p, block = _doc_block(8)
    bad = block.clone()
    bad[0, 3, 0] = (bad[0, 3, 0] & ((1 << 14) - 1)) | (65 << 14)
    with pytest.raises(ValueError, match="weight outside"):
        _routes(monkeypatch, torch.Tensor._make_subclass(_OnCard, bad), img,
                p)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda", 0)


def _fax_page():
    doc = pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))
    return np.tile(doc, (5, 4))[:2376, :1728]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + [
    "doc512 W=16", "fax page x 2 (two scan chunks a page)"])
def test_k9_matches_plain(dev, case):
    if case == "doc512 W=16":
        W, block = 16, _doc_block(16)[2]
    elif case.startswith("fax"):
        W, block = 16, _synthetic(2, 16500, 16, 12)[0]
    else:
        W, block = CASES[case][0], CASES[case][1]()[0]
    before = _cuda.launches["pack_records"]
    got = recpack.pack_records(block.to(dev), W * W)
    assert _cuda.launches["pack_records"] == before + 1
    torch.cuda.synchronize()
    want = recpack.pack_records_plain(block, W * W)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["encode", "encode_batch", "encode_strict"])
@pytest.mark.parametrize("page", ["doc512", "fax 1728x2376"])
def test_encode_paths_on_card_take_k9(dev, path, page):
    img = (pnm.read_pbm(os.path.join(FIX, "doc512.pbm")) if page == "doc512"
           else _fax_page())
    p = codec.CodecParams(codec=8, W=16, R=128, strict=path == "encode_strict")
    before = _cuda.launches["pack_records"]
    if path == "encode":
        blobs = [compress.encode(img, p, device="cuda")]
    elif path == "encode_batch":
        blobs = compress.encode_batch(np.stack([img, img[::-1]]), p,
                                      device="cuda")
    else:
        blobs = [compress.encode_strict(img, p, device="cuda")]
    assert _cuda.launches["pack_records"] == before + 1
    pages = [img, img[::-1]][:len(blobs)]
    assert blobs == [compress.host_encode(x, p) for x in pages]
