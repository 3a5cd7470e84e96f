"""Port bitpack (torch + numpy) against the JAX package's bitpack, exact."""

import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import bitpack as jbp
from binary_image_compression_tpu_torch.ops import bitpack as tbp


@pytest.mark.parametrize("shape", [(5, 1), (3, 31), (4, 32), (2, 3, 33),
                                   (7, 100), (1, 257)])
def test_pack_unpack_match_jax(shape):
    bits = np.random.RandomState(sum(shape)).rand(*shape) < 0.4
    cols = shape[-1]
    want = np.asarray(jbp.pack(bits))
    got = tbp.pack(torch.from_numpy(bits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(tbp.np_pack(bits), jbp.np_pack(bits))
    np.testing.assert_array_equal(tbp.np_unpack(want, cols),
                                  jbp.np_unpack(want, cols))
    back = tbp.unpack(got, cols).numpy()
    np.testing.assert_array_equal(back, np.asarray(jbp.unpack(want, cols)))
    np.testing.assert_array_equal(back, bits)
    # int32 bit patterns unpack to the same bits
    np.testing.assert_array_equal(tbp.unpack(tbp.to_i32(got), cols).numpy(),
                                  bits)
    assert tbp.nwords(cols) == jbp.nwords(cols)


def test_popcount_and_i32_patterns_match_jax():
    rs = np.random.RandomState(3)
    words = rs.randint(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    words[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    want = np.asarray(jbp.popcount(words))
    got = tbp.popcount(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    i32 = tbp.to_i32(torch.from_numpy(words.astype(np.int64)))
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(i32.numpy().view(np.uint32), words)
    np.testing.assert_array_equal(tbp.from_i32(i32).numpy(),
                                  words.astype(np.int64))


# --- the L0 API: every name against JAX's, exact ---------------------------

import jax  # noqa: E402

from binary_image_compression_tpu_torch.ops import packed_dist  # noqa: E402

WIDTHS = [31, 33, 250]


def _words(seed, shape, cols, dirty):
    """Random uint32 words [..., nwords(cols)]; dirty=False clears the bits
    past `cols`, dirty=True leaves them random."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 2 ** 32, size=shape + (jbp.nwords(cols),),
                   dtype=np.uint64).astype(np.uint32)
    return w if dirty else w & jbp.trail_mask(cols)


def _jax(fn, *arrays):
    """JAX's fn(*arrays) under one jit (one compile per case, not one per
    eager op); fn closes over its integer arguments."""
    return jax.tree.map(np.asarray, jax.jit(fn)(*arrays))


def _t(words):
    return torch.from_numpy(np.asarray(words).astype(np.int64))


def _eq(got, want):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of K5's and K6's wrappers (their plain versions on
    the CPU), to show which names go through the kernels."""
    calls = {"dist": 0, "weight": 0}
    dist, weight = packed_dist.packed_dist_matrix, packed_dist.packed_row_weight

    def count_dist(a, b):
        calls["dist"] += 1
        return dist(a, b)

    def count_weight(a):
        calls["weight"] += 1
        return weight(a)
    monkeypatch.setattr(packed_dist, "packed_dist_matrix", count_dist)
    monkeypatch.setattr(packed_dist, "packed_row_weight", count_weight)
    return calls


@pytest.mark.parametrize("cols", WIDTHS + [32, 64])
def test_trail_mask_matches_jax(cols):
    m = tbp.trail_mask(cols)
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy().view(np.uint32),
                                  jbp.trail_mask(cols))


_BINARY = ("xor", "add", "bool_and", "bool_or", "dist")
_UNARY = ("weight", "row_weight", "gf2_sum", "row_sum", "col_sum")


@pytest.mark.parametrize("dirty", [False, True])
@pytest.mark.parametrize("cols,lead", [(31, ()), (33, (3,)), (250, (3,))])
def test_elementwise_and_reductions_match_jax(cols, lead, dirty,
                                              kernel_calls):
    """xor/add, bool_and, bool_or, flip, the weights, the parities and dist
    on [..., 7, nwords(cols)] words; with dirty padding the padding bits
    count where JAX counts them."""
    a = _words(cols, lead + (7,), cols, dirty)
    b = _words(cols + 1, lead + (7,), cols, dirty)
    want = _jax(lambda a, b: (
        [getattr(jbp, n)(a, b) for n in _BINARY]
        + [getattr(jbp, n)(a) for n in _UNARY]
        + [jbp.flip(a, cols), jbp.col_weight(a, cols)]), a, b)
    ta, tb_ = _t(a), _t(b)
    got = ([getattr(tbp, n)(ta, tb_) for n in _BINARY]
           + [getattr(tbp, n)(ta) for n in _UNARY]
           + [tbp.flip(ta, cols), tbp.col_weight(ta, cols)])
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[6].dtype == got[5].dtype == torch.int32   # row_weight, weight
    # int32 bit patterns are the same words
    _eq(tbp.row_weight(tbp.to_i32(ta)), want[6])
    _eq(tbp.xor(tbp.to_i32(ta), tb_), want[0])
    # each call of dist, weight, row_weight, gf2_sum and row_sum reaches
    # K6 once (6 above), and nothing here reaches K5
    assert kernel_calls == {"dist": 0, "weight": 6}


@pytest.mark.parametrize("at", [False, True])
@pytest.mark.parametrize("bt", [False, True])
def test_mul_matches_jax(at, bt):
    """All four transpose combinations over ragged widths (n, k, m) = (31,
    250, 33); the padding of the inputs is dirty and ignored."""
    n, k, m = 31, 250, 33
    ash, acols = ((k,), n) if at else ((n,), k)
    bsh, bcols = ((m,), k) if bt else ((k,), m)
    a, b = _words(1, ash, acols, True), _words(2, bsh, bcols, True)
    got = tbp.mul(_t(a), acols, at, _t(b), bcols, bt)
    _eq(got, _jax(lambda a, b: jbp.mul(a, acols, at, b, bcols, bt), a, b))
    assert got.shape == (n, tbp.nwords(m))
    with pytest.raises(AssertionError, match="dim mismatch"):
        tbp.mul(_t(a), acols, not at, _t(b), bcols, bt)


@pytest.mark.parametrize("cols,dirty", [(c, d) for c in WIDTHS
                                        for d in (False, True)]
                         + [(256, False)])
def test_and_counts_and_dist_matrix_match_jax(cols, dirty, kernel_calls):
    """dist_matrix goes through K5 on the rows masked to `cols`; with dirty
    padding the bits past `cols` count as JAX's row weights count them,
    and with clean padding it is |A_i ^ B_j|.  At 256 bits there is no
    padding to be dirty."""
    a, b = _words(cols, (17,), cols, dirty), _words(cols + 2, (23,), cols,
                                                     dirty)
    want = _jax(lambda a, b: (jbp.and_counts(a, b, cols),
                              jbp.dist_matrix(a, b, cols)), a, b)
    ac = tbp.and_counts(_t(a), _t(b), cols)
    assert ac.dtype == torch.int32
    _eq(ac, want[0])
    d = tbp.dist_matrix(_t(a), _t(b), cols)
    assert d.dtype == torch.int32 and kernel_calls["dist"] == 1
    _eq(d, want[1])
    A, B = jbp.np_unpack(a, cols), jbp.np_unpack(b, cols)
    xor = (A[:, None, :] ^ B[None, :, :]).sum(-1)
    assert np.array_equal(d.numpy(), xor) != dirty


@pytest.mark.parametrize("rows,cols,lead", [(33, 250, ()), (5, 70, (2,)),
                                            (31, 33, (2,))])
def test_transpose_and_submatrices_match_jax(rows, cols, lead):
    w = _words(rows + cols, lead + (rows,), cols, True)
    i0, i1, j0, j1 = 1, rows - 2, 3, cols - 1
    sc = min(31, cols - 4)
    sub = _words(7, lead + (rows - 3,), sc, True)
    want = _jax(lambda w, sub: (
        jbp.transpose(w, rows, cols), jbp.submatrix(w, i0, i1, j0, j1, cols),
        jbp.set_submatrix(w, sub, 2, 4, cols, sc)), w, sub)
    tw = _t(w)
    _eq(tbp.transpose(tw, rows, cols), want[0])
    _eq(tbp.submatrix(tw, i0, i1, j0, j1, cols), want[1])
    _eq(tbp.set_submatrix(tw, _t(sub), 2, 4, cols, sc), want[2])


@pytest.mark.parametrize("W,lead", [(16, ()), (5, (2,))])
def test_patch_vectorizers_match_jax(W, lead):
    """unpatchify, vectorize_patches and unvectorize_patches on a 50 x 70
    page (ragged tiles), W*W = 256 and 25 bits a row."""
    img = np.random.RandomState(W).rand(*lead, 50, 70) < 0.4
    want = _jax(lambda img: (
        jbp.unpatchify(jbp.patchify(img, W), 50, 70, W),
        jbp.vectorize_patches(jbp.patchify(img, W)),
        jbp.unvectorize_patches(jbp.vectorize_patches(jbp.patchify(img, W)),
                                W)), img)
    tiles = tbp.patchify(torch.from_numpy(img), W)
    _eq(tbp.unpatchify(tiles, 50, 70, W), want[0])
    np.testing.assert_array_equal(want[0], img)
    v = tbp.vectorize_patches(tiles)
    _eq(v, want[1])
    _eq(tbp.unvectorize_patches(v, W), want[2])
