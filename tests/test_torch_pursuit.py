"""The BSVD pursuit on the CPU, exactly: a numpy row-wise model of the pursuit
kernel's order of work (each row alone, until its first non-improvement),
the port's plain pursuit (``packed_dist.packed_pursuit_plain``, the sweep
loop over the plain K5 and K6) and ``models/bsvd.update_coefficients`` on
both routes, against the JAX package's ``update_coefficients`` (the mxu
route, and the packed route with its Pallas kernel in interpret mode), on
planted inputs made with numpy; ties, ``max_flips``, N = 0, the per-row pass
counts against ``utils/roofline.pursuit_work``, and the wrapper's
dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import bsvd as jb
from binary_image_compression_tpu_torch.models import bsvd as tb
from binary_image_compression_tpu_torch.ops import _cuda, bitpack, packed_dist
from binary_image_compression_tpu_torch.utils import roofline


def planted(N, M, K, seed=None):
    """X = (A* D mod 2) ^ 5 % noise with atoms of density 1/4 and about 3
    atoms a row; the pursuit starts from E = X and A = 0 (chip_smoke's
    planted inputs, here at a small size)."""
    rs = np.random.RandomState(N + M + K if seed is None else seed)
    D = rs.rand(K, M) < 0.25
    Astar = rs.rand(N, K) < 3.0 / K
    X = (((Astar.astype(np.int64) @ D.astype(np.int64)) % 2 == 1)
         ^ (rs.rand(N, M) < 0.05))
    return X, D, np.zeros((N, K), dtype=bool)


def rowwise_model(E, D, A, max_flips):
    """The pursuit kernel's order of work: row i alone computes |E_i|, then
    up to max_flips passes of d_k = |E_i ^ D_k| for every k, flipping the
    first minimum while it lowers |E_i|.  Returns (E, A, changed, passes,
    flips), the last two per row."""
    E, A, D = E.astype(bool), A.astype(bool), D.astype(bool)
    N = E.shape[0]
    passes = np.zeros(N, dtype=np.int64)
    flips = np.zeros(N, dtype=np.int64)
    for i in range(N):
        w = int(E[i].sum())
        while passes[i] < max_flips:
            passes[i] += 1
            d = (E[i][None, :] ^ D).sum(axis=1)
            k = int(np.argmin(d))
            if d[k] >= w:
                break
            E[i] ^= D[k]
            A[i, k] ^= True
            w = int(d[k])
            flips[i] += 1
    return E, A, int((flips > 0).sum()), passes, flips


def _t(*xs):
    return [torch.from_numpy(np.asarray(x, dtype=np.int8)) for x in xs]


def plain(E, D, A, max_flips):
    """``packed_pursuit_plain`` on the packed rows, unpacked again."""
    Et, Dt, At = _t(E, D, A)
    Ep = tb._pack(Et)
    changed, passes = packed_dist.packed_pursuit_plain(Ep, tb._pack(Dt), At,
                                                       max_flips)
    assert changed.dtype == torch.int64 and passes.dtype == torch.int32
    return (bitpack.unpack(Ep, E.shape[1]).numpy(), At.numpy().astype(bool),
            int(changed), passes.numpy())


def _jax(E, D, A, max_flips, distances):
    Ej, Aj, cj = jb.update_coefficients(
        *(jnp.asarray(x, jnp.int8) for x in (E, D, A)), max_flips=max_flips,
        distances=distances)
    return np.asarray(Ej).astype(bool), np.asarray(Aj).astype(bool), int(cj)


def _same(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.asarray(g).astype(bool), w)
    assert int(got[2]) == want[2]


# (N, M, K): every K of {1, 8, 31, 33, 64, 512} and M of {1, 31, 256, 2080,
# 4096}; M = 1 makes most atoms duplicates, so most distances tie
CASES = [(64, 256, 64), (40, 1, 8), (48, 31, 31), (48, 256, 33),
         (24, 256, 512), (32, 2080, 8), (16, 4096, 64), (40, 256, 1),
         (0, 256, 8)]


@pytest.mark.parametrize("N,M,K", CASES)
def test_model_plain_and_port_agree(N, M, K):
    E, D, A = planted(N, M, K)
    want = rowwise_model(E, D, A, K)
    got = plain(E, D, A, K)
    _same(got, want)
    np.testing.assert_array_equal(got[3], want[3])
    for route in ("packed", "mxu"):
        Et, At, ct = tb.update_coefficients(*_t(E, D, A), distances=route)
        assert ct.dtype == torch.int64
        _same((Et.numpy(), At.numpy(), ct), want)
    if N:                    # rows flip, and (max_flips = K > 1) repeat
        assert want[2] > 0 and want[3].max() > min(K, 2) - 1


@pytest.mark.parametrize("distances", ["mxu", "packed"])
@pytest.mark.parametrize("N,M,K", [c for c in CASES if c[0]])
def test_model_matches_jax(N, M, K, distances):
    """JAX's packed route runs its Pallas K5 in interpret mode up to M =
    2048 and its float32 product past it."""
    E, D, A = planted(N, M, K)
    want = rowwise_model(E, D, A, K)
    _same(want, _jax(E, D, A, None, distances))


def test_no_rows_matches_jax():
    E, D, A = planted(0, 256, 8)
    want = rowwise_model(E, D, A, 8)
    assert want[2] == 0 and want[3].shape == (0,)
    _same(want, _jax(E, D, A, None, "mxu"))


@pytest.mark.parametrize("distances", ["mxu", "packed"])
@pytest.mark.parametrize("max_flips", [0, 1, 2, None])
def test_max_flips(max_flips, distances):
    """Sweeps cut short: a row that improved on every one of its max_flips
    passes stops there, on every route."""
    E, D, A = planted(64, 256, 64, seed=5)
    mf = 64 if max_flips is None else max_flips
    want = rowwise_model(E, D, A, mf)
    _same(want, _jax(E, D, A, max_flips, distances))
    got = plain(E, D, A, mf)
    _same(got, want)
    np.testing.assert_array_equal(got[3], want[3])
    port = tb.update_coefficients(*_t(E, D, A), max_flips=max_flips,
                                  distances=distances)
    _same(port, want)
    assert want[3].max() == min(mf, want[3].max())
    if max_flips == 0:
        assert want[2] == 0 and not want[3].any()
    if max_flips in (1, 2):                # some row used every pass
        assert (want[3] == mf).any()


@pytest.mark.parametrize("distances", ["mxu", "packed"])
def test_duplicate_atoms_take_the_lowest_k(distances):
    """Every atom twice, the copies after the originals: every tie goes to
    the original, as jnp.argmin's first minimum."""
    E, D, A = planted(48, 96, 16, seed=3)
    D2 = np.concatenate([D, D])
    A2 = np.zeros((48, 32), dtype=bool)
    want = rowwise_model(E, D2, A2, 32)
    assert want[2] > 0 and not want[1][:, 16:].any()
    _same(want, _jax(E, D2, A2, None, distances))
    _same(plain(E, D2, A2, 32), want)


def test_interleaved_duplicates_and_equal_distances():
    """Atoms repeated in place (k, k+1 equal) and rows at equal distance
    from two different atoms."""
    rs = np.random.RandomState(12)
    base = rs.rand(6, 64) < 0.3
    D = np.repeat(base, 2, axis=0)                      # K = 12
    E = np.stack([base[i % 6] ^ base[(i + 1) % 6] for i in range(24)])
    A = np.zeros((24, 12), dtype=bool)
    want = rowwise_model(E, D, A, 12)
    assert not want[1][:, 1::2].any()
    _same(want, _jax(E, D, A, None, "mxu"))
    got = plain(E, D, A, 12)
    _same(got, want)
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("N,M,K", [c for c in CASES if c[0]])
def test_pursuit_work_counts_the_passes(N, M, K):
    E, D, A = planted(N, M, K)
    passes, flips = rowwise_model(E, D, A, K)[3:]
    got = plain(E, D, A, K)[3]
    np.testing.assert_array_equal(got, passes)
    nw = bitpack.nwords(M)
    P = int(passes.sum())
    pops, nbytes = roofline.pursuit_work(P, N, K, nw)
    assert pops == P * K * nw + N * nw
    flips_lower = P - N
    assert nbytes == 4 * (2 * N * nw + K * nw + N) + 2 * max(flips_lower, 0)
    # a row's passes are its flips plus at most one that fails
    assert int(flips.sum()) >= flips_lower


@pytest.mark.parametrize("N,K,nw,P,by", [(1024, 64, 8, 3072, "operations"),
                                         (33120, 512, 8, 4 * 33120,
                                          "operations"),
                                         (5, 1, 1, 5, "bytes"),
                                         (5, 1, 1, 0, "bytes")])
def test_pursuit_work_figures(N, K, nw, P, by):
    """doc512 (K = 64) and the planted letter page (K = 512) at about 3 and
    4 passes a row are bound by their popcounts."""
    pops, nbytes = roofline.pursuit_work(P, N, K, nw)
    assert pops == P * K * nw + N * nw
    assert nbytes == 4 * (2 * N * nw + K * nw + N) + 2 * max(P - N, 0)
    assert roofline.bound_ms(popcounts=pops, nbytes=nbytes)[1] == by


def test_update_coefficients_leaves_inputs_alone():
    E, D, A = planted(32, 64, 8, seed=1)
    A[::3, 2] = True
    args = _t(E, D, A)
    copies = [x.clone() for x in args]
    for route in ("packed", "mxu"):
        Et, At, _ = tb.update_coefficients(*args, distances=route)
        assert Et.dtype == At.dtype == torch.int8
    for x, c in zip(args, copies):
        assert torch.equal(x, c)


def test_wrapper_takes_plain_on_cpu_and_raises_elsewhere():
    E, D, A = planted(20, 64, 8, seed=2)
    Et, Dt, At = _t(E, D, A)
    Ep, Dp = tb._pack(Et), tb._pack(Dt)
    before = dict(_cuda.launches)
    changed, passes = packed_dist.packed_pursuit(Ep, Dp, At, 8)
    assert dict(_cuda.launches) == before   # the plain version counts nothing
    want = rowwise_model(E, D, A, 8)
    _same((bitpack.unpack(Ep, 64).numpy(), At.numpy(), changed), want)
    np.testing.assert_array_equal(passes.numpy(), want[3])
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in (Ep, Dp, At)]
    with pytest.raises(RuntimeError, match="no kernel"):
        packed_dist.packed_pursuit(*meta, 8)
    with pytest.raises(ValueError, match="int8"):
        packed_dist.packed_pursuit(Ep, Dp, At.to(torch.int32), 8)
    with pytest.raises(ValueError, match="contiguous"):
        packed_dist.packed_pursuit(Ep, Dp, torch.zeros((8, 20),
                                                      dtype=torch.int8).T, 8)
    with pytest.raises(ValueError, match="at least one atom"):
        packed_dist.packed_pursuit(Ep, Dp[:0], At[:, :0], 8)
    with pytest.raises(ValueError, match="same number of words"):
        packed_dist.packed_pursuit(Ep, Dp[:, :1], At, 8)
