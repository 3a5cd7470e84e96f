"""The port's BSVD (models/bsvd) against the JAX package's on the same
states, on the CPU: the pursuit in both forms, the dictionary updates,
the initializer cores with JAX's draws injected, and the learning drivers.
Integer and boolean outputs are compared exactly, float32 codelengths with
rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import bsvd as jb
from binary_image_compression_tpu.ops import entropy as jent
from binary_image_compression_tpu_torch.models import bsvd as tb
from binary_image_compression_tpu_torch.ops import entropy as tent
from binary_image_compression_tpu_torch.utils import threefry


def _X(rng, n=48, m=64, dens=0.3):
    X = rng.rand(n, m) < dens
    X[X.sum(axis=1) == 0, 0] = True
    return X


def _common_state(rng, n=40, m=48, K=8):
    """tests/test_bsvd_tpu.py's state: X and E = X ^ A*D."""
    X = _X(rng, n=n, m=m)
    D = rng.rand(K, m) < 0.25
    A = rng.rand(n, K) < 0.15
    E = ((A.astype(np.int64) @ D.astype(np.int64)) % 2 == 1) ^ X
    return X, E, D, A


def _structured(seed, atoms, n, m, noise=0.02):
    """Rows made of a few shared atoms plus sparse noise, so learning has
    something to find (as tests/test_bsvd_tpu.py makes them)."""
    rng = np.random.RandomState(seed)
    at = rng.rand(atoms, m) < 0.35
    co = rng.rand(n, atoms) < 0.3
    X = ((co.astype(int) @ at.astype(int)) % 2).astype(bool)
    X ^= rng.rand(n, m) < noise
    X[X.sum(axis=1) == 0, 0] = True
    return X


def _j(*xs):
    return [jnp.asarray(x, jnp.int8) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x, dtype=np.int8)) for x in xs]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("impl", ["mxu", "packed"])
@pytest.mark.parametrize("m", [48, 2048, 2080])
def test_distances_to_atoms_matches_jax(impl, m):
    """Both forms, either side of JAX's M <= 2048 bound of its packed
    route; the port's packed route takes every M."""
    rng = np.random.RandomState(m)
    E, D = rng.rand(37, m) < 0.3, rng.rand(9, m) < 0.4
    want = np.asarray(jb.distances_to_atoms(*_j(E, D), impl=impl))
    got = tb.distances_to_atoms(*_t(E, D), impl=impl)
    assert got.dtype == (torch.int32 if impl == "packed" else torch.float32)
    _eq(got.to(torch.float32), want)


@pytest.mark.parametrize("distances", ["mxu", "packed", "gram"])
@pytest.mark.parametrize("n,m,K", [(40, 48, 8), (64, 96, 16), (128, 64, 32),
                                   (32, 2080, 8)])
def test_update_coefficients_matches_jax(distances, n, m, K):
    X, E, D, A = _common_state(np.random.RandomState(n + m + K), n=n, m=m,
                               K=K)
    Ej, Aj, cj = jb.update_coefficients(*_j(E, D, A), distances=distances)
    Et, At, ct = tb.update_coefficients(*_t(E, D, A), distances=distances)
    _eq(Et, Ej)
    _eq(At, Aj)
    assert int(ct) == int(cj) > 0


@pytest.mark.parametrize("distances", ["mxu", "packed", "gram"])
@pytest.mark.parametrize("max_flips", [0, 1, 2])
def test_update_coefficients_max_flips_matches_jax(distances, max_flips):
    """Sweeps cut short: the carried |E_i| and, on the packed route, the
    packed E unpacked at the end still give JAX's state."""
    X, E, D, A = _common_state(np.random.RandomState(21), n=64, m=96, K=16)
    Ej, Aj, cj = jb.update_coefficients(*_j(E, D, A), max_flips=max_flips,
                                        distances=distances)
    Et, At, ct = tb.update_coefficients(*_t(E, D, A), max_flips=max_flips,
                                        distances=distances)
    assert Et.dtype == At.dtype == torch.int8
    _eq(Et, Ej)
    _eq(At, Aj)
    assert int(ct) == int(cj)


@pytest.mark.parametrize("impl", ["gram", "pallas"])
def test_pursuit_rejects_unknown_distances(impl):
    """distances_to_atoms takes the two forms of d only; "gram" is a route
    of the pursuit, which rejects the rest."""
    args = _t(np.zeros((2, 4)), np.zeros((1, 4)), np.zeros((2, 1)))
    if impl not in tb.DISTANCES:
        with pytest.raises(ValueError, match="distances"):
            tb.update_coefficients(*args, distances=impl)
    with pytest.raises(ValueError, match="distances"):
        tb.distances_to_atoms(*args[:2], impl=impl)


@pytest.mark.parametrize("n,m,K", [(40, 48, 8), (64, 96, 16), (128, 64, 32)])
def test_gram_route_equals_the_other_routes(n, m, K):
    """JAX's three shapes (tests/test_bsvd_tpu.py): the gram route's E, A
    and changed count equal the mxu and packed routes' bit for bit."""
    X, E, D, A = _common_state(np.random.RandomState(n * m + K), n=n, m=m,
                               K=K)
    args = _t(E, D, A)
    Eg, Ag, cg = tb.update_coefficients(*args, distances="gram")
    assert int(cg) > 0
    for route in ("mxu", "packed"):
        Er, Ar, cr = tb.update_coefficients(*args, distances=route)
        assert torch.equal(Eg, Er) and torch.equal(Ag, Ar)
        assert int(cg) == int(cr)
    assert tb.DISTANCES == ("packed", "mxu", "gram")


def test_learn_config_equals_jax():
    assert tb.LearnConfig() == tb.LearnConfig(**vars(jb.LearnConfig()))
    assert list(vars(tb.LearnConfig())) == list(vars(jb.LearnConfig()))


@pytest.mark.parametrize("n,m,K", [(40, 48, 8), (96, 64, 12)])
def test_update_dictionary_steepest_matches_jax(n, m, K):
    X, E, D, A = _common_state(np.random.RandomState(7 + n), n=n, m=m, K=K)
    Ej, Dj, cj = jb.update_dictionary_steepest(*_j(E, D, A))
    Et, Dt, ct = tb.update_dictionary_steepest(*_t(E, D, A))
    _eq(Et, Ej)
    _eq(Dt, Dj)
    assert int(ct) == int(cj) > 0


@pytest.mark.parametrize("n,m,K", [(40, 48, 8), (96, 64, 12)])
def test_update_dictionary_proximus_matches_jax(n, m, K):
    X, E, D, A = _common_state(np.random.RandomState(11 + n), n=n, m=m, K=K)
    Ej, Dj, Aj, cj = jb.update_dictionary_proximus(*_j(E, D, A),
                                                   max_inner=64)
    Et, Dt, At, ct = tb.update_dictionary_proximus(*_t(E, D, A),
                                                   max_inner=64)
    _eq(Et, Ej)
    _eq(Dt, Dj)
    _eq(At, Aj)
    assert int(ct) == int(cj) > 0


def test_update_dictionary_leaves_inputs_alone():
    X, E, D, A = _common_state(np.random.RandomState(2))
    Et, Dt, At = _t(E, D, A)
    copies = [x.clone() for x in (Et, Dt, At)]
    tb.update_dictionary_steepest(Et, Dt, At)
    tb.update_dictionary_proximus(Et, Dt, At)
    for x, c in zip((Et, Dt, At), copies):
        assert torch.equal(x, c)


# --- initializers: JAX's draws injected into the port's cores -------------

SEED = 34503498


@pytest.mark.parametrize("n,m,K", [(48, 64, 12), (20, 30, 40)])
def test_init_random_centroids_core_matches_jax(n, m, K):
    X = _X(np.random.RandomState(n), n=n, m=m)
    key = jax.random.PRNGKey(SEED)
    Dj, Aj = jb.initialize_random_centroids(key, jnp.asarray(X, jnp.int8), K)
    assign = np.array(jax.random.randint(key, (n,), 0, K))
    Dt, At = tb._centroids_from_assign(*_t(X), assign, K)
    _eq(Dt, Dj)
    _eq(At, Aj)


def test_init_neighbor_core_matches_jax():
    X = _X(np.random.RandomState(4), n=48, m=64, dens=0.1)
    key = jax.random.PRNGKey(SEED)
    Dj, Aj = jb.initialize_neighbor(key, jnp.asarray(X, jnp.int8), 12)
    idx = np.array(jax.random.randint(key, (12,), 0, 48))
    Dt, At = tb._neighbor_from_idx(*_t(X), idx, 12)
    _eq(Dt, Dj)
    _eq(At, Aj)


def test_init_random_core_matches_jax():
    X = _X(np.random.RandomState(5), n=30, m=40)
    key = jax.random.PRNGKey(SEED)
    Dj, Aj = jb.initialize_random(key, jnp.asarray(X, jnp.int8), 6)
    bits = np.array(jax.random.bernoulli(key, 0.5, (6, 40)))
    Dt, At = tb._random_from_bits(*_t(X), bits)
    _eq(Dt, Dj)
    _eq(At, Aj)


@pytest.mark.parametrize("zero_rows", [False, True])
def test_init_graph_grow_core_matches_jax(zero_rows):
    X = _X(np.random.RandomState(6), n=40, m=48)
    if zero_rows:
        X[[3, 17, 25]] = False
    key = jax.random.PRNGKey(SEED)
    Dj, Aj = jb.initialize_graph_grow(key, jnp.asarray(X, jnp.int8), 5)
    seeds = np.array(jax.random.choice(key, 40, (5,), replace=False))
    Dt, At = tb._graph_grow_from_seeds(*_t(X), seeds, 5)
    _eq(Dt, Dj)
    _eq(At, Aj)
    # the public initializer takes the same override
    Dt2, _ = tb.initialize_graph_grow(None, *_t(X), 5, seed_idx=seeds)
    _eq(Dt2, Dj)


@pytest.mark.parametrize("K", [12, 80])
def test_init_partition_matches_jax(K):
    X = _X(np.random.RandomState(8), n=48, m=64)
    Dj, Aj = jb.initialize_partition(jax.random.PRNGKey(0),
                                     jnp.asarray(X, jnp.int8), K)
    Dt, At = tb.initialize_partition(None, *_t(X), K)
    _eq(Dt, Dj)
    _eq(At, Aj)


@pytest.mark.parametrize("init", sorted(tb.INITIALIZERS))
def test_initializers_draw_from_the_seed(init):
    """Same seed, same state: the draw replays JAX's threefry key, so each
    initializer gives JAX's state for the same key."""
    Xn = _X(np.random.RandomState(9), n=30, m=40)
    X = _t(Xn)[0]
    a = tb.INITIALIZERS[init](threefry.PRNGKey(5), X, 6)
    b = tb.INITIALIZERS[init](threefry.PRNGKey(5), X, 6)
    want = jb.INITIALIZERS[init](jax.random.PRNGKey(5),
                                 jnp.asarray(Xn, jnp.int8), 6)
    for x, y, w in zip(a, b, want):
        assert x.dtype == torch.int8 and torch.equal(x, y)
        assert x.device == X.device
        _eq(x, w)


# --- drivers, from partition (no draw) ------------------------------------

def _same_state(got, want):
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)


@pytest.mark.parametrize("dict_update", ["steepest", "proximus"])
def test_learn_matches_jax(dict_update):
    X = _structured(1, 6, 64, 64)
    want = jb.learn(jnp.asarray(X, jnp.int8), K=12, init="partition",
                    dict_update=dict_update, max_iters=20)
    got = tb.learn(*_t(X), K=12, init="partition", dict_update=dict_update,
                   max_iters=20)
    _same_state(got, want)
    assert got[3] == int(want[3]) > 1
    assert int(got[0].sum()) < int(X.sum())


@pytest.mark.parametrize("distances", ["packed", "mxu", "gram"])
def test_learn_from_routes_agree(distances):
    X = _structured(2, 5, 48, 64)
    D0, A0 = tb.initialize_partition(None, *_t(X), 10)
    want = jb.learn_from(*_j(X, D0.numpy(), A0.numpy()))
    got = tb.learn_from(*_t(X), D0, A0, distances=distances)
    _same_state(got, want)
    assert got[3] == int(want[3])


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_learn_alter_matches_jax(variant):
    X = _structured(3, 5, 48, 48)
    want = jb.learn_alter(jnp.asarray(X, jnp.int8), K=8, init="partition",
                          variant=variant, max_iters=8)
    got = tb.learn_alter(*_t(X), K=8, init="partition", variant=variant,
                         max_iters=8)
    _same_state(got, want)
    assert got[3] == int(want[3])
    _eq(tb.residual(*_t(X), got[1], got[2]), got[0])


def test_learn_mdl_forward_matches_jax():
    """Two true atoms: K = 4 and 5 do not pay, so the stuck counter and the
    mean deviation decide, and the best model keeps 3 atoms."""
    X = _structured(5, 2, 96, 48, noise=0.0)
    want = jb.learn_mdl_forward(jnp.asarray(X, jnp.int8), K0=1, max_k=5,
                                init="partition")
    got = tb.learn_mdl_forward(*_t(X), K0=1, max_k=5, init="partition")
    _same_state(got, want)
    assert got[1].shape[0] == 3
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_learn_mdl_backward_matches_jax():
    X = _structured(7, 3, 64, 48, noise=0.0)
    want = jb.learn_mdl_backward(jnp.asarray(X, jnp.int8), K0=5,
                                 init="partition")
    got = tb.learn_mdl_backward(*_t(X), K0=5, init="partition")
    _same_state(got, want)
    assert 1 <= got[1].shape[0] < 5
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_learn_mdl_full_matches_jax():
    X = _structured(9, 3, 48, 32, noise=0.0)
    want = jb.learn_mdl_full(jnp.asarray(X, jnp.int8), Kmax=8, Kstep=4,
                             reps=2, init="partition")
    got = tb.learn_mdl_full(*_t(X), Kmax=8, Kstep=4, reps=2,
                            init="partition")
    _same_state(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_model_codelength_matches_jax():
    X, E, D, A = _common_state(np.random.RandomState(13), n=64, m=96, K=16)
    want = float(jb.model_codelength(*_j(E, D, A)))
    got = tb.model_codelength(*_t(E, D, A))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_codelengths_match_jax():
    n, r = np.meshgrid(np.arange(1, 70), np.arange(0, 70), indexing="ij")
    r = np.minimum(r, n)
    want = np.asarray(jent.universal_codelength_jnp(n, r))
    got = tent.universal_codelength_t(torch.from_numpy(n).float(),
                                      torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for nn, rr in ((10, 0), (10, 3), (10, 10), (4096, 77), (1, 1)):
        assert tent.lnchoose(nn, rr) == jent.lnchoose(nn, rr)
        assert tent.enum_codelength(nn, rr) == jent.enum_codelength(nn, rr)
        assert (tent.universal_codelength(nn, rr)
                == jent.universal_codelength(nn, rr))
        np.testing.assert_allclose(
            float(tent.universal_codelength_t(nn, rr)),
            jent.universal_codelength(nn, rr), rtol=1e-6)
    with pytest.raises(ValueError):
        tent.lnchoose(3, 4)


@pytest.mark.parametrize("rows,cols,W", [(64, 64, 8), (75, 101, 8),
                                         (30, 50, 16)])
def test_patchify_to_rows_matches_jax(rows, cols, W):
    img = np.random.RandomState(rows).rand(rows, cols) < 0.4
    want = np.asarray(jb.patchify_to_rows(img, W))
    got = tb.patchify_to_rows(torch.from_numpy(img), W)
    assert got.dtype == torch.int8
    _eq(got, want)


def test_state_crosses_both_ways():
    X = _X(np.random.RandomState(10), n=20, m=32)
    Dj, Aj = jb.initialize_random_centroids(jax.random.PRNGKey(1),
                                            jnp.asarray(X, jnp.int8), 6)
    D, A = tb.state_from_jax(np.asarray(Dj), np.asarray(Aj), device="cpu")
    assert D.dtype == A.dtype == torch.int8
    back = tb.state_to_numpy(D, A)
    for b, j in zip(back, (Dj, Aj)):
        assert b.dtype == np.int8
        _eq(b, j)
