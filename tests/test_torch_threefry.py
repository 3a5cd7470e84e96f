"""The port's numpy replay of JAX's threefry draws (``utils/threefry``)
against ``jax.random``, at several seeds and shapes, and the BSVD drivers
that draw from it against the JAX package's from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import bsvd as jb
from binary_image_compression_tpu_torch.models import bsvd as tb
from binary_image_compression_tpu_torch.utils import threefry

SEEDS = [0, 5, 34503498, -7, 2 ** 31 - 1]


def _key_data(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    kt = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(kt, _key_data(k))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(threefry.split(kt, n),
                                      np.asarray(jax.random.split(k, n)))
    # JAX's unpacking idiom, twice down the chain
    a, b = jax.random.split(k)
    at, bt = threefry.split(kt)
    np.testing.assert_array_equal(threefry.split(bt),
                                  np.asarray(jax.random.split(b)))
    np.testing.assert_array_equal(at, np.asarray(a))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((1000,), 0, 64), ((7, 3), 3, 100003),
                                         ((5,), 0, 1), ((4096,), 0, 1024),
                                         ((2, 2, 3), -50, 50)])
def test_randint(seed, shape, lo, hi):
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
    got = threefry.randint(threefry.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(64, 256), (1, 1), (3, 17)])
def test_bernoulli(seed, shape):
    want = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, shape)
    got = threefry.bernoulli(threefry.PRNGKey(seed), 0.5, shape)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,k", [(100, 10), (1024, 512), (5000, 64), (3, 3)])
def test_choice_without_replacement(seed, n, k):
    """5000 takes two sorting rounds, the others one."""
    want = jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                             replace=False)
    got = threefry.choice(threefry.PRNGKey(seed), n, k)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_seed_outside_int32_refused():
    with pytest.raises(OverflowError):
        threefry.PRNGKey(2 ** 31)


def _structured(seed, atoms, n, m):
    rng = np.random.RandomState(seed)
    at = rng.rand(atoms, m) < 0.35
    co = rng.rand(n, atoms) < 0.3
    X = ((co.astype(int) @ at.astype(int)) % 2).astype(bool)
    X ^= rng.rand(n, m) < 0.02
    return X.astype(np.int8)


def _same(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("init", ["random_centroids", "neighbor", "random",
                                  "graph_grow"])
def test_learn_from_seed_matches_jax(init):
    X = _structured(1, 5, 64, 48)
    want = jb.learn(jnp.asarray(X), K=8, init=init, max_iters=10, seed=11)
    got = tb.learn(torch.from_numpy(X), K=8, init=init, max_iters=10,
                   seed=11)
    _same(got, want)
    assert got[3] == int(want[3])


def test_learn_alter_from_seed_matches_jax():
    X = _structured(2, 4, 48, 32)
    want = jb.learn_alter(jnp.asarray(X), K=6, init="random_centroids",
                          variant=1, max_iters=4, seed=3)
    got = tb.learn_alter(torch.from_numpy(X), K=6, init="random_centroids",
                         variant=1, max_iters=4, seed=3)
    _same(got, want)


def test_mdl_forward_and_full_split_keys_as_jax():
    """Forward draws each new atom from the next split; full draws each
    restart from the next split."""
    X = _structured(5, 2, 64, 32)
    want = jb.learn_mdl_forward(jnp.asarray(X), K0=1, max_k=3,
                                init="neighbor", seed=9)
    got = tb.learn_mdl_forward(torch.from_numpy(X), K0=1, max_k=3,
                               init="neighbor", seed=9)
    _same(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    want = jb.learn_mdl_full(jnp.asarray(X), Kmax=4, Kstep=2, reps=2,
                             init="random_centroids", seed=9)
    got = tb.learn_mdl_full(torch.from_numpy(X), Kmax=4, Kstep=2, reps=2,
                            init="random_centroids", seed=9)
    _same(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
