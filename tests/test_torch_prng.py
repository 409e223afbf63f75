"""The port's threefry random numbers against jax.random, and its own gamma.

Keys, bits, fold_in and split must equal JAX's exactly; normals go through
XLA's float32 erfinv polynomial and match to 1e-6. The port's gamma is its
own Marsaglia–Tsang sampler, so it is held to the Gamma distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_equal_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_data(jk), tk.numpy())
    for d in (0, 5, 2**31 + 3):
        np.testing.assert_array_equal(
            _data(jax.random.fold_in(jk, np.uint32(d))), prng.fold_in(tk, d).numpy()
        )
    ids = np.arange(0, 1000, 7)
    batched = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(_data(batched), prng.fold_in(tk, torch.from_numpy(ids)).numpy())
    for n in (2, 3, 5):
        np.testing.assert_array_equal(_data(jax.random.split(jk, n)), prng.split(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 3, 5)])
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jb, prng.random_bits(tk, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape)), prng.uniform(tk, shape).numpy()
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    jn = np.asarray(jax.random.normal(jk, (20_000,)))
    np.testing.assert_allclose(prng.normal(tk, (20_000,)).numpy(), jn, rtol=0, atol=1e-6)
    # batched keys: per-item noise keyed by item id, as posterior.item_noise draws it
    ids = np.array([0, 3, 99, 1234])
    want = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(jk, i), (8,)))(ids)
    got = prng.normal(prng.fold_in(tk, torch.from_numpy(ids)), (8,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("a", [0.4, 1.0, 2.5, 16.5])
def test_gamma_distribution(a):
    """Kolmogorov-Smirnov against scipy's Gamma(a), plus the first two moments."""
    draws = prng.gamma(prng.key(3), torch.full((40_000,), a)).numpy()
    assert np.isfinite(draws).all() and (draws > 0).all()
    assert scipy.stats.kstest(draws, scipy.stats.gamma(a).cdf).pvalue > 1e-3
    np.testing.assert_allclose(draws.mean(), a, rtol=0.03)
    np.testing.assert_allclose(draws.var(), a, rtol=0.05)


def test_gamma_is_deterministic_in_the_key():
    a = torch.linspace(0.5, 20.0, 32)
    np.testing.assert_array_equal(prng.gamma(prng.key(9), a), prng.gamma(prng.key(9), a))
    assert not torch.equal(prng.gamma(prng.key(9), a), prng.gamma(prng.key(10), a))
