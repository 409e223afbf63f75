"""The port's load balancing (``repro_torch.core.balance``) against the JAX package's.

The port keeps a numpy copy of ``repro.core.balance``; on the same item
rating counts both must give the same partition: equal ``perm``,
``inv_perm``, ``cap`` and ``loads``, for every strategy and shard count.
"""
import numpy as np
import pytest

from repro.core import balance as jbalance
from repro_torch.core import balance


def _skewed_nnz(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, size=n), 5000).astype(np.int64)


@pytest.mark.parametrize("strategy", ["lpt", "block", "naive"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_partition_items_matches_jax(strategy, S):
    nnz = _skewed_nnz(S, 301)
    cm = balance.CostModel(fixed=1.0, per_rating=0.02)
    got = balance.partition_items(nnz, S, cm, strategy)
    want = jbalance.partition_items(nnz, S, jbalance.CostModel(1.0, 0.02), strategy)
    assert got.cap == want.cap and got.num_shards == want.num_shards == S
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inv_perm, want.inv_perm)
    np.testing.assert_array_equal(got.loads, want.loads)
    for a, b in zip(got.shards, want.shards):
        np.testing.assert_array_equal(a, b)
    assert got.balance_ratio() == want.balance_ratio()


def test_unknown_strategy_raises_and_cost_model_fit_matches():
    with pytest.raises(ValueError, match="unknown strategy"):
        balance.partition_items(np.ones(4, np.int64), 2, strategy="random")
    nnz = np.array([1, 10, 100, 1000], np.int64)
    times = 3e-6 + 2e-8 * nnz.astype(np.float64)
    got, want = balance.fit_cost_model(nnz, times), jbalance.fit_cost_model(nnz, times)
    assert (got.fixed, got.per_rating) == (want.fixed, want.per_rating)
