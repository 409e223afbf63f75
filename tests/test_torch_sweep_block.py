"""The port's sweep block as one device program, on the CPU.

* No host read inside a block: ``sequential``, ``ring`` (S = 2) and
  ``posterior_merge`` (P = 2) run ``backend.sweep_block`` across burn-in
  while every way a tensor reaches the host (``__bool__``, ``__int__``,
  ``__float__``, ``item``, ``tolist``, ``cpu``, ``numpy``) and every way
  host data becomes a tensor (``torch.tensor``, ``as_tensor``,
  ``from_numpy``) raises. On a card such a block is what the backends
  capture as a CUDA graph.
* The fixed-round ``prng.gamma`` equals the per-round loop it replaces (kept
  here as ``_gamma_loop``) over many keys and shapes, shapes below one
  included, wherever that loop stops within ``GAMMA_ROUNDS`` rounds; its
  draws pass a Kolmogorov–Smirnov test against ``scipy.stats.gamma``.
* The counters are 0-dim int32 tensors, and a run split into blocks of 6,
  2 + 4 or 3 x 2 sweeps draws the same bits across burn-in.
* An eager sweep counts one batched factorization a bucket
  (``posterior.FACTORS``) and every row of both sides once
  (``posterior.FACTOR_ROWS``).
"""
import itertools

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import gibbs, posterior, prng
from repro_torch.core.sweep_graph import tensors

HOST_READS = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu", "numpy")
HOST_WRITES = ("tensor", "as_tensor", "from_numpy")
TASK = dict(num_users=60, num_movies=30, nnz=700, noise_std=0.3, seed=4)


def _engine(name: str, **kw) -> BPMFEngine:
    kw = dict(dict(name=name, num_shards=2, num_partitions=2, K=4, burn_in=1,
                   bucket_pads=(8, 32, 128), keep_factor_samples=2), **kw)
    cfg = BPMFConfig().replace(**kw)
    engine = BPMFEngine(cfg, device="cpu")
    engine.prepare(load_dataset("synthetic", **TASK))
    return engine


def _carry(engine):
    b = engine.backend
    return b.init_state(engine._k_init), b.init_pred(), b.init_accum()


@pytest.mark.parametrize("name", ["sequential", "ring", "posterior_merge"])
def test_sweep_block_reads_nothing_from_the_host(monkeypatch, name):
    engine = _engine(name)
    carry = _carry(engine)

    def refuse(what):
        def raise_(*args, **kwargs):
            raise AssertionError(f"{what} inside a sweep block")
        return raise_

    with monkeypatch.context() as mp:
        for attr in HOST_READS:
            mp.setattr(torch.Tensor, attr, refuse(f"Tensor.{attr}"))
        for attr in HOST_WRITES:
            mp.setattr(torch, attr, refuse(f"torch.{attr}"))
        out = engine.backend.sweep_block(engine._k_run, *carry, 3)
    rows = out[3]
    assert rows.shape == (3, 4)
    np.testing.assert_array_equal(rows[:, 2].numpy(), [1.0, 2.0, 3.0])
    assert not rows[:, 3].any() and torch.isfinite(rows).all()


def _gamma_loop(k: torch.Tensor, a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The per-round loop ``prng.gamma`` replaces: rounds until every entry has a draw.

    Returns the draws and the number of rounds it took.
    """
    a = a.to(torch.float32)
    shape = a.shape
    a = a.reshape(-1)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    k_rounds, k_boost = prng.split(k)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    for r in itertools.count():
        k_x, k_u = prng.split(prng.fold_in(k_rounds, r))
        x = prng.normal(k_x, (8, a.numel()))
        u = prng.uniform(k_u, (8, a.numel()))
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        first = ok.to(torch.int32).argmax(dim=0, keepdim=True)
        draw = (d * v).gather(0, first)[0]
        found = ok.any(dim=0)
        out = torch.where(found & ~done, draw, out)
        done = done | found
        if bool(done.all()):
            break
    u_boost = prng.uniform(k_boost, (a.numel(),))
    out = torch.where(boost, out * u_boost ** (1.0 / a), out)
    return out.reshape(shape), r + 1


def test_fixed_round_gamma_equals_the_loop():
    rng = np.random.default_rng(0)
    compared = 0
    for seed in range(200):
        shape = [(1,), (7,), (32,), (3, 5), (128,)][seed % 5]
        a = torch.from_numpy(rng.uniform(0.05, 40.0, shape).astype(np.float32))
        a.view(-1)[0] = 0.3  # a shape below one, boosted
        key = prng.fold_in(prng.key(seed), 11)
        want, rounds = _gamma_loop(key, a)
        if rounds > prng.GAMMA_ROUNDS:
            continue
        got = prng.gamma(key, a)
        assert got.dtype == torch.float32 and got.shape == a.shape
        assert torch.equal(got, want), f"seed {seed}"
        compared += 1
    assert compared == 200


def test_fixed_round_gamma_fits_scipy():
    n = 4000
    for i, shape in enumerate((0.4, 1.0, 2.5, 16.0, 64.5)):
        draws = prng.gamma(prng.key(100 + i), torch.full((n,), shape))
        assert torch.isfinite(draws).all() and (draws > 0).all()
        p = stats.kstest(draws.numpy(), stats.gamma(shape).cdf).pvalue
        assert p > 1e-3, f"shape {shape}: KS p-value {p:.2e}"


def test_a_gamma_entry_that_no_round_accepts_is_nan():
    """With every proposal rejected the draw is NaN, not a silent 0."""
    a = torch.tensor([2.0, 3.0])
    key = prng.key(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prng, "uniform", lambda k, shape, lo=0.0, hi=1.0: torch.ones(shape))
        assert torch.isnan(prng.gamma(key, a)).all()


@pytest.mark.parametrize("name", ["sequential", "posterior_merge"])
def test_counters_are_device_ints_and_blocks_split_freely(name):
    engine = _engine(name, keep_factor_samples=3, burn_in=3)
    runs = {}
    for split in ((6,), (2, 4), (2, 2, 2)):
        carry = _carry(engine)
        rows = []
        for n in split:
            *carry, r = engine.backend.sweep_block(engine._k_run, *carry, n)
            rows.append(r)
        runs[split] = (tensors(tuple(carry)), torch.cat(rows))
    state, pred, accum = carry
    states = state if isinstance(state, tuple) else (state,)
    preds = pred if isinstance(pred, tuple) else (pred,)
    accums = accum.chains if hasattr(accum, "chains") else (accum,)
    counters = [s.sweep for s in states] + [p.num_samples for p in preds]
    counters += [c for a in accums for c in (a.count, a.filled)]
    for c in counters:
        assert c.dtype == torch.int32 and c.dim() == 0
    assert [int(s.sweep) for s in states] == [6] * len(states)
    assert [int(p.num_samples) for p in preds] == [3] * len(preds)  # sweeps 4-6 past burn-in 3
    assert [(int(a.count), int(a.filled)) for a in accums] == [(3, 3)] * len(accums)
    want_t, want_rows = runs[(6,)]
    assert len(want_t) > 10
    if name == "sequential":  # the core's eager block draws the backend's bits
        b = engine.backend
        *carry, rows = gibbs.gibbs_sweep_block(engine._k_run, *_carry(engine), b.data, b.core_cfg, 6, b.prior)
        runs["gibbs_sweep_block"] = (tensors(tuple(carry)), rows)
    for split, (got_t, got_rows) in runs.items():
        assert torch.equal(got_rows, want_rows), split
        for x, y in zip(got_t, want_t):
            assert torch.equal(x, y), split


def test_an_eager_sweep_factors_each_bucket_once_and_every_row_once():
    engine = _engine("sequential")
    data = engine.backend.data
    before = posterior.FACTORS, posterior.FACTOR_ROWS
    engine.backend.sweep_block(engine._k_run, *_carry(engine), 1)
    buckets = len(data.users.buckets) + len(data.movies.buckets)
    assert buckets > 2
    assert posterior.FACTORS - before[0] == buckets
    assert posterior.FACTOR_ROWS - before[1] == data.num_users + data.num_movies
