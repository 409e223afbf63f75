"""The port's sampler core against the JAX package's, from one shared state.

A JAX state (two sweeps past init on the test_posterior_quality task) is
carried over with ``repro_torch.convert``; both packages then take the same
step with the same key. The only draw the packages make differently, the
Wishart diagonal's gamma, is filled with JAX's draw by monkeypatching
``repro_torch.core.prng.gamma``. Bands: 1e-5 for one hyper draw and one
half-sweep, 1e-4 for a full sweep. Observed on CPU: 1.5e-5 on Lam entries up
to 56 (2.7e-7 relative) and 9e-9 on mu for one hyper draw; 2.4e-7 on a
half-sweep; 3.6e-7 on U, V and 6e-8 on the RMSE after a full sweep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bpmf import load_dataset as j_load_dataset
from repro.core import gibbs as jgibbs
from repro.core import hyper as jhyper
from repro.core import posterior as jposterior
from repro.core.prediction import PredictionState as JPredictionState
from repro.core.types import BPMFConfig as JCoreConfig
from repro.data.sparse import build_bpmf_data as j_build
from repro_torch import convert
from repro_torch.core import gibbs, hyper, posterior, prng
from repro_torch.core.types import BPMFConfig, Bucket, BucketedSide, HyperParams

K = 8
PADS = (8, 32, 128)


def _jax_gamma(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """JAX's gamma draw for the port's key words: the parity tests' seam."""
    k = jax.random.wrap_key_data(jnp.asarray(convert.key_to_data(key)))
    return torch.from_numpy(np.array(jax.random.gamma(k, jnp.asarray(a.numpy()))))


@pytest.fixture
def jax_gamma(monkeypatch):
    monkeypatch.setattr(prng, "gamma", _jax_gamma)


@pytest.fixture(scope="module")
def shared():
    """(JAX data, JAX state after 2 sweeps, JAX key, port data)."""
    coo = j_load_dataset("synthetic", num_users=150, num_movies=80, nnz=4000, noise_std=0.3, seed=7)
    jdata = j_build(coo, pads=PADS, seed=0)
    jcfg = JCoreConfig(K=K, burn_in=3, bucket_pads=PADS, gram_impl="xla")
    key = jax.random.key(0)
    state = jgibbs.init_state(key, jdata.num_users, jdata.num_movies, jcfg)
    pred = JPredictionState.init(jdata.test.rows.shape[0])
    for _ in range(2):
        state, pred, _ = jgibbs.gibbs_sweep(key, state, pred, jdata, jcfg)
    tdata = convert.data_from_tree(dataclasses.asdict(jdata))
    return jdata, state, key, tdata, jcfg


def _np(x):
    return np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_sample_hyper_matches_jax(shared, jax_gamma):
    _, jstate, key, _, jcfg = shared
    k = jax.random.fold_in(key, 11)
    tk = convert.key_from_data(jax.random.key_data(k))
    for X in (jstate.U, jstate.V):
        want = jhyper.sample_hyper(k, X, jcfg.prior())
        got = hyper.sample_hyper(tk, torch.from_numpy(np.array(X)), BPMFConfig(K=K).prior())
        np.testing.assert_allclose(got.Lam.numpy(), _np(want.Lam), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.mu.numpy(), _np(want.mu), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", ["movies", "users"])
def test_update_side_matches_jax(shared, side):
    jdata, jstate, key, tdata, jcfg = shared
    k = jax.random.fold_in(key, 5)
    hyp = jhyper.sample_hyper(k, jstate.V, jcfg.prior())
    X_side, X_opp = (jstate.V, jstate.U) if side == "movies" else (jstate.U, jstate.V)
    want = jposterior.update_side(k, X_side, X_opp, getattr(jdata, side), hyp, 2.0, jnp.float32, "xla")
    got = posterior.update_side(
        convert.key_from_data(jax.random.key_data(k)),
        torch.from_numpy(np.array(X_side)), torch.from_numpy(np.array(X_opp)),
        getattr(tdata, side),
        HyperParams(mu=torch.from_numpy(np.array(hyp.mu)), Lam=torch.from_numpy(np.array(hyp.Lam))),
        2.0,
    )
    _close(got, want, 1e-5)


def test_full_sweep_matches_jax(shared, jax_gamma):
    jdata, jstate, key, tdata, jcfg = shared
    jpred = JPredictionState.init(jdata.test.rows.shape[0])
    want_state, _, want_m = jgibbs.gibbs_sweep(key, jstate, jpred, jdata, jcfg)
    tstate = convert.state_from_tree(dataclasses.asdict(jstate))
    tpred = convert.prediction_from_tree(dataclasses.asdict(jpred))
    got_state, _, row = gibbs._sweep_body(
        convert.key_from_data(jax.random.key_data(key)), tstate, tpred, tdata,
        BPMFConfig(K=K, burn_in=3),
    )
    assert got_state.sweep == int(want_state.sweep)
    for f in ("U", "V"):
        _close(getattr(got_state, f), getattr(want_state, f), 1e-4)
    for h in ("hyper_U", "hyper_V"):
        np.testing.assert_allclose(
            getattr(got_state, h).Lam.numpy(), _np(getattr(want_state, h).Lam), rtol=1e-4, atol=1e-4
        )
        _close(getattr(got_state, h).mu, getattr(want_state, h).mu, 1e-4)
    _close(row[:2], [want_m.rmse_sample, want_m.rmse_avg], 1e-4)


def test_bucket_update_matches_naive_item_update(shared):
    """The bucketed update equals the textbook one-item update, item by item."""
    _, jstate, key, tdata, _ = shared
    U = torch.from_numpy(np.array(jstate.U))
    V = torch.from_numpy(np.array(jstate.V))
    hyp = HyperParams(mu=torch.zeros(K), Lam=2.0 * torch.eye(K))
    tk = prng.key(4)
    new = posterior.update_side(tk, V, U, tdata.movies, hyp, 2.0)
    for b in tdata.movies.buckets[:2]:
        for r in range(min(b.B, 3)):
            n = int(b.nnz[r])
            want = posterior.update_item_naive(
                tk, int(b.item_ids[r]), b.nbr[r, :n], b.val[r, :n], U, hyp, 2.0
            )
            np.testing.assert_allclose(new[int(b.item_ids[r])].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_padding_rows_are_dropped_not_written_to_the_last_item():
    """item_ids == -1 rows must not land on row -1 (the last real item)."""
    X_opp = torch.randn(6, 4)
    bucket = Bucket(
        item_ids=torch.tensor([0, -1], dtype=torch.int32),
        nbr=torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
        val=torch.tensor([[0.5, -0.5], [1.0, 1.0]]),
        nnz=torch.tensor([2, 2], dtype=torch.int32),
    )
    X_side = torch.full((3, 4), 7.0)
    out = posterior.update_side(
        prng.key(0), X_side, X_opp, BucketedSide((bucket,), 3), HyperParams.init(4), 2.0
    )
    assert out.shape == X_side.shape
    assert not torch.equal(out[0], X_side[0])
    np.testing.assert_array_equal(out[1:].numpy(), X_side[1:].numpy())
    np.testing.assert_array_equal(X_side.numpy(), np.full((3, 4), 7.0, np.float32))
