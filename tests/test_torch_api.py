"""The rest of the JAX package's public API in the port, name by name against the reference.

* ``gibbs.gibbs_sweep`` equals the first row of the port's own
  ``gibbs_sweep_block(..., 1)`` bit for bit, and the reference's one sweep
  within the engine bands (gamma seam filled by JAX's draw); the legacy
  ``gibbs.run`` (through ``backends.run_sequential_prepared``) draws the
  engine's samples bit for bit and the reference's ``run`` within the bands;
* ``Backend.sweep`` of all five backends equals a block of one sweep bit
  for bit and leaves a captured graph's buffers alone; ``Backend.test_vals``
  equals the reference backend's on the same ratings;
* ``RatingsCOO.transpose``, ``BPMFState.K``, ``Bucket.mask`` and the
  ``utils`` functions (``Timer``, ``timeit``, ``block_until_ready``,
  ``tree_size_bytes``, ``tree_num_params``, ``chunked``, ``cpu_count``,
  ``cast_floating``) against the reference's on the same inputs.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bpmf as jbpmf
from repro import utils as jutils
from repro.core import gibbs as jgibbs
from repro.core import types as jtypes
from repro.core.prediction import PredictionState as JPredictionState
from repro.data.sparse import RatingsCOO as JRatingsCOO
from repro.data.sparse import build_bpmf_data as j_build
from repro_torch import convert, utils
from repro_torch.bpmf import BPMFConfig, BPMFEngine, available_backends, load_dataset
from repro_torch.core import gibbs, posterior, prng
from repro_torch.core.prediction import PredictionState
from repro_torch.core.types import BPMFConfig as CoreConfig
from repro_torch.core.types import BPMFState, Bucket, HyperParams, PosteriorAccum
from repro_torch.data.sparse import RatingsCOO

from test_torch_engine import _jax_gamma

PADS = (8, 32, 128)
TASK = dict(num_users=150, num_movies=80, nnz=4000, noise_std=0.3, seed=7)
BACKENDS = ("sequential", "ring", "ring_async", "allgather", "posterior_merge")
SMALL = dict(K=8, num_sweeps=3, burn_in=1, bucket_pads=PADS, num_shards=2, num_partitions=2)


def _jdata_and_cfg(num_sweeps: int = 3):
    coo = jbpmf.load_dataset("synthetic", **TASK)
    jdata = j_build(JRatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies), pads=PADS)
    jcfg = jtypes.BPMFConfig(K=8, num_sweeps=num_sweeps, burn_in=1, bucket_pads=PADS, gram_impl="xla")
    cfg = CoreConfig(K=8, num_sweeps=num_sweeps, burn_in=1)
    return jdata, jcfg, convert.data_from_tree(dataclasses.asdict(jdata)), cfg


# ---------- gibbs_sweep and the legacy run ----------


def test_gibbs_sweep_equals_the_block_path_and_the_reference(monkeypatch):
    jdata, jcfg, data, cfg = _jdata_and_cfg()
    data = posterior.plan_data(data, cfg)
    key = prng.key(3)
    state = gibbs.init_state(prng.fold_in(key, 1), data.num_users, data.num_movies, cfg)
    pred = PredictionState.init(data.test.rows.shape[0])
    accum = PosteriorAccum.init(data.num_users, data.num_movies, cfg.K, 0)
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    s1, p1, m1 = gibbs.gibbs_sweep(key, state, pred, data, cfg)
    s2, p2, _, rows = gibbs.gibbs_sweep_block(key, state, pred, accum, data, cfg, 1)
    assert isinstance(m1, gibbs.SweepMetrics) and list(m1) == rows[0, :3].tolist()
    for a, b in ((s1.U, s2.U), (s1.V, s2.V), (p1.sum_pred, p2.sum_pred), (s1.hyper_U.Lam, s2.hyper_U.Lam)):
        assert torch.equal(a, b)
    jkey = jax.random.key(3)
    jstate = jgibbs.init_state(jax.random.fold_in(jkey, 1), jdata.num_users, jdata.num_movies, jcfg)
    js, _, jm = jgibbs.gibbs_sweep(jkey, jstate, JPredictionState.init(jdata.test.rows.shape[0]), jdata, jcfg)
    np.testing.assert_allclose(list(m1), [float(v) for v in jm], rtol=0, atol=1e-4)
    np.testing.assert_allclose(s1.U.numpy(), np.asarray(js.U), rtol=0, atol=1e-3)
    np.testing.assert_allclose(s1.V.numpy(), np.asarray(js.V), rtol=0, atol=1e-3)


def test_legacy_run_draws_the_engine_samples_and_the_references(monkeypatch):
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    engine = BPMFEngine(BPMFConfig().replace(K=8, num_sweeps=3, burn_in=1, bucket_pads=PADS), device="cpu")
    engine.fit(load_dataset("synthetic", **TASK))
    seen = []
    state, pred, history = gibbs.run(prng.key(0), engine.backend.data, engine.backend.core_cfg,
                                     callback=lambda st, m: seen.append(m))
    assert history == seen == [gibbs.SweepMetrics(m.rmse_sample, m.rmse_avg, m.sweep) for m in engine.history]
    assert torch.equal(state.U, engine.state.U) and torch.equal(state.V, engine.state.V)
    assert int(pred.num_samples) == 2 and state.K == 8
    jdata, jcfg, data, cfg = _jdata_and_cfg()
    _, _, jhist = jgibbs.run(jax.random.key(5), jdata, jcfg)
    _, _, hist = gibbs.run(prng.key(5), data, cfg)
    np.testing.assert_allclose(np.array(hist), np.array([[float(v) for v in m] for m in jhist]), rtol=0, atol=1e-4)


# ---------- Backend.sweep and test_vals ----------


@pytest.fixture(scope="module")
def coo():
    return load_dataset("synthetic", num_users=60, num_movies=40, nnz=900, noise_std=0.3, seed=7)


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_sweep_equals_a_block_of_one(coo, name):
    assert name in available_backends()
    engine = BPMFEngine(BPMFConfig().replace(name=name, **SMALL), device="cpu")
    engine.prepare(coo)
    b = engine.backend
    state, pred = b.init_state(engine._k_init), b.init_pred()
    s1, p1, m1 = b.sweep(engine._k_run, state, pred)
    s2, p2, _, rows = b.sweep_block(engine._k_run, state, pred, b.init_accum(), 1)
    assert isinstance(m1, gibbs.SweepMetrics) and list(m1) == rows[0, :3].tolist() and m1.sweep == 1.0
    for a, c in zip(b.factors(s1), b.factors(s2)):
        np.testing.assert_array_equal(a, c)
    # the next sweep from the legacy one's output goes on as a block would
    _, _, m2 = b.sweep(engine._k_run, s1, p1)
    *_, rows2 = b.sweep_block(engine._k_run, s2, p2, b.init_accum(), 1)
    assert list(m2) == rows2[0, :3].tolist()


@pytest.mark.parametrize("name", ["sequential", "ring", "posterior_merge"])
def test_backend_test_vals_equal_the_references(coo, name):
    common = dict(name=name, K=8, bucket_pads=PADS, num_shards=1, num_partitions=2)
    engine = BPMFEngine(BPMFConfig().replace(**common), device="cpu")
    engine.prepare(coo)
    jengine = jbpmf.BPMFEngine(jbpmf.BPMFConfig().replace(**common))
    jengine.prepare(jbpmf.load_dataset("synthetic", num_users=60, num_movies=40, nnz=900, noise_std=0.3, seed=7))
    got, want = engine.backend.test_vals, np.asarray(jengine.backend.test_vals)
    assert got.dtype == torch.float32 and got.shape == (engine.backend.num_test,)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------- types, sparse ----------


def test_ratings_transpose_k_and_mask_match_the_reference(coo):
    jcoo = JRatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)
    t, jt = coo.transpose(), jcoo.transpose()
    for f in ("rows", "cols", "vals", "num_users", "num_movies"):
        np.testing.assert_array_equal(getattr(t, f), getattr(jt, f))
    assert isinstance(t, RatingsCOO) and t.transpose().rows is coo.rows
    state = BPMFState(U=torch.zeros(5, 7), V=torch.zeros(3, 7), hyper_U=HyperParams.init(7),
                      hyper_V=HyperParams.init(7), sweep=torch.zeros((), dtype=torch.int32))
    assert state.K == jtypes.BPMFState(jnp.zeros((5, 7)), jnp.zeros((3, 7)), jtypes.HyperParams.init(7),
                                       jtypes.HyperParams.init(7), jnp.int32(0)).K == 7
    rng = np.random.default_rng(0)
    nnz = np.array([0, 3, 8, 5], np.int32)
    arrays = (np.arange(4, dtype=np.int32), rng.integers(0, 9, (4, 8)).astype(np.int32),
              rng.normal(size=(4, 8)).astype(np.float32), nnz)
    mask = Bucket(*(torch.from_numpy(a) for a in arrays)).mask()
    jmask = jtypes.Bucket(*(jnp.asarray(a) for a in arrays)).mask()
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


# ---------- utils ----------


@dataclasses.dataclass(frozen=True)
class _Pair:
    a: object
    b: object


def _trees():
    rng = np.random.default_rng(1)
    x, y, z = rng.normal(size=(3, 4)).astype(np.float32), np.arange(6, dtype=np.int32), np.ones((2, 2, 5))
    port = {"x": torch.from_numpy(x), "rest": [torch.from_numpy(y), (z, _Pair(torch.from_numpy(x), 1.5))]}
    ref = {"x": jnp.asarray(x), "rest": [jnp.asarray(y), (z, jtypes.HyperParams(mu=jnp.asarray(x), Lam=1.5))]}
    return port, ref


def test_tree_sizes_match_the_reference():
    port, ref = _trees()
    assert utils.tree_size_bytes(port) == int(jutils.tree_size_bytes(ref)) == 48 + 24 + 160 + 48
    assert utils.tree_num_params(port) == jutils.tree_num_params(ref) == 12 + 6 + 20 + 12
    assert utils.block_until_ready(port) is port
    assert utils.tree_size_bytes(HyperParams.init(4)) == int(jutils.tree_size_bytes(jtypes.HyperParams.init(4)))


def test_cast_floating_matches_the_reference():
    port, ref = _trees()
    got, want = utils.cast_floating(port, torch.float16), jutils.cast_floating(ref, jnp.float16)
    assert got["x"].dtype == torch.float16 and got["rest"][0].dtype == torch.int32
    assert got["rest"][1][0].dtype == np.float16 and isinstance(got["rest"][1][1], _Pair)
    pairs = [(got["x"], want["x"]), (got["rest"][0], want["rest"][0]), (got["rest"][1][0], want["rest"][1][0]),
             (got["rest"][1][1].a, want["rest"][1][1].mu)]
    for a, b in pairs:
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert str(a.dtype) == str(np.asarray(b).dtype)
        np.testing.assert_array_equal(a, np.asarray(b))
    bf = utils.cast_floating(HyperParams.init(3), torch.bfloat16)
    assert isinstance(bf, HyperParams) and bf.Lam.dtype == torch.bfloat16


def test_timer_timeit_chunked_and_cpu_count_match_the_reference():
    with utils.Timer("x") as t, jutils.Timer("x") as jt:
        time.sleep(0.01)
    assert t.elapsed >= 0.01 and jt.elapsed >= 0.01
    calls = []

    def fn(v, scale=1.0):
        calls.append(v)
        return torch.full((2,), v * scale)

    assert utils.timeit(fn, 3.0, iters=4, warmup=1, scale=2.0) > 0 and len(calls) == 5
    assert list(utils.chunked(list(range(10)), 3)) == list(jutils.chunked(list(range(10)), 3))
    assert utils.cpu_count() == jutils.cpu_count() >= 1
    assert utils.device_line("cpu") == "cpu"
