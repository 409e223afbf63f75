"""The port's ``pipeline_blocks`` queue: tests/test_pipeline.py's checks, at small shapes.

At any depth the engine dispatches the same blocks in the same order on the
same carries, so samples, metric history, checkpoint cadence and exported
artifacts are bit for bit the depth-1 loop's on every backend; so are runs
resumed from a checkpoint taken mid-pipeline, runs with
``donate_blocks="off"``, and ``save()`` calls made while blocks are in
flight. One metrics read per block, counted in ``host_metric_bytes`` (four
float32 columns per sweep: the reference's three and the ``bad`` flag)
and waited on in ``host_blocked_s``. With the gamma seam filled by JAX's
draw, the port at depth 2 matches the reference engine at depth 2 within
tests/test_torch_engine.py's bands (1e-4 on the RMSEs, 1e-3 on U and V).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bpmf as jbpmf
from repro_torch import convert
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import prng
from repro_torch.serve.artifact import load_artifact

ARRAY_KEYS = ("U_mean", "V_mean", "U_samples", "V_samples")
TASK = dict(num_users=60, num_movies=30, nnz=700, noise_std=0.3)


def _cfg(**kw) -> BPMFConfig:
    base = dict(K=4, num_sweeps=6, burn_in=2, sweeps_per_block=2, bucket_pads=(8, 32, 128),
                keep_factor_samples=3, num_shards=2, num_partitions=2)
    base.update(kw)
    return BPMFConfig().replace(**base)


def _coo(seed: int = 3):
    return load_dataset("synthetic", **TASK, seed=seed)


def _history(engine) -> list[tuple]:
    return [tuple(m) for m in engine.history]


def _artifact_equal(a, b, msg=""):
    (meta_a, arrs_a), (meta_b, arrs_b) = a, b
    assert meta_a == meta_b, msg
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(arrs_a[k], arrs_b[k], err_msg=f"{msg}:{k}")


@pytest.mark.parametrize("name", ["sequential", "ring", "posterior_merge"])
def test_pipeline_depths_bitwise_identical(tmp_path, name):
    coo = _coo()
    outs = {}
    for depth in (1, 2, 4):
        e = BPMFEngine(_cfg(name=name, pipeline_blocks=depth, sweeps_per_block=1), device="cpu").fit(coo)
        art = load_artifact(e.export(str(tmp_path / f"{name}-{depth}")))
        outs[depth] = (e.factors(), _history(e), art)
    (U0, V0), hist0, art0 = outs[1]
    assert [int(m[2]) for m in hist0] == list(range(1, 7))
    for depth in (2, 4):
        (U, V), hist, art = outs[depth]
        np.testing.assert_array_equal(U, U0, err_msg=f"{name}@d{depth}")
        np.testing.assert_array_equal(V, V0, err_msg=f"{name}@d{depth}")
        assert hist == hist0, f"{name}@d{depth}: history diverged"
        _artifact_equal(art, art0, msg=f"{name}@d{depth}")


def test_donation_off_bitwise_identical():
    coo = _coo(seed=5)
    on = BPMFEngine(_cfg(name="ring", pipeline_blocks=2, donate_blocks="on"), device="cpu").fit(coo)
    off = BPMFEngine(_cfg(name="ring", pipeline_blocks=2, donate_blocks="off"), device="cpu").fit(coo)
    for a, b in zip(on.factors(), off.factors()):
        np.testing.assert_array_equal(a, b)
    assert _history(on) == _history(off)


def test_checkpoint_cadence_depth_invariant(tmp_path):
    coo = _coo(seed=6)
    cadences = {}
    for depth in (1, 2, 4):
        cfg = _cfg(pipeline_blocks=depth, num_sweeps=8, sweeps_per_block=1, checkpoint_every=3,
                   checkpoint_dir=str(tmp_path / f"d{depth}"), keep_checkpoints=99)
        engine = BPMFEngine(cfg, device="cpu")
        yielded = list(engine.sample(coo))
        assert [int(m.sweep) for m in yielded] == list(range(1, 9))
        assert yielded == engine.history
        cadences[depth] = (engine._manager().all_steps(), _history(engine))
    steps0, hist0 = cadences[1]
    assert steps0 == [3, 6]
    for depth, (steps, hist) in cadences.items():
        assert steps == steps0 and hist == hist0, depth


def test_mid_pipeline_interruption_resumes_bitwise(tmp_path):
    coo = _coo(seed=5)
    cfg = _cfg(name="ring", num_sweeps=8, sweeps_per_block=3, pipeline_blocks=2,
               checkpoint_every=4, checkpoint_dir=str(tmp_path / "ckpt"))
    full = BPMFEngine(cfg, device="cpu").fit(coo)
    full_art = load_artifact(full.export(str(tmp_path / "full")))
    sync = BPMFEngine(cfg.replace(pipeline_blocks=1, checkpoint_dir=None, checkpoint_every=0),
                      device="cpu").fit(coo)
    np.testing.assert_array_equal(full.factors()[0], sync.factors()[0])

    # an interrupted run: the iterator abandoned with blocks in flight
    cut = BPMFEngine(cfg.replace(checkpoint_dir=str(tmp_path / "cut")), device="cpu")
    it = cut.sample(coo)
    [next(it) for _ in range(5)]
    del it
    resumed = BPMFEngine(cfg.replace(checkpoint_dir=str(tmp_path / "cut")), device="cpu")
    assert resumed.restore(coo, step=4) == 4  # 4 % 3 != 0: mid-block sweep
    resumed.fit()
    _artifact_equal(load_artifact(resumed.export(str(tmp_path / "resumed"))), full_art, "resume")
    for a, b in zip(resumed.factors(), full.factors()):
        np.testing.assert_array_equal(a, b)
    assert _history(resumed) == _history(full)


def test_save_while_blocks_in_flight_drains(tmp_path):
    coo = _coo(seed=7)
    cfg = _cfg(num_sweeps=10, sweeps_per_block=1, pipeline_blocks=4, checkpoint_dir=str(tmp_path / "ckpt"))
    engine = BPMFEngine(cfg, device="cpu")
    it = engine.sample(coo)
    seen = [next(it) for _ in range(3)]
    assert engine._inflight  # blocks in flight at the pause
    step = engine.save()
    assert not engine._inflight
    assert step == engine.num_sweeps_done == len(engine.history)
    seen.extend(it)
    assert [int(m.sweep) for m in seen] == list(range(1, 11))
    assert seen == engine.history
    ref = BPMFEngine(_cfg(num_sweeps=10, sweeps_per_block=1), device="cpu").fit(coo)
    assert _history(engine) == _history(ref)
    np.testing.assert_array_equal(engine.factors()[0], ref.factors()[0])
    restored = BPMFEngine(cfg, device="cpu")
    assert restored.restore(coo) == step
    assert _history(restored) == _history(engine)[:step]


def test_one_metrics_read_per_block_and_blocked_time(monkeypatch):
    coo = _coo(seed=2)
    for depth in (1, 4):
        engine = BPMFEngine(_cfg(pipeline_blocks=depth, num_sweeps=6), device="cpu")
        reads = []
        numpy = torch.Tensor.numpy
        monkeypatch.setattr(torch.Tensor, "numpy", lambda t, *a, **k: reads.append(t.shape) or numpy(t, *a, **k))
        engine.fit(coo)
        monkeypatch.undo()
        assert reads == [(2, 4)] * 3  # three blocks of two sweeps, one read each
        assert engine.host_metric_bytes == 6 * 4 * 4
        assert engine.host_blocked_s >= 0.0


def test_a_non_finite_hyper_draw_raises(monkeypatch):
    """A gamma entry with no accepted proposal makes the draw NaN; the drain raises on its flag."""
    engine = BPMFEngine(_cfg(num_sweeps=2), device="cpu")
    monkeypatch.setattr(prng, "gamma", lambda k, a: torch.full_like(a, float("nan")))
    with pytest.raises(FloatingPointError, match=r"sweeps \[1, 2\]"):
        engine.fit(_coo(seed=2))


def _jax_gamma(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    k = jax.random.wrap_key_data(jnp.asarray(convert.key_to_data(key)))
    return torch.from_numpy(np.array(jax.random.gamma(k, jnp.asarray(a.numpy()))))


def test_matches_the_reference_at_depth_two(monkeypatch):
    kw = dict(K=6, num_sweeps=6, burn_in=2, sweeps_per_block=2, pipeline_blocks=2,
              bucket_pads=(8, 32, 128), keep_factor_samples=3)
    task = dict(TASK, seed=3)
    ref = jbpmf.BPMFEngine(jbpmf.BPMFConfig().replace(**kw)).fit(jbpmf.load_dataset("synthetic", **task))
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    port = BPMFEngine(BPMFConfig().replace(**kw), device="cpu").fit(load_dataset("synthetic", **task))
    np.testing.assert_allclose(np.array(_history(port)), np.array(_history(ref)), rtol=0, atol=1e-4)
    for a, b in zip(port.factors(), ref.factors()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
