"""The port's checkpoints and artifacts against the JAX package's, in both directions.

At test_engine.py's small shapes (90 x 45, nnz 1000, K=6, burn-in 1, pads
(8, 32, 128)), for ``sequential`` and a 2-chain ``posterior_merge`` in
this process and for a 2-shard ``ring`` in one subprocess with two host
devices:

* a checkpoint ``repro`` writes at sweep 3 restores in the port, and the
  port's re-save of it is the reference's files byte for byte (every
  state, pred, posterior and history leaf, and the manifest);
* a checkpoint the port writes restores in ``repro``, whose re-save is the
  port's files byte for byte;
* with the gamma seam filled by JAX's draw, the port continues the
  reference's checkpoint to sweep 6 within the engine parity test's band
  (1e-4 on the RMSEs, 1e-3 on U and V) of the reference's uninterrupted run;
* an artifact ``repro`` exports serves from the port (1e-6, equal top-k
  ids), and one the port exports loads in ``repro``.

Then the port alone: save / restore in a fresh engine resumes bit for bit
(a resumed ``posterior_merge`` run exports the uninterrupted run's merged
artifact), ``checkpoint_every`` auto-saves, retention, the pre-serving
checkpoint fallback (also per chain), sharded leaves written by a multi-process JAX job, and the typed
errors of damaged checkpoints and artifacts.
"""
import dataclasses
import filecmp
import json
import os
import shutil
import time

import numpy as np
import pytest

import repro.bpmf as jbpmf
from conftest import run_with_devices
from repro.checkpoint.checkpoint import _shard_filename
from repro.serve import PosteriorPredictor as JPredictor
from repro.serve import load_artifact as j_load_artifact
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    CheckpointSchemaError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core import prng
from repro_torch.serve import (
    ARRAY_KEYS,
    SERVE_ARTIFACT_VERSION,
    ArtifactCorruptError,
    ArtifactMeta,
    ArtifactNotFoundError,
    ArtifactSchemaError,
    PosteriorPredictor,
    load_artifact,
    save_artifact,
)

from test_torch_engine import _jax_gamma

CFG = dict(K=6, burn_in=1, bucket_pads=(8, 32, 128), num_sweeps=6)
TASK = dict(num_users=90, num_movies=45, nnz=1000, noise_std=0.3, seed=5)


def _cfg(name="sequential", **kw) -> BPMFConfig:
    layouts = {"sequential": {}, "posterior_merge": {"num_partitions": 2}}
    return BPMFConfig().replace(name=name, **layouts.get(name, {"num_shards": 2}), **{**CFG, **kw})


def _coo():
    return load_dataset("synthetic", **TASK)


def _hist(engine) -> np.ndarray:
    return np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in engine.history])


def _assert_same_files(a: str, b: str) -> None:
    """Two step directories hold the same files, byte for byte."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _resave_copy(src: str, dst: str, engine_for) -> None:
    """Copy checkpoint directory ``src`` to ``dst``, restore step 3 there with
    ``engine_for(dst)`` and save it again over itself; ``dst``'s step 3 must
    then be ``src``'s files byte for byte."""
    shutil.copytree(src, dst)
    engine = engine_for(dst)
    assert engine.restore(step=3) == 3
    engine.save()
    engine._manager().wait()
    _assert_same_files(os.path.join(src, "step_00000003"), os.path.join(dst, "step_00000003"))


def _port_to_step(cfg: BPMFConfig, step: int) -> BPMFEngine:
    """A port engine run to ``step`` and saved there (written synchronously)."""
    engine = BPMFEngine(cfg.replace(num_sweeps=step), device="cpu").fit(_coo())
    engine.save()
    engine._manager().wait()
    return engine


# ---------- sequential, both packages in this process ----------


@pytest.fixture(scope="module")
def jax_seq(tmp_path_factory):
    """The reference's uninterrupted 6-sweep run, saving at 3 and 6, and its artifact."""
    d = tmp_path_factory.mktemp("jax_seq")
    cfg = jbpmf.BPMFConfig().replace(**CFG, checkpoint_dir=str(d / "ckpt"), checkpoint_every=3)
    engine = jbpmf.BPMFEngine(cfg).fit(jbpmf.load_dataset("synthetic", **TASK))
    engine._manager().wait()
    return engine, str(d / "ckpt"), engine.export(str(d / "art"))


def test_reference_checkpoint_restores_in_port_leaf_for_leaf(jax_seq, tmp_path):
    ref, ckpt, _ = jax_seq
    port = BPMFEngine(_cfg(checkpoint_dir=ckpt), device="cpu")
    assert port.restore(_coo(), step=3) == 3
    np.testing.assert_array_equal(_hist(port), _hist(ref)[:3])
    _resave_copy(ckpt, str(tmp_path / "port"),
                 lambda d: BPMFEngine(_cfg(checkpoint_dir=d), device="cpu").prepare(_coo()))


def test_port_checkpoint_restores_in_reference(tmp_path):
    port = _port_to_step(_cfg(checkpoint_dir=str(tmp_path / "port")), 3)
    ref = jbpmf.BPMFEngine(jbpmf.BPMFConfig().replace(**CFG, checkpoint_dir=str(tmp_path / "port")))
    assert ref.restore(jbpmf.load_dataset("synthetic", **TASK)) == 3
    np.testing.assert_array_equal(_hist(ref), _hist(port))
    jcoo = jbpmf.load_dataset("synthetic", **TASK)
    _resave_copy(str(tmp_path / "port"), str(tmp_path / "ref"), lambda d: jbpmf.BPMFEngine(
        jbpmf.BPMFConfig().replace(**CFG, checkpoint_dir=d)).prepare(jcoo))


def test_port_continues_reference_checkpoint_with_gamma_seam(jax_seq, monkeypatch):
    ref, ckpt, _ = jax_seq
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    port = BPMFEngine(_cfg(checkpoint_dir=ckpt), device="cpu")
    port.restore(_coo(), step=3)
    port.fit()
    assert port.num_sweeps_done == 6
    np.testing.assert_allclose(_hist(port), _hist(ref), rtol=0, atol=1e-4)
    for got, want in zip(port.factors(), ref.factors()):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)


# ---------- posterior_merge, P = 2, both packages in this process ----------


def _jmerge_cfg(**kw):
    return jbpmf.BPMFConfig().replace(name="posterior_merge", num_partitions=2, **CFG, **kw)


@pytest.fixture(scope="module")
def jax_merge(tmp_path_factory):
    """The reference's 2-chain run, saving at 3 and 6."""
    d = tmp_path_factory.mktemp("jax_merge")
    engine = jbpmf.BPMFEngine(_jmerge_cfg(checkpoint_dir=str(d / "ckpt"), checkpoint_every=3)).fit(
        jbpmf.load_dataset("synthetic", **TASK))
    engine._manager().wait()
    return engine, str(d / "ckpt")


def test_merge_reference_checkpoint_restores_in_port_leaf_for_leaf(jax_merge, tmp_path):
    ref, ckpt = jax_merge
    port = BPMFEngine(_cfg("posterior_merge", checkpoint_dir=ckpt), device="cpu")
    assert port.restore(_coo(), step=3) == 3
    np.testing.assert_array_equal(_hist(port), _hist(ref)[:3])
    with open(os.path.join(ckpt, "step_00000003", "manifest.json")) as f:
        names = [leaf["name"] for leaf in json.load(f)["leaves"]]
    assert names == [name for name, _ in port.backend.checkpoint_leaves()]
    assert "posterior__chain_001__V_sum" in names and "state__1__.hyper_V__.Lam" in names
    _resave_copy(ckpt, str(tmp_path / "port"), lambda d: BPMFEngine(
        _cfg("posterior_merge", checkpoint_dir=d), device="cpu").prepare(_coo()))


def test_merge_port_checkpoint_restores_in_reference(tmp_path):
    port = _port_to_step(_cfg("posterior_merge", checkpoint_dir=str(tmp_path / "port")), 3)
    jcoo = jbpmf.load_dataset("synthetic", **TASK)
    ref = jbpmf.BPMFEngine(_jmerge_cfg(checkpoint_dir=str(tmp_path / "port")))
    assert ref.restore(jcoo) == 3
    np.testing.assert_array_equal(_hist(ref), _hist(port))
    for got, want in zip(ref.state, port.state):
        np.testing.assert_array_equal(np.asarray(got.U), want.U.numpy())
    _resave_copy(str(tmp_path / "port"), str(tmp_path / "ref"),
                 lambda d: jbpmf.BPMFEngine(_jmerge_cfg(checkpoint_dir=d)).prepare(jcoo))


def test_merge_checkpoint_every_resume_and_pre_serving_fallback(tmp_path):
    """Auto-saves, ``fit(resume=True)`` and a checkpoint without the posterior subtree."""
    cfg = _cfg("posterior_merge", num_sweeps=4, sweeps_per_block=3, checkpoint_dir=str(tmp_path / "ckpt"),
               checkpoint_every=2, async_checkpoint_writes=False)
    full = BPMFEngine(cfg, device="cpu").fit(_coo())
    assert full._manager().all_steps() == [2, 4]
    again = BPMFEngine(cfg, device="cpu").prepare(_coo())
    again.fit(resume=True)
    assert again.num_sweeps_done == 4 and again.history == full.history

    step_dir = tmp_path / "ckpt" / "step_00000002"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    manifest["leaves"] = [leaf for leaf in manifest["leaves"] if not leaf["name"].startswith("posterior")]
    (step_dir / "manifest.json").write_text(json.dumps(manifest))
    resumed = BPMFEngine(cfg.replace(checkpoint_every=0), device="cpu")
    assert resumed.restore(_coo(), step=2) == 2
    resumed.fit()
    assert resumed.history == full.history  # the samples do not depend on the accumulator
    meta, arrays = load_artifact(resumed.export(str(tmp_path / "art")))
    assert meta.num_mean_samples == 2 and meta.backend == "posterior_merge"  # sweeps 3..4 only
    assert np.all(np.isfinite(arrays["U_mean"]))


# ---------- ring, S = 2: the reference runs in one subprocess with two host devices ----------


RING_CODE = """
import shutil
import numpy as np
import repro.bpmf as jbpmf
coo = jbpmf.load_dataset("synthetic", **{task})
cfg = jbpmf.BPMFConfig().replace(name="ring", num_shards=2, checkpoint_dir={ref_dir!r},
                                 checkpoint_every=3, **{cfg})
ref = jbpmf.BPMFEngine(cfg).fit(coo)
ref._manager().wait()
U, V = ref.factors()
hist = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in ref.history])
np.savez({out!r}, hist=hist, U=U, V=V)
shutil.copytree({port_dir!r}, {resave_dir!r})
back = jbpmf.BPMFEngine(cfg.replace(checkpoint_dir={resave_dir!r}))
assert back.restore(coo, step=3) == 3
back.save()
back._manager().wait()
"""


@pytest.mark.multidevice
def test_ring_checkpoints_cross_between_packages(tmp_path, monkeypatch):
    d = {k: str(tmp_path / k) for k in ("ref", "port", "resave", "port_resave")}
    port = _port_to_step(_cfg("ring", checkpoint_dir=d["port"]), 3)
    out = str(tmp_path / "ref.npz")
    run_with_devices(RING_CODE.format(task=TASK, cfg=CFG, out=out, ref_dir=d["ref"], port_dir=d["port"],
                                      resave_dir=d["resave"]), num_devices=2)
    want = np.load(out)
    # the reference read the port's ring checkpoint and wrote back the same files
    _assert_same_files(os.path.join(d["port"], "step_00000003"), os.path.join(d["resave"], "step_00000003"))
    assert np.load(os.path.join(d["port"], "step_00000003", "state__.U.npy")).shape == (
        2 * port.backend.data.users.cap, 6)

    # the port reads the reference's: its re-save is the same files, and it continues
    _resave_copy(d["ref"], d["port_resave"],
                 lambda p: BPMFEngine(_cfg("ring", checkpoint_dir=p), device="cpu").prepare(_coo()))
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    e = BPMFEngine(_cfg("ring", checkpoint_dir=d["ref"]), device="cpu")
    assert e.restore(_coo(), step=3) == 3
    e.fit()
    np.testing.assert_allclose(_hist(e), want["hist"], rtol=0, atol=1e-4)
    for got, w in zip(e.factors(), (want["U"], want["V"])):
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-3)


# ---------- artifacts, both directions ----------


def test_reference_artifact_serves_from_port(jax_seq):
    _, _, art = jax_seq
    ours = PosteriorPredictor.load(art, device="cpu")
    theirs = JPredictor.load(art)
    assert dataclasses.asdict(ours.meta) == dataclasses.asdict(theirs.meta)
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 90, 40), rng.integers(0, 45, 40)
    for got, want in zip(ours.predict(rows, cols, return_std=True), theirs.predict(rows, cols, return_std=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    users = np.arange(0, 90, 4)
    ids, vals = ours.top_k(users, 7)
    ids_j, vals_j = theirs.top_k(users, 7, sharded=False)
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    np.testing.assert_allclose(vals, np.asarray(vals_j), rtol=0, atol=1e-6)


def test_port_artifact_loads_in_reference(tmp_path):
    port = BPMFEngine(_cfg(keep_factor_samples=3), device="cpu").fit(_coo())
    path = port.export(str(tmp_path / "art"))
    meta, arrays = j_load_artifact(path)
    want_meta, want_arrays = port._artifact_payload()
    assert dataclasses.asdict(meta) == dataclasses.asdict(want_meta)
    assert (meta.num_mean_samples, meta.num_kept_samples) == (5, 3)
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(np.asarray(arrays[k]), want_arrays[k])
    with open(os.path.join(path, "step_00000000", "manifest.json")) as f:
        assert [leaf["name"] for leaf in json.load(f)["leaves"]] == sorted(ARRAY_KEYS)
    rows, cols = np.arange(10), np.arange(10) * 4
    np.testing.assert_allclose(port.predict(rows, cols), np.asarray(JPredictor.load(path).predict(rows, cols)),
                               rtol=0, atol=1e-6)


# ---------- the port's own round trip ----------


@pytest.mark.parametrize("name", ["sequential", "ring", "ring_async", "posterior_merge"])
def test_checkpoint_roundtrip_resumes_identically(tmp_path, name):
    """save() mid-run, restore() in a fresh engine: the metrics, factors and artifact are identical."""
    extra = {"pipeline_depth": 2} if name == "ring_async" else {}
    cfg = _cfg(name, sweeps_per_block=3, checkpoint_dir=str(tmp_path / "ckpt"), **extra)
    full = BPMFEngine(cfg, device="cpu").fit(_coo())

    interrupted = BPMFEngine(cfg, device="cpu")
    it = interrupted.sample(_coo())
    for _ in range(3):
        next(it)
    assert interrupted.save() == 3
    del interrupted, it

    resumed = BPMFEngine(cfg, device="cpu")
    assert resumed.restore(_coo()) == 3
    assert len(resumed.history) == 3  # the metric history travels with the checkpoint
    resumed.fit()
    assert resumed.history == full.history
    for got, want in zip(resumed.factors(), full.factors()):
        np.testing.assert_array_equal(got, want)
    m1, a1 = load_artifact(full.export(str(tmp_path / "full")))
    m2, a2 = load_artifact(resumed.export(str(tmp_path / "resumed")))
    assert m1 == m2
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)


def test_restore_waits_for_a_dropped_engines_write(tmp_path, monkeypatch):
    """A fresh engine's restore joins an async write that a dropped engine left in flight."""
    from repro_torch.checkpoint import manager

    def slow_save(*args):
        time.sleep(0.5)
        return save_checkpoint(*args)

    monkeypatch.setattr(manager, "save_checkpoint", slow_save)
    cfg = _cfg(num_sweeps=2, checkpoint_dir=str(tmp_path))
    engine = BPMFEngine(cfg, device="cpu").fit(_coo())
    engine.save()
    assert latest_step(str(tmp_path)) is None  # still being written
    want = engine.history
    del engine
    again = BPMFEngine(cfg, device="cpu")
    assert again.restore(_coo()) == 2 and again.history == want


def test_checkpoint_every_autosaves_and_keeps(tmp_path):
    cfg = _cfg(num_sweeps=8, sweeps_per_block=3, checkpoint_dir=str(tmp_path), checkpoint_every=2,
               keep_checkpoints=2)
    engine = BPMFEngine(cfg, device="cpu").fit(_coo())
    assert engine._manager().all_steps() == [6, 8]  # saved at 2, 4, 6, 8; two kept
    assert latest_step(str(tmp_path)) == 8
    again = BPMFEngine(cfg, device="cpu")
    again.prepare(_coo())
    again.fit(resume=True)  # picks up the final checkpoint, history included
    assert again.num_sweeps_done == 8 and again.history == engine.history
    with pytest.raises(ValueError, match="checkpoint_every"):
        _cfg(checkpoint_every=-1)
    with pytest.raises(ValueError, match="checkpoint_dir is not set"):
        BPMFEngine(_cfg(), device="cpu").fit(_coo()).save()


def test_manager_retention_sync_and_async(tmp_path):
    leaves = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": np.asarray(7, np.int32)}
    for async_writes in (True, False):
        m = CheckpointManager(str(tmp_path / str(async_writes)), keep=2, async_writes=async_writes)
        for s in (10, 20, 30, 40):
            m.save(s, leaves)
        assert m.all_steps() == [30, 40] and m.latest() == 40
        out = m.restore(["step", "w"])
        assert list(out) == ["step", "w"] and out["step"].dtype == np.int32 and out["step"].shape == ()
        np.testing.assert_array_equal(out["w"], leaves["w"])
        m.close()


def test_restore_pre_serving_checkpoint(tmp_path):
    """A checkpoint without the posterior subtree resumes with an empty accumulator."""
    cfg = _cfg(num_sweeps=4, sweeps_per_block=2, checkpoint_dir=str(tmp_path / "ckpt"))
    engine = BPMFEngine(cfg, device="cpu")
    it = engine.sample(_coo())
    for _ in range(2):
        next(it)
    engine.save()
    engine._manager().wait()
    step_dir = tmp_path / "ckpt" / "step_00000002"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    manifest["leaves"] = [leaf for leaf in manifest["leaves"] if not leaf["name"].startswith("posterior")]
    (step_dir / "manifest.json").write_text(json.dumps(manifest))
    del engine, it

    resumed = BPMFEngine(cfg, device="cpu")
    assert resumed.restore(_coo()) == 2
    resumed.fit()
    meta, arrays = load_artifact(resumed.export(str(tmp_path / "art")))
    assert meta.num_mean_samples == 2  # sweeps 3..4 only
    assert np.all(np.isfinite(arrays["U_mean"]))


def test_sharded_leaves_of_a_multiprocess_checkpoint_restore(tmp_path):
    """Leaves a multi-process JAX job writes as per-shard files reassemble on the host."""
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    step = tmp_path / "step_00000005"
    step.mkdir()
    for ranges in (((0, 3), (0, 4)), ((3, 6), (0, 4))):
        np.save(step / _shard_filename("w", ranges), w[tuple(slice(a, b) for a, b in ranges)])
    np.save(step / _shard_filename("n", ()), np.asarray(3, np.int32))
    leaves = [{"name": "w", "shape": [6, 4], "dtype": "float32", "sharded": True},
              {"name": "n", "shape": [], "dtype": "int32", "sharded": True}]
    (step / "manifest.json").write_text(json.dumps({"step": 5, "leaves": leaves}))
    (tmp_path / "LATEST").write_text("5")
    out = restore_checkpoint(str(tmp_path), ["w", "n"])
    np.testing.assert_array_equal(out["w"], w)
    assert out["n"] == 3 and out["n"].dtype == np.int32
    os.remove(step / _shard_filename("w", ((3, 6), (0, 4))))
    with pytest.raises(CheckpointCorruptError, match="gaps"):
        restore_checkpoint(str(tmp_path), ["w"])


# ---------- typed errors ----------


def _saved(tmp_path) -> str:
    save_checkpoint(str(tmp_path), 1, {"params__w": np.ones((4, 2), np.float32),
                                       "opt__mu": np.zeros(3, np.float32)})
    return str(tmp_path / "step_00000001")


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(16)


def _write(text):
    def write(path):
        with open(path, "w") as f:
            f.write(text)
    return write


@pytest.mark.parametrize("target,mutate,error,match", [
    ("params__w.npy", _truncate, CheckpointCorruptError, "params__w"),
    ("opt__mu.npy", os.remove, CheckpointCorruptError, "opt__mu"),
    ("manifest.json", _write("]]not json[["), CheckpointCorruptError, "manifest"),
    ("manifest.json", _write('{"step": 1}'), CheckpointCorruptError, "leaf table"),
    ("../LATEST", _write("not-a-step"), CheckpointCorruptError, "LATEST"),
    (None, None, CheckpointSchemaError, "missing leaves"),
])
def test_damaged_checkpoint_raises_typed(tmp_path, target, mutate, error, match):
    step = _saved(tmp_path)
    names = ["params__w", "opt__mu"]
    if mutate is None:
        names.append("extra")  # schema drift
    else:
        mutate(os.path.join(step, target))
    with pytest.raises(error, match=match):
        restore_checkpoint(str(tmp_path), names)
    assert issubclass(error, CheckpointError)


def test_missing_checkpoint_is_not_found(tmp_path):
    _saved(tmp_path)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), ["opt__mu"], step=9)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), ["opt__mu"])
    os.makedirs(tmp_path / "step_00000002.tmp-dead")  # a crashed save is never visible
    assert latest_step(str(tmp_path)) == 1
    engine = BPMFEngine(_cfg(checkpoint_dir=str(tmp_path / "none")), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        engine.restore(_coo())


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    engine = BPMFEngine(_cfg(num_sweeps=4, keep_factor_samples=3), device="cpu").fit(_coo())
    return engine.export(str(tmp_path_factory.mktemp("art") / "artifact"))


def _meta_edit(edit):
    def mutate(path):
        with open(path) as f:
            payload = json.load(f)
        edit(payload)
        with open(path, "w") as f:
            json.dump(payload, f)
    return mutate


@pytest.mark.parametrize("target,mutate,error,match", [
    ("artifact.json", _write("{not json"), ArtifactCorruptError, "unreadable"),
    ("artifact.json", _meta_edit(lambda p: p.update(version=SERVE_ARTIFACT_VERSION + 1)),
     ArtifactSchemaError, "version"),
    ("artifact.json", _meta_edit(lambda p: p.pop("mean_rating")), ArtifactSchemaError, "mean_rating"),
    ("step_00000000/U_mean.npy", _truncate, ArtifactCorruptError, "U_mean"),
    ("step_00000000/V_mean.npy", os.remove, ArtifactCorruptError, "V_mean"),
    ("step_00000000/U_mean.npy", lambda p: np.save(p, np.zeros((2, 2), np.float32)),
     ArtifactSchemaError, "U_mean"),
])
def test_damaged_artifact_raises_typed(port_artifact, tmp_path, target, mutate, error, match):
    broken = str(tmp_path / "broken")
    shutil.copytree(port_artifact, broken)
    mutate(os.path.join(broken, target))
    with pytest.raises(error, match=match):
        load_artifact(broken)
    with pytest.raises(ArtifactNotFoundError):
        load_artifact(str(tmp_path / "nope"))


def test_save_artifact_validates_payload(tmp_path):
    meta = ArtifactMeta(4, 3, 2, 0.0, 0.0, 1.0, 1, 0, "sequential", 1, 0)
    arrays = {"U_mean": np.zeros((4, 2), np.float32), "V_mean": np.zeros((3, 2), np.float32),
              "U_samples": np.zeros((0, 4, 2), np.float32), "V_samples": np.zeros((0, 3, 2), np.float32)}
    save_artifact(str(tmp_path / "ok"), meta, arrays)
    assert load_artifact(str(tmp_path / "ok"))[0] == meta
    with pytest.raises(ValueError, match="shape"):
        save_artifact(str(tmp_path / "bad"), meta, {**arrays, "U_mean": np.zeros((5, 2), np.float32)})
    with pytest.raises(ValueError, match="exactly"):
        save_artifact(str(tmp_path / "bad2"), meta, {"U_mean": arrays["U_mean"]})


def test_export_before_burn_in_falls_back_to_sample(tmp_path):
    engine = BPMFEngine(_cfg(num_sweeps=1, burn_in=5), device="cpu").fit(_coo())
    meta, arrays = load_artifact(engine.export(str(tmp_path / "raw")))
    assert meta.num_mean_samples == 0 and meta.num_kept_samples == 0
    np.testing.assert_array_equal(arrays["U_mean"], engine.factors()[0])


def test_cli_checkpoint_resume_and_export(tmp_path, capsys):
    from repro_torch.launch import bpmf as cli

    base = ["--device", "cpu", "--K", "4", "--burn-in", "1", "--users", "60", "--movies", "30",
            "--nnz", "600", "--checkpoint-dir", str(tmp_path / "ckpt"), "--sync-checkpoint-writes"]
    assert cli.main(base + ["--sweeps", "2", "--checkpoint-every", "2"]) == 0
    assert latest_step(str(tmp_path / "ckpt")) == 2
    capsys.readouterr()
    assert cli.main(base + ["--sweeps", "4", "--resume", "--export-artifact", str(tmp_path / "art")]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at sweep 2" in out and "(2 this run)" in out
    assert "exported serving artifact" in out
    assert load_artifact(str(tmp_path / "art"))[0].num_sweeps_done == 4
