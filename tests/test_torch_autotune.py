"""The port's Gram autotuner (``repro_torch.kernels.autotune``) against the JAX package's.

Mirrors tests/test_gram_fused.py's autotune tests, with launch counters in
place of jaxprs:

* the cache round trip, a cache entry beating the heuristic, malformed and
  old-version files ignored, entries a key cannot take ignored;
* off the card the heuristic gives ``"xla"``, as the JAX package's does;
  on a CUDA key it gives the dispatch the port had before the autotuner
  (the fused kernel at ``pc = 128`` for a step, the per-bucket kernel with
  its piece rule for a bucket), and K above 128 raises;
* ``ShapeKey.encode()`` and ``workload_step_keys`` equal the JAX
  package's for the same shapes and the same ratings and partition;
* a warmed step entry of each kind engages in a CPU ring sweep, a warmed
  bucket entry mixes implementations within one step, and a step entry
  pins the whole step;
* ``measure_step`` records into a temporary cache, never over an entry
  that compared more candidates, and leaves out a candidate that misses
  the plain version's band.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.data.synthetic import small_test_ratings
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.core.types import Bucket as JBucket
from repro_torch.bpmf import BPMFConfig, BPMFEngine
from repro_torch.core import distributed as dist
from repro_torch.core.balance import CostModel
from repro_torch.core.types import Bucket
from repro_torch.data.sparse import RatingsCOO
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import bpmf_gram as gram_kernel


Decision = autotune.Decision


@pytest.fixture
def tmp_cache(tmp_path):
    cache = autotune.AutotuneCache(str(tmp_path / "gram_cuda.json"))
    autotune.set_cache(cache)
    yield cache
    autotune.set_cache(None)


def _arrays(rng, Ns, B, P, cap):
    """A random bucket's numpy arrays with distinct destination rows in [0, cap)."""
    nnz = rng.integers(0, P + 1, B).astype(np.int32)
    nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
    val = rng.normal(size=(B, P)).astype(np.float32)
    val[np.arange(P)[None, :] >= nnz[:, None]] = 0.0
    return rng.permutation(cap)[:B].astype(np.int32), nbr, val, nnz


def _step(seed, Ns, K, cap, shapes):
    rng = np.random.default_rng(seed)
    arrays = [_arrays(rng, Ns, B, P, cap) for B, P in shapes]
    X = rng.normal(size=(Ns, K)).astype(np.float32)
    G = rng.normal(size=(cap, K, K)).astype(np.float32)
    g = rng.normal(size=(cap, K)).astype(np.float32)
    return X, arrays, G, g


def _tbuckets(arrays):
    return tuple(Bucket(*(torch.from_numpy(a) for a in arr)) for arr in arrays)


def _jbuckets(arrays):
    return tuple(JBucket(*(jnp.asarray(a) for a in arr)) for arr in arrays)


def test_cache_round_trip(tmp_cache):
    key = autotune.step_key([(16, 32), (8, 128)], 96, 16, 64)
    dec = Decision("pallas_fused", pc=64)
    tmp_cache.record(key, dec, timings_us={"pallas": 10.0, "pallas_fused_pc64": 5.0}, card="NVIDIA H100, 700 W")
    reloaded = autotune.AutotuneCache(tmp_cache.path)
    assert reloaded.lookup(key) == dec
    raw = json.load(open(tmp_cache.path))
    assert raw["version"] == 1 and raw["entries"][key.encode()]["card"] == "NVIDIA H100, 700 W"
    assert autotune.AutotuneCache(tmp_cache.path).entries()[key.encode()]["timings_us"]["pallas"] == 10.0


def test_decide_prefers_cache_over_heuristic(tmp_cache):
    key = autotune.step_key([(8, 8)], 32, 8, 8, backend="cpu")
    assert autotune.decide(key) == Decision("xla")
    tmp_cache.record(key, Decision("pallas_fused", pc=256))
    assert autotune.decide(key) == Decision("pallas_fused", pc=256)
    cuda_key = autotune.bucket_key(64, 128, 256, 32)
    assert autotune.decide(cuda_key) == Decision("pallas")
    tmp_cache.record(cuda_key, Decision("pallas", piece=512))
    assert autotune.decide(cuda_key) == Decision("pallas", piece=512)


def test_malformed_and_old_version_files_are_ignored(tmp_path):
    path = tmp_path / "gram_cuda.json"
    path.write_text("{not json")
    assert autotune.AutotuneCache(str(path)).lookup(autotune.bucket_key(8, 8, 32, 8)) is None
    path.write_text(json.dumps({"version": 999, "entries": {"x": {"impl": "pallas"}}}))
    assert autotune.AutotuneCache(str(path)).entries() == {}
    path.write_text(json.dumps({"version": 1, "entries": []}))
    assert autotune.AutotuneCache(str(path)).entries() == {}


def test_lookup_ignores_entries_the_key_cannot_take(tmp_cache):
    cuda_step = autotune.step_key([(8, 8)], 32, 8, 8)
    tmp_cache.record(cuda_step, Decision("xla"))  # the plain version never runs on the card
    assert tmp_cache.lookup(cuda_step) is None
    assert autotune.decide(cuda_step) == Decision("pallas_fused", pc=128)
    bucket = autotune.bucket_key(8, 8, 32, 8, backend="cpu")
    tmp_cache.record(bucket, Decision("pallas_fused", pc=128))  # no fused kernel for one bucket
    assert tmp_cache.lookup(bucket) is None
    tmp_cache.entries()["bogus"] = {"impl": "triton"}
    assert tmp_cache.lookup(autotune.ShapeKey("bucket", 1, 1, 1, 1, "float32", "cpu")) is None


@pytest.mark.parametrize("kind", ["bucket", "step"])
def test_heuristic_off_the_card_is_xla_as_the_reference(kind):
    key = autotune.ShapeKey(kind, 64, 128, 256, 32, "float32", "cpu", cap=64)
    jkey = jautotune.ShapeKey(kind, 64, 128, 256, 32, "float32", "cpu", cap=64)
    assert autotune.heuristic(key) == Decision("xla")
    assert autotune.heuristic(key).impl == jautotune.heuristic(jkey).impl == "xla"


def test_heuristic_on_a_cuda_key_is_the_dispatch_without_a_cache():
    step = autotune.ShapeKey("step", 64, 128, 512, 32, "float32", "cuda", cap=64)
    assert autotune.heuristic(step) == Decision("pallas_fused", pc=ops.FUSED_PC) == Decision("pallas_fused", pc=128)
    bucket = autotune.ShapeKey("bucket", 64, 131_072, 138_493, 32, "bfloat16", "cuda")
    assert autotune.heuristic(bucket) == Decision("pallas")  # piece None: the piece_width rule
    with pytest.raises(ValueError, match="K <= 128"):
        autotune.heuristic(autotune.ShapeKey("step", 8, 8, 8, 129, "float32", "cuda", cap=8))
    # the plan a CUDA step gets from a cold cache: one fused layout at pc = 128
    X, arrays, G, g = _step(0, 64, 8, 40, [(16, 8), (8, 32), (8, 64)])
    plan = ops.plan_step(_tbuckets(arrays), 64, 8, 40, backend="cuda")
    assert plan.fused and plan.decision == Decision("pallas_fused", pc=128)
    assert plan.layout.nbr.shape[1] == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shape_key_encoding_matches_the_reference(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    shapes = [(48, 64), (16, 32)]
    pairs = [
        (autotune.bucket_key(48, 64, 128, 32, tdt, "cpu"), jautotune.bucket_key(48, 64, 128, 32, jdt, "cpu")),
        (autotune.step_key(shapes, 128, 32, 64, tdt, "cpu"), jautotune.step_key(shapes, 128, 32, 64, jdt, "cpu")),
    ]
    for key, jkey in pairs:
        assert key.encode() == jkey.encode()
    cuda = autotune.step_key(shapes, 128, 32, 64, tdt)
    assert cuda.encode() == jautotune.step_key(shapes, 128, 32, 64, jdt, "cuda").encode()


@pytest.mark.parametrize("S", [2, 4])
def test_workload_step_keys_match_the_reference(S):
    coo, _ = small_test_ratings(num_users=120, num_movies=45, nnz=1080, true_rank=4, seed=3)
    jdata, _ = jdist.build_distributed_data(coo, S, pads=(8, 32, 128), seed=0)
    data, _ = dist.build_distributed_data(
        RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies), S, pads=(8, 32, 128), seed=0)
    jkeys = jautotune.workload_step_keys(jdata, 8, backend="cpu")
    keys = autotune.workload_step_keys(data, 8, backend="cpu")
    assert len(keys) == S * len(jkeys)  # one per (side, step, shard); the reference's one per (side, step)
    for n, (key, shapes) in enumerate(keys):
        jkey, jshapes = jkeys[n // S]
        assert (key.B, key.P, key.Ns, key.K, key.cap) == (jkey.B, jkey.P, jkey.Ns, jkey.K, jkey.cap)
        assert key.encode() == jkey.encode() and shapes == jshapes


RING = dict(K=8, num_sweeps=2, burn_in=1, bucket_pads=(8, 32, 128), seed=0, name="ring", num_shards=2)


def _ring_coo():
    coo, _ = small_test_ratings(num_users=120, num_movies=45, nnz=1080, true_rank=4, seed=3)
    return RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)


def _counted_fit(cfg):
    engine = BPMFEngine(cfg, device="cpu")
    engine.prepare(_ring_coo())
    before = {n: getattr(gram_kernel, n) for n in ("PLAIN_CALLS", "FUSED_PLAIN_CALLS")}
    engine.fit()
    return engine, {n: getattr(gram_kernel, n) - before[n] for n in before}


@pytest.mark.parametrize("warm", [Decision("pallas_fused", pc=64), Decision("pallas", piece=256)])
def test_a_warmed_step_entry_engages_in_a_cpu_ring_sweep(tmp_cache, warm):
    cfg = BPMFConfig().replace(**RING)
    cold, cold_counts = _counted_fit(cfg)
    data = cold.backend.data
    steps = len(data.step_plans())
    buckets = sum(len(bs) for side in (data.users, data.movies) for per_step in side.steps for bs in per_step)
    assert all(p.decision == Decision("xla") and not p.fused for *_, p in data.step_plans())
    assert cold_counts == {"PLAIN_CALLS": buckets * 2, "FUSED_PLAIN_CALLS": 0}  # 2 sweeps, per bucket
    for key, _ in autotune.workload_step_keys(data, cfg.model.K, backend="cpu"):
        tmp_cache.record(key, warm)
    warmed, counts = _counted_fit(cfg)
    plans = [p for *_, p in warmed.backend.data.step_plans()]
    assert all(p.decision == warm for p in plans)
    if warm.impl == "pallas_fused":
        assert all(p.fused and p.layout.nbr.shape[1] == 64 for p in plans)
        assert counts == {"PLAIN_CALLS": 0, "FUSED_PLAIN_CALLS": steps * 2}
    else:
        assert all(p.buckets == (Decision("pallas", piece=256),) * len(p.buckets) for p in plans)
        assert counts == {"PLAIN_CALLS": buckets * 2, "FUSED_PLAIN_CALLS": 0}
    for got, want in zip(warmed.factors(), cold.factors()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_a_warmed_bucket_cache_mixes_impls_within_a_step(tmp_cache):
    Ns, K, cap = 64, 8, 40
    X, arrays, G, g = _step(11, Ns, K, cap, [(16, 8), (8, 32)])
    buckets = _tbuckets(arrays)
    tmp_cache.record(autotune.bucket_key(16, 8, Ns, K, backend="cpu"), Decision("pallas", piece=256))
    plan = ops.plan_step(buckets, Ns, K, cap, backend="cpu")
    assert not plan.fused and plan.buckets == (Decision("pallas", piece=256), Decision("xla"))
    Gm, gm = ops.bpmf_gram_step(torch.from_numpy(G.copy()), torch.from_numpy(g.copy()), torch.from_numpy(X),
                                buckets, alpha=2.0, gram_impl="auto")
    Gj, gj = jops.bpmf_gram_step(jnp.asarray(G), jnp.asarray(g), jnp.asarray(X), _jbuckets(arrays), alpha=2.0,
                                 gram_impl="xla")
    np.testing.assert_allclose(Gm.numpy(), np.asarray(Gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)
    # an exact step entry pins the whole step over the bucket entries
    tmp_cache.record(autotune.step_key([(16, 8), (8, 32)], Ns, K, cap, backend="cpu"), Decision("pallas", piece=512))
    plan = ops.plan_step(buckets, Ns, K, cap, backend="cpu")
    assert plan.buckets == (Decision("pallas", piece=512),) * 2


SHAPES = [(24, 16), (8, 64)]


def test_measure_step_records_without_clobbering_a_wider_entry(tmp_cache):
    best, timings = autotune.measure_step(SHAPES, 96, 8, iters=2, device="cpu", cache=tmp_cache)
    assert set(timings) == set(autotune.candidates("cpu")) and all(t > 0 for t in timings.values())
    assert best == autotune.candidates("cpu")[min(timings, key=timings.get)]
    key = autotune.step_key(SHAPES, 96, 8, 32, backend="cpu")  # cap: the 32 rows, rounded up to 8
    entry = json.load(open(tmp_cache.path))["entries"][key.encode()]
    assert entry["source"] == "measured" and entry["card"] == "cpu" and len(entry["timings_us"]) == len(timings)
    autotune.measure_step(SHAPES, 96, 8, iters=2, labels=["xla", "pallas"], device="cpu", cache=tmp_cache)
    assert json.load(open(tmp_cache.path))["entries"][key.encode()] == entry
    assert autotune.AutotuneCache(tmp_cache.path).lookup(key) == best


def test_measure_step_leaves_out_a_candidate_that_misses_the_plain_version(tmp_cache, monkeypatch):
    plain = gram_kernel.bpmf_gram_plain

    def wrong(*args, **kw):
        G, g = plain(*args, **kw)
        return 2 * G, g

    monkeypatch.setattr(gram_kernel, "bpmf_gram_plain", wrong)  # the per-bucket path, not the fused one
    best, timings = autotune.measure_step(SHAPES, 96, 8, iters=2, device="cpu", cache=tmp_cache)
    assert best.impl == "pallas_fused" and set(timings) == {f"pallas_fused_pc{pc}" for pc in autotune.PC_CANDIDATES}
    entry = next(iter(json.load(open(tmp_cache.path))["entries"].values()))
    assert entry["rejected"] == ["pallas", "xla"]
    fused = gram_kernel.bpmf_gram_fused

    def wrong_fused(G, g, *args, **kw):  # the candidates' wrapper; the yardstick calls the plain version itself
        fused(G, g, *args, **kw)
        return G.add_(1.0), g

    monkeypatch.setattr(gram_kernel, "bpmf_gram_fused", wrong_fused)
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.measure_step(SHAPES, 96, 8, iters=2, device="cpu", cache=tmp_cache)


def test_step_band_flags_an_error_past_the_allowance():
    X, arrays, _, _ = _step(3, 64, 8, 40, [(16, 32)])
    buckets = _tbuckets(arrays)
    zeros = (torch.zeros(40, 8, 8), torch.zeros(40, 8))
    want = ops.bpmf_gram_step(*(z.clone() for z in zeros), torch.from_numpy(X), buckets, alpha=2.0,
                              gram_impl="pallas_fused")
    assert autotune.step_band(*want, *want, buckets, 2.0) == 0.0
    bent = want[0].clone()
    bent[arrays[0][0][0], 0, 0] *= 1 + 1e-3
    assert autotune.step_band(bent, want[1], *want, buckets, 2.0) > 1.0
    assert autotune.step_band(bent * float("nan"), want[1], *want, buckets, 2.0) == float("inf")


def test_fig2_cost_model_is_read_from_the_ports_file(tmp_path):
    assert autotune.load_fig2_cost_model(str(tmp_path / "missing.json")) == CostModel()
    path = tmp_path / "fig2_item_update.json"
    path.write_text(json.dumps({"cost_model": {"fixed_us": 3.5, "per_rating_us": 0.25}}))
    assert autotune.load_fig2_cost_model(str(path)) == CostModel(fixed=3.5, per_rating=0.25)
    path.write_text(json.dumps({"cost_model": {"fixed_us": "x"}}))
    assert autotune.load_fig2_cost_model(str(path)) == CostModel()


def test_default_cache_is_the_ports_own_file(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_DIR", raising=False)
    assert autotune.AutotuneCache().path.endswith("experiments/autotune/gram_cuda.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    assert autotune.AutotuneCache().path == str(tmp_path / "gram_cuda.json")
