"""The port's distributed sampler (ring, ring_async, allgather) against the JAX package.

* ``build_distributed_data`` gives the JAX package's per-step, per-shard
  layout element for element (item ids, neighbors, values, counts,
  ``orig_ids``, test set, centering mean);
* ``flatten_step`` equals JAX's; the fused step op (plain version on the
  CPU) agrees with JAX's ``bpmf_gram_fused`` (interpret mode) at the edge
  shapes of tests/test_gram_fused.py: 1e-5 single-chunk, 1e-4 multi-chunk,
  5e-2 bf16;
* within the port, every comm mode at S in {1, 2, 4} draws the samples of
  the port's own sequential sampler up to reduction order (DESIGN.md §1):
  U, V to 1e-3 and RMSE to 1e-4 after 4 sweeps; ring_async equals ring bit
  for bit at every depth;
* with the gamma seam filled by JAX's draw, the port's 4-shard ring matches
  JAX's ``RingBackend`` on 4 forced host devices (1e-4 on the RMSEs, 1e-3
  on U and V); with its own gamma it lands in the recorded RMSE band.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.core import distributed as jdist
from repro.core import types as jtypes
from repro.core.prediction import PredictionState as JPredictionState
from repro.core.types import Bucket as JBucket
from repro.data.synthetic import small_test_ratings
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import distributed as dist
from repro_torch.core import prng
from repro_torch.core.prediction import PredictionState
from repro_torch.core.types import BPMFConfig as CoreConfig
from repro_torch.core.types import Bucket
from repro_torch.data.sparse import RatingsCOO
from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.kernels import ops
from repro_torch.launch import bpmf as cli
from repro_torch.launch.mesh import bpmf_ring

from test_torch_engine import CFG, RMSE_BAND, TASK, _jax_gamma

PADS = (8, 32, 128)
RUN = dict(K=8, num_sweeps=4, burn_in=1, bucket_pads=PADS, seed=0)


def _coo():
    """test_distributed.py's task: 120 x 45, nnz 1080, rank 4."""
    coo, _ = small_test_ratings(num_users=120, num_movies=45, nnz=1080, true_rank=4, seed=3)
    return coo


def _port_coo(coo) -> RatingsCOO:
    return RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)


# ---------- host layout ----------


@pytest.mark.parametrize("S,strategy", [(2, "lpt"), (4, "lpt"), (4, "block")])
def test_build_distributed_data_matches_jax(S, strategy):
    coo = _coo()
    jdata, jplan = jdist.build_distributed_data(coo, S, pads=PADS, seed=0, strategy=strategy)
    data, plan = dist.build_distributed_data(_port_coo(coo), S, pads=PADS, seed=0, strategy=strategy)
    assert data.num_shards == S and (data.min_rating, data.max_rating) == (jdata.min_rating, jdata.max_rating)
    np.testing.assert_array_equal(plan.part_users.perm, jplan.part_users.perm)
    np.testing.assert_array_equal(plan.part_movies.perm, jplan.part_movies.perm)
    for name in ("users", "movies"):
        js, side = getattr(jdata, name), getattr(data, name)
        assert (side.cap, side.num_items, side.num_steps, side.num_shards) == (js.cap, js.num_items, S, S)
        np.testing.assert_array_equal(torch.cat(side.orig_ids).numpy(), np.asarray(js.orig_ids))
        for t in range(S):
            assert all(len(side.steps[t][d]) == len(js.steps[t]) for d in range(S))
            for k, jb in enumerate(js.steps[t]):
                for f in ("item_ids", "nbr", "val", "nnz"):
                    got = torch.cat([getattr(side.steps[t][d][k], f) for d in range(S)]).numpy()
                    want = np.asarray(getattr(jb, f))
                    assert got.dtype == want.dtype, (name, t, k, f)
                    np.testing.assert_array_equal(got, want)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(data.test, f).numpy(), np.asarray(getattr(jdata.test, f)))
    assert data.mean_rating.numpy() == np.asarray(jdata.mean_rating)


# ---------- flatten_step and the fused step op ----------


def _bucket(rng, Ns, B, P, cap, dead_rows=(), nnz=None):
    """tests/test_gram_fused.py's bucket: item ids drawn independently per bucket."""
    if nnz is None:
        nnz = rng.integers(0, P + 1, B).astype(np.int32)
    nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
    val = rng.normal(size=(B, P)).astype(np.float32)
    val[np.arange(P)[None, :] >= nnz[:, None]] = 0.0
    item_ids = rng.permutation(cap)[:B].astype(np.int32)
    item_ids[list(dead_rows)] = -1
    return item_ids, nbr, val, nnz


# name: (Ns, K, cap, [(B, P, dead rows, all empty)], tolerance)
FUSED_CASES = {
    "multibucket": (96, 16, 64, [(16, 8, (), False), (9, 32, (), False), (4, 128, (), False)], 1e-5),
    "B_not_multiple_of_tb": (64, 8, 24, [(13, 64, (), False)], 1e-5),
    "all_padding": (32, 8, 16, [(8, 16, (), True), (8, 16, (), False)], 1e-5),
    "item_minus_one": (48, 16, 20, [(10, 32, (0, 3, 9), False)], 1e-5),
    "multichunk": (64, 16, 16, [(8, 300, (), False)], 1e-4),
}


def _fused_case(name):
    Ns, K, cap, shapes, tol = FUSED_CASES[name]
    rng = np.random.default_rng(sorted(FUSED_CASES).index(name))
    X = rng.normal(size=(Ns, K)).astype(np.float32)
    arrays = [
        _bucket(rng, Ns, B, P, cap, dead, np.zeros(B, np.int32) if empty else None)
        for B, P, dead, empty in shapes
    ]
    G = rng.normal(size=(cap, K, K)).astype(np.float32)
    g = rng.normal(size=(cap, K)).astype(np.float32)
    return X, arrays, G, g, tol


def _jbuckets(arrays):
    return tuple(JBucket(*(jnp.asarray(a) for a in arr)) for arr in arrays)


def _tbuckets(arrays):
    return tuple(Bucket(*(torch.from_numpy(a) for a in arr)) for arr in arrays)


@pytest.mark.parametrize("pc,tb", [(128, 8), (32, 4)])
def test_flatten_step_matches_jax(pc, tb):
    _, arrays, _, _, _ = _fused_case("multibucket")
    arrays += _fused_case("multichunk")[1] + _fused_case("item_minus_one")[1]
    got = ops.flatten_step(_tbuckets(arrays), pc, tb)
    want = jops.flatten_step(_jbuckets(arrays), pc, tb)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_step_matches_jax_kernel(name):
    X, arrays, G, g, tol = _fused_case(name)
    Gj, gj = jops.bpmf_gram_step(
        jnp.asarray(G), jnp.asarray(g), jnp.asarray(X), _jbuckets(arrays),
        alpha=2.0, gram_impl="pallas_fused", tb=8, pc=128,
    )
    outs = {}
    for impl in ("pallas_fused", "auto", "pallas", "xla"):
        Gt, gt = torch.from_numpy(G.copy()), torch.from_numpy(g.copy())
        ops.bpmf_gram_step(Gt, gt, torch.from_numpy(X), _tbuckets(arrays), alpha=2.0, gram_impl=impl)
        np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=tol, atol=tol)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=tol, atol=tol)
        outs[impl] = (Gt, gt)
    assert torch.equal(outs["auto"][0], outs["pallas_fused"][0])
    # rows that no live chunk reaches keep their bits
    items = np.concatenate([a[0][a[3] > 0] for a in arrays])
    untouched = np.setdiff1d(np.arange(G.shape[0]), items)
    np.testing.assert_array_equal(outs["auto"][0].numpy()[untouched], G[untouched])
    np.testing.assert_array_equal(outs["auto"][1].numpy()[untouched], g[untouched])


def test_fused_step_bf16_matches_jax_kernel():
    X, arrays, G, g, _ = _fused_case("multibucket")
    Gj, gj = jops.bpmf_gram_step(
        jnp.asarray(G), jnp.asarray(g), jnp.asarray(X), _jbuckets(arrays),
        alpha=2.0, compute_dtype=jnp.bfloat16, gram_impl="pallas_fused", tb=8, pc=128,
    )
    Gt, gt = torch.from_numpy(G.copy()), torch.from_numpy(g.copy())
    ops.bpmf_gram_step(Gt, gt, torch.from_numpy(X), _tbuckets(arrays), alpha=2.0,
                       compute_dtype=torch.bfloat16, gram_impl="pallas_fused")
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=5e-2, atol=5e-2)


def test_fused_op_on_cpu_counts_plain_calls_and_orders_chunks():
    X, arrays, G, g, _ = _fused_case("multibucket")
    nbr, val, item, cnt = ops.flatten_step(_tbuckets(arrays), 128, 8)
    order = gram_kernel.chunk_order(item, cnt)
    # one segment per row with a live chunk, longest first, chunks ascending
    live = (item >= 0) & (cnt > 0)
    assert sorted(order.item.tolist()) == sorted(set(item[live].tolist()))
    assert list(order.lengths) == sorted(order.lengths, reverse=True)
    for r in range(order.num_rows):
        c = order.chunks[order.start[r] : order.start[r] + order.length[r]]
        assert torch.equal(c, torch.nonzero(live & (item == order.item[r])).flatten().int())
    launches, plain = gram_kernel.FUSED_LAUNCHES, gram_kernel.FUSED_PLAIN_CALLS
    Gt, gt = torch.from_numpy(G.copy()), torch.from_numpy(g.copy())
    out = gram_kernel.bpmf_gram_fused(Gt, gt, torch.from_numpy(X), nbr, val, item, cnt, 2.0, order=order)
    assert out[0] is Gt and out[1] is gt  # in place, as the JAX kernel aliases them
    assert (gram_kernel.FUSED_LAUNCHES, gram_kernel.FUSED_PLAIN_CALLS) == (launches, plain + 1)
    with pytest.raises(ValueError, match="unknown gram_impl"):
        ops.bpmf_gram_step(Gt, gt, torch.from_numpy(X), _tbuckets(arrays), alpha=2.0, gram_impl="triton")


# ---------- the sampler: every comm mode against the port's sequential ----------


_RUNS: dict = {}


def _run(name="sequential", S=1, depth=1, **kw):
    key = (name, S, depth, tuple(sorted(kw.items())))
    if key not in _RUNS:
        cfg = BPMFConfig().replace(name=name, num_shards=S, pipeline_depth=depth, **RUN, **kw)
        _RUNS[key] = BPMFEngine(cfg, device="cpu").fit(_port_coo(_coo()))
    return _RUNS[key]


MODES = [("ring", 1), ("ring_async", 1), ("ring_async", 2), ("ring_async", 3), ("allgather", 1)]


@pytest.mark.parametrize("name,depth", MODES)
@pytest.mark.parametrize("S", [1, 2, 4])
def test_comm_modes_match_port_sequential(S, name, depth):
    seq, ring, e = _run(), _run("ring", S), _run(name, S, depth)
    assert e.backend.num_shards == S and e.num_sweeps_done == 4
    for got, want in zip(e.factors(), seq.factors()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    rm = np.array([[m.rmse_sample, m.rmse_avg] for m in e.history])
    np.testing.assert_allclose(rm, [[m.rmse_sample, m.rmse_avg] for m in seq.history], rtol=0, atol=1e-4)
    if name == "ring_async":  # only when transfers are issued changes, never the values
        for got, want in zip(e.factors(), ring.factors()):
            np.testing.assert_array_equal(got, want)
        assert [m.rmse_sample for m in e.history] == [m.rmse_sample for m in ring.history]
    if name == "allgather":
        for got, want in zip(e.factors(), ring.factors()):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("gram_impl", ["pallas", "xla"])
def test_ring_per_bucket_gram_impls_match_fused(gram_impl):
    fused, e = _run("ring", 2), _run("ring", 2, gram_impl=gram_impl)
    assert not e.backend.data.users.fused  # the fused layouts are built only for the fused kernel
    for got, want in zip(e.factors(), fused.factors()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_run_distributed_draws_the_engine_ring_samples():
    e = _run("ring", 2)
    b = e.backend
    state, _, history = dist.run_distributed(prng.key(RUN["seed"]), b.data, b.core_cfg, b.ring, num_sweeps=4)
    assert [m.rmse_sample for m in history] == [m.rmse_sample for m in e.history]
    for got, want in zip(dist.gather_factors(state, b.plan), e.factors()):
        np.testing.assert_array_equal(got, want)


def test_ring_engine_posterior_and_predictor():
    seq, e = _run(), _run("ring", 4)
    meta, arrays = e._artifact_payload()
    meta_s, arrays_s = seq._artifact_payload()
    assert (meta.num_mean_samples, meta.num_kept_samples, meta.backend) == (3, 3, "ring")
    assert (meta.num_users, meta.num_movies) == (meta_s.num_users, meta_s.num_movies)
    for k in ("U_mean", "V_mean", "U_samples", "V_samples"):
        np.testing.assert_allclose(arrays[k], arrays_s[k], rtol=0, atol=1e-3)
    rows, cols = np.arange(10), np.arange(10) % meta.num_movies
    np.testing.assert_allclose(e.predict(rows, cols), seq.predict(rows, cols), rtol=0, atol=1e-3)
    assert e.backend.data.fused_launches_per_sweep() == 2 * 4 * 4  # every (side, step, shard) is live here


def test_ring_with_own_gamma_lands_in_band():
    e = BPMFEngine(BPMFConfig().replace(name="ring", num_shards=4, **CFG), device="cpu")
    e.fit(load_dataset("synthetic", **TASK))
    lo, hi = RMSE_BAND
    assert lo < e.rmse < hi, f"observed RMSE {e.rmse:.4f} left the band {RMSE_BAND}"


JAX_RING_CODE = """
import numpy as np
import repro.bpmf as jbpmf
cfg = jbpmf.BPMFConfig().replace(name="ring", num_shards=4, **{cfg})
engine = jbpmf.BPMFEngine(cfg).fit(jbpmf.load_dataset("synthetic", **{task}))
U, V = engine.factors()
hist = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in engine.history])
np.savez({path!r}, hist=hist, U=U, V=V)
"""


@pytest.mark.multidevice
def test_ring_matches_jax_ring_on_4_devices(tmp_path, monkeypatch):
    path = str(tmp_path / "jax_ring.npz")
    run_with_devices(JAX_RING_CODE.format(cfg=CFG, task=TASK, path=path), num_devices=4)
    want = np.load(path)
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    e = BPMFEngine(BPMFConfig().replace(name="ring", num_shards=4, **CFG), device="cpu")
    e.fit(load_dataset("synthetic", **TASK))
    got = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in e.history])
    np.testing.assert_allclose(got, want["hist"], rtol=0, atol=1e-4)
    U, V = e.factors()
    np.testing.assert_allclose(U, want["U"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(V, want["V"], rtol=0, atol=1e-3)


def test_convert_starts_the_port_from_a_jax_ring_state(monkeypatch):
    """One ring sweep from the JAX package's own state and data (S = 1: one JAX device here)."""
    coo = _coo()
    jdata, jplan = jdist.build_distributed_data(coo, 1, pads=PADS, seed=0)
    mesh = jdist.make_ring_mesh()
    jcfg = jtypes.BPMFConfig(K=8, burn_in=0, bucket_pads=PADS, comm_mode="ring", gram_impl="xla")
    key = jax.random.key(5)
    sdata = jdist.shard_data(jdata, mesh)
    jstate = jdist.init_dist_state(key, sdata, jcfg, mesh)
    jnew, _, jm = jdist.dist_gibbs_sweep(key, jstate, JPredictionState.init(jdata.test.rows.shape[0]), sdata, jcfg, mesh)

    data = dist.place_data(convert.dist_data_from_tree(dataclasses.asdict(jdata)), dist.Ring(["cpu"]))
    plan = convert.dist_plan_from_tree(dataclasses.asdict(jplan))
    state = convert.dist_state_from_tree(dataclasses.asdict(jstate), 1)
    np.testing.assert_array_equal(torch.cat(state.U).numpy(), np.asarray(jstate.U))
    monkeypatch.setattr(prng, "gamma", _jax_gamma)
    cfg = CoreConfig(K=8, burn_in=0, comm_mode="ring")
    ring = dist.Ring(["cpu"])
    new, _, _, rows = dist.dist_gibbs_sweep_block(
        convert.key_from_data(jax.random.key_data(key)), state,
        PredictionState.init(data.test.rows.shape[0]),
        dist.init_dist_accum(data, cfg, ring, 0), data, cfg, ring, 1,
    )
    U, V = dist.gather_factors(new, plan)
    jU, jV = np.asarray(jnew.U)[jplan.part_users.perm], np.asarray(jnew.V)[jplan.part_movies.perm]
    np.testing.assert_allclose(U, jU, rtol=0, atol=1e-4)
    np.testing.assert_allclose(V, jV, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rows[0, 0].item(), float(jm.rmse_sample), rtol=0, atol=1e-5)


# ---------- ring construction, CLI and errors ----------


def test_bpmf_ring_places_shards_and_raises_without_devices(monkeypatch):
    ring = bpmf_ring(3, "cpu")
    assert ring.devices == (torch.device("cpu"),) * 3 and ring.shards_per_device() == {"cpu": 3}
    assert bpmf_ring(0, "cpu").num_shards == 1
    with pytest.raises(ValueError, match="num_shards"):
        bpmf_ring(-1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bpmf_ring(4)


def test_pipeline_depth_zero_and_unknown_comm_mode_raise():
    with pytest.raises(ValueError, match="pipeline_depth"):
        BPMFConfig().replace(name="ring_async", pipeline_depth=0)
    e = _run("ring", 2)
    b = e.backend
    state, pred, accum = b.init_state(e._k_init), b.init_pred(), b.init_accum()
    for cfg, match in ((dataclasses.replace(b.core_cfg, comm_mode="ring_async", pipeline_depth=0), "pipeline_depth"),
                       (dataclasses.replace(b.core_cfg, comm_mode="mpi"), "unknown comm_mode")):
        with pytest.raises(ValueError, match=match):
            dist.dist_gibbs_sweep_block(e._k_run, state, pred, accum, b.data, cfg, b.ring, 1)


def test_cli_runs_the_ring_on_cpu(capsys):
    assert cli.main([
        "--device", "cpu", "--backend", "ring", "--num-shards", "2", "--sweeps", "2",
        "--burn-in", "1", "--K", "4", "--users", "60", "--movies", "30", "--nnz", "600",
    ]) == 0
    out = capsys.readouterr().out
    assert "backend=ring shards=2 device=cpu" in out and out.count("sweep ") == 2
