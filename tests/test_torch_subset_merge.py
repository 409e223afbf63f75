"""The port's ``posterior_merge``: its merge math and its backend against the JAX package's.

The merge math is numpy on both sides, so the same seeded inputs must give
equal arrays: the partition, split and relabeling (also as a hypothesis
property), the weights, the closed-form product, Procrustes, the alignment,
the merge (precision, pool, and the pool fallback with fewer than two
window samples), the column-mean baseline, and the chain keys' bits.

Then the backend on test_posterior_quality's task (150 x 80, nnz 4000,
noise 0.3, seed 7; K=8, burn-in 3, pads (8, 32, 128), keep 4) on the CPU,
at P = 2 and P = 3 chains, one block of 6 sweeps:

* each chain's buckets, test set and centering equal ``repro``'s
  ``chain_data[c]`` element for element; each chain's initial state
  equals ``repro``'s (its U and V rows within the normals' 1e-6 band of
  tests/test_torch_prng.py, the rest exactly) and, bit for bit, the port's
  sequential rows of the chain's users;
* with the gamma seam filled by JAX's draw, each chain's U, V and
  hyper-parameters match ``repro``'s within 1e-3 and the combined metric
  rows within 1e-4 (the engine parity test's band);
* the port's merge of ``repro``'s chain trees is ``repro``'s merged summary
  bit for bit, and the two engines' merged artifacts agree within 1e-3
  (Procrustes turns the chains' float ulps into a small rotation).

Last, at P = 2 and 4 with the port's own gamma, for 10 sweeps, the merged
artifact passes the JAX package's statistical gates
(tests/test_posterior_quality.py): inside ``MERGE_RMSE_BAND``, below 0.95 x
the column-mean baseline, and within ``MERGE_DEGRADATION_MAX`` of the
port's sequential artifact.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.bpmf as jbpmf
from conftest import optional_hypothesis
from repro.core import subset_merge as jmerge
from repro.data.sparse import RatingsCOO as JRatingsCOO
from repro.data.sparse import train_test_split as j_split
from repro_torch import convert
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import prng, subset_merge
from repro_torch.data.sparse import RatingsCOO
from repro_torch.serve import PosteriorPredictor

from test_torch_engine import _jax_gamma

given, settings, st = optional_hypothesis()

CFG = dict(name="posterior_merge", K=8, num_sweeps=6, burn_in=3, bucket_pads=(8, 32, 128),
           keep_factor_samples=4)
QUALITY_CFG = dict(K=8, num_sweeps=10, burn_in=3, bucket_pads=(8, 32, 128), keep_factor_samples=4)
TASK = dict(num_users=150, num_movies=80, nnz=4000, noise_std=0.3, seed=7)


def _coo() -> RatingsCOO:
    return load_dataset("synthetic", **TASK)


def _jcoo(coo: RatingsCOO) -> JRatingsCOO:
    return JRatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)


def _equal_coo(a, b) -> None:
    for f in ("rows", "cols", "vals"):
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    assert (a.num_users, a.num_movies) == (b.num_users, b.num_movies)


def _trees(rng, C: int, S: int, N: int = 6, K: int = 3, users: int = 4, count: int = 5,
           scales=None) -> list[dict]:
    """Per-chain accumulator trees; chain c's windows scaled by ``scales[c]``."""
    scales = scales or [1.0] * C
    out = []
    for c in range(C):
        out.append({
            "U_sum": (rng.normal(size=(users, K)) * count).astype(np.float32),
            "V_sum": (rng.normal(size=(N, K)) * count).astype(np.float32),
            "count": np.asarray(count, np.int32),
            "U_samples": rng.normal(size=(S, users, K)).astype(np.float32),
            "V_samples": (scales[c] * rng.normal(size=(S, N, K))).astype(np.float32),
        })
    return out


def _assert_trees_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------- the merge math, exact against the reference ----------


@pytest.mark.parametrize("strategy", ["lpt", "block", "naive"])
@pytest.mark.parametrize("P", [1, 3, 4])
def test_partition_split_localize_equal_reference(strategy, P):
    coo = _coo()
    sets = subset_merge.partition_users(coo, P, strategy)
    want = jmerge.partition_users(_jcoo(coo), P, strategy)
    assert len(sets) == len(want)
    for a, b in zip(sets, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b, uids in zip(subset_merge.split_by_users(coo, sets),
                          jmerge.split_by_users(_jcoo(coo), want), sets):
        _equal_coo(a, b)
        _equal_coo(subset_merge.localize_users(a, uids), jmerge.localize_users(b, uids))


@given(
    num_users=st.integers(min_value=1, max_value=20),
    num_partitions=st.integers(min_value=1, max_value=5),
    ratings=st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=19),
            st.integers(min_value=0, max_value=9),
            st.floats(min_value=1.0, max_value=5.0, allow_nan=False),
        ),
        max_size=60,
    ),
    strategy=st.sampled_from(["lpt", "block", "naive"]),
)
@settings(max_examples=50, deadline=None)
def test_partition_round_trip_property(num_users, num_partitions, ratings, strategy):
    """Every user in one chain, every rating in its user's chain, local ids
    mapping back to the originals; and every array the reference's."""
    num_partitions = min(num_partitions, num_users)
    rows = np.asarray([r[0] % num_users for r in ratings], np.int32)
    cols = np.asarray([r[1] for r in ratings], np.int32)
    vals = np.asarray([r[2] for r in ratings], np.float32)
    coo = RatingsCOO(rows, cols, vals, num_users, 10)
    sets = subset_merge.partition_users(coo, num_partitions, strategy=strategy)
    np.testing.assert_array_equal(np.sort(np.concatenate(sets)), np.arange(num_users))
    subs = subset_merge.split_by_users(coo, sets)
    merged = sorted((int(r), int(c), float(v)) for s in subs for r, c, v in zip(s.rows, s.cols, s.vals))
    assert merged == sorted((int(r), int(c), float(v)) for r, c, v in zip(rows, cols, vals))
    want_subs = jmerge.split_by_users(_jcoo(coo), jmerge.partition_users(_jcoo(coo), num_partitions, strategy))
    for s, w, uids in zip(subs, want_subs, sets):
        _equal_coo(s, w)
        local = subset_merge.localize_users(s, uids)
        assert local.num_users == len(uids)
        np.testing.assert_array_equal(uids[local.rows], s.rows)


@pytest.mark.parametrize("method,S", [("precision", 5), ("precision", 1), ("precision", 0), ("pool", 5)])
def test_merge_weights_and_chain_trees_equal_reference(method, S):
    """Weights, the alignment and the merge, with precision weights, pooling,
    and the pool fallback (fewer than two window samples)."""
    trees = _trees(np.random.default_rng(S), 3, S, scales=[0.5, 2.0, 1.0])
    windows = np.stack([t["V_samples"] for t in trees])
    got = subset_merge.merge_weights(windows, method)
    want = jmerge.merge_weights(windows, method)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if S:
        for a, b in zip(subset_merge.align_chain_trees(trees), jmerge.align_chain_trees(trees)):
            _assert_trees_equal(a, b)
    user_sets = [np.array([0, 5, 9, 10]), np.array([1, 2, 3, 4]), np.array([6, 7, 8, 11])]
    for align in (True, False):
        _assert_trees_equal(
            subset_merge.merge_chain_trees(trees, user_sets, 12, method=method, align=align),
            jmerge.merge_chain_trees(trees, user_sets, 12, method=method, align=align),
        )


def test_closed_forms_and_baseline_equal_reference():
    rng = np.random.default_rng(4)
    means, variances = rng.normal(size=(3, 7, 2)), rng.uniform(0.1, 2.0, size=(3, 7, 2))
    for a, b in zip(subset_merge.precision_merge(means, variances),
                    jmerge.precision_merge(means, variances)):
        np.testing.assert_array_equal(a, b)
    mean, var = subset_merge.precision_merge(np.array([[1.0], [3.0]]), np.array([[1.0], [0.5]]), eps=0.0)
    np.testing.assert_allclose(mean, [7.0 / 3.0], rtol=1e-6)
    np.testing.assert_allclose(var, [1.0 / 3.0], rtol=1e-6)
    A, ref = rng.normal(size=(9, 4)).astype(np.float32), rng.normal(size=(9, 4)).astype(np.float32)
    R = subset_merge.procrustes_rotation(A, ref)
    np.testing.assert_array_equal(R, jmerge.procrustes_rotation(A, ref))
    np.testing.assert_allclose(R @ R.T, np.eye(4), atol=1e-6)
    coo = _coo()
    for frac, seed in ((0.1, 0), (0.3, 5)):
        assert subset_merge.column_mean_rmse(coo, frac, seed) == jmerge.column_mean_rmse(_jcoo(coo), frac, seed)
    assert subset_merge.MERGE_RMSE_BAND == jmerge.MERGE_RMSE_BAND
    assert subset_merge.MERGE_DEGRADATION_MAX == jmerge.MERGE_DEGRADATION_MAX
    assert (subset_merge.MERGE_METHODS, subset_merge.MERGE_EPS) == (jmerge.MERGE_METHODS, jmerge.MERGE_EPS)


def test_merge_validation_matches_reference():
    coo = _coo()
    for P in (0, coo.num_users + 1):
        with pytest.raises(ValueError, match="num_partitions"):
            subset_merge.partition_users(coo, P)
    with pytest.raises(ValueError, match="merge_method"):
        subset_merge.merge_weights(np.zeros((2, 3, 4, 2), np.float32), method="bogus")
    empty = np.zeros((0, 0, 0))
    with pytest.raises(ValueError, match="lock-step"):
        subset_merge.merge_chain_trees(
            [{"count": np.asarray(1, np.int32), "V_samples": empty},
             {"count": np.asarray(2, np.int32), "V_samples": empty}],
            [np.array([0]), np.array([1])], num_users=2)
    with pytest.raises(ValueError, match="do not cover"):
        subset_merge.split_by_users(coo, [np.arange(10)])
    with pytest.raises(ValueError, match="outside user_ids"):
        subset_merge.localize_users(coo, np.arange(10))
    out = subset_merge.merge_chain_trees(
        [{"count": np.asarray(0, np.int32), "V_samples": empty}] * 2, [np.array([0]), np.array([1])], 2)
    assert out["count"] == 0 and out["U_samples"].shape == (0, 0, 0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_chain_key_is_jax_fold_in(seed):
    key = prng.key(seed)
    for c in (0, 1, 2, 5, 1000):
        want = np.asarray(jax.random.key_data(jmerge.chain_key(jax.random.key(seed), c)))
        np.testing.assert_array_equal(convert.key_to_data(subset_merge.chain_key(key, c)), want)


# ---------- the backend against the reference's, P = 2 and 3 ----------


@pytest.fixture(scope="module", params=[2, 3], ids=["P2", "P3"])
def engines(request):
    """(reference engine, port engine with the gamma seam) after one 6-sweep block."""
    P = request.param
    ref = jbpmf.BPMFEngine(jbpmf.BPMFConfig().replace(num_partitions=P, **CFG)).fit(
        jbpmf.load_dataset("synthetic", **TASK))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prng, "gamma", _jax_gamma)
        port = BPMFEngine(BPMFConfig().replace(num_partitions=P, **CFG), device="cpu").fit(_coo())
    return ref, port


def _bucket_fields_equal(a, b) -> None:
    assert len(a.buckets) == len(b.buckets) and a.num_items == b.num_items
    for ba, bb in zip(a.buckets, b.buckets):
        for f in ("item_ids", "nbr", "val", "nnz"):
            x, y = getattr(ba, f).numpy(), np.asarray(getattr(bb, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y)


def test_chain_data_equals_reference(engines):
    ref, port = engines
    b, jb = port.backend, ref.backend
    assert b.num_partitions == jb.num_partitions == len(jb.chain_data)
    for a, w in zip(b.user_sets, jb.user_sets):
        np.testing.assert_array_equal(a, w)
    assert b._test_counts == jb._test_counts
    assert (b.mean_rating, b.rating_range) == (jb.mean_rating, jb.rating_range)
    for c, data in enumerate(b.chain_data):
        want = convert.data_from_tree(dataclasses.asdict(jb.chain_data[c]))
        for side in ("users", "movies"):
            _bucket_fields_equal(getattr(data, side), getattr(want, side))
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(data.test, f).numpy(), getattr(want.test, f).numpy())
        assert float(data.mean_rating) == float(want.mean_rating)
        assert (data.num_users, data.num_movies, data.min_rating, data.max_rating) == (
            want.num_users, want.num_movies, want.min_rating, want.max_rating)


def test_chain_init_equals_reference_and_sequential_rows(engines):
    ref, port = engines
    got = port.backend.init_state(port._k_init)
    want = ref.backend.init_state(ref._k_init)
    seq = BPMFEngine(BPMFConfig().replace(**QUALITY_CFG), device="cpu").prepare(_coo())
    seq_state = seq.backend.init_state(seq._k_init)
    for g, w, uids in zip(got, want, port.backend.user_sets):
        np.testing.assert_allclose(g.U.numpy(), np.asarray(w.U), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.V.numpy(), np.asarray(w.V), rtol=0, atol=1e-6)
        for h in ("hyper_U", "hyper_V"):
            for f in ("mu", "Lam"):
                np.testing.assert_array_equal(getattr(getattr(g, h), f).numpy(),
                                              np.asarray(getattr(getattr(w, h), f)))
        assert g.sweep == int(w.sweep) == 0
        np.testing.assert_array_equal(g.U.numpy(), seq_state.U.numpy()[uids])
        np.testing.assert_array_equal(g.V.numpy(), seq_state.V.numpy())


def test_block_with_gamma_seam_matches_reference(engines):
    ref, port = engines
    hist = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in port.history])
    want = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in ref.history])
    np.testing.assert_allclose(hist, want, rtol=0, atol=1e-4)
    for got, st_ in zip(port.state, ref.state):
        np.testing.assert_allclose(got.U.numpy(), np.asarray(st_.U), rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.V.numpy(), np.asarray(st_.V), rtol=0, atol=1e-3)
        for h in ("hyper_U", "hyper_V"):
            for f in ("mu", "Lam"):
                np.testing.assert_allclose(getattr(getattr(got, h), f).numpy(),
                                           np.asarray(getattr(getattr(st_, h), f)), rtol=1e-3, atol=1e-3)
        assert got.sweep == int(st_.sweep) == 6
    for got, want in zip(port.factors(), ref.factors()):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)


def test_merge_of_reference_chains_is_reference_artifact(engines):
    ref, port = engines
    jtrees = ref.backend.accum_host(ref._accum)
    trees = [jtrees[f"chain_{c:03d}"] for c in range(len(jtrees))]
    assert int(trees[0]["count"]) == 3 and trees[0]["V_samples"].shape[0] == 3
    want = ref.backend.posterior_export(ref._accum)
    _assert_trees_equal(subset_merge.merge_chain_trees(trees, port.backend.user_sets, 150), want)
    # the same through the port backend's own export, from the reference's accumulators
    _assert_trees_equal(
        port.backend.posterior_export(convert.merge_accum_from_tree(dataclasses.asdict(ref._accum))), want)
    # the port's chain trees, float ulps away from the reference's, through the port's merge
    meta, arrays = port._artifact_payload()
    want_meta, want_arrays = ref._artifact_payload()
    assert dataclasses.asdict(meta) == dataclasses.asdict(want_meta)
    for k, want in want_arrays.items():
        np.testing.assert_allclose(arrays[k], np.asarray(want), rtol=0, atol=1e-3, err_msg=k)


# ---------- the merged artifact's statistical gates, P = 2 and 4 ----------


def _heldout_rmse(engine, coo) -> float:
    _, test = j_split(_jcoo(coo), engine.cfg.run.test_fraction, engine.cfg.run.seed)
    preds = engine.predict(test.rows, test.cols)
    return float(np.sqrt(np.mean((preds - test.vals) ** 2)))


@pytest.fixture(scope="module")
def sequential_reference():
    """(the port's sequential artifact RMSE, the column-mean baseline) on the task."""
    coo = _coo()
    engine = BPMFEngine(BPMFConfig().replace(**QUALITY_CFG), device="cpu").fit(coo)
    return _heldout_rmse(engine, coo), subset_merge.column_mean_rmse(coo, 0.1, 0)


@pytest.mark.parametrize("P", [2, 4])
def test_merged_artifact_quality_gates(P, sequential_reference, tmp_path):
    seq_rmse, baseline = sequential_reference
    coo = _coo()
    engine = BPMFEngine(BPMFConfig().replace(name="posterior_merge", num_partitions=P, **QUALITY_CFG),
                        device="cpu").fit(coo)
    observed = _heldout_rmse(engine, coo)
    lo, hi = subset_merge.MERGE_RMSE_BAND[P]
    assert observed < 0.95 * baseline, f"P={P}: merged RMSE {observed:.4f}, baseline {baseline:.4f}"
    assert lo < observed < hi, f"P={P}: merged RMSE {observed:.4f} left the band [{lo}, {hi}]"
    bound = subset_merge.MERGE_DEGRADATION_MAX[P]
    assert observed - seq_rmse <= bound, (
        f"P={P}: merged RMSE {observed:.4f} degrades {observed - seq_rmse:.4f} over the "
        f"sequential artifact's {seq_rmse:.4f}; bound {bound}")
    served = PosteriorPredictor.load(engine.export(str(tmp_path / "art")), device="cpu")
    rows, cols = np.arange(0, 150, 3), np.arange(50) % 80
    for a, b in zip(served.predict(rows, cols, return_std=True), engine.predict(rows, cols, return_std=True)):
        np.testing.assert_array_equal(a, b)
