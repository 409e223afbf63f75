"""The yardstick on the CPU: the reference's draws, rankings and counts, its control, and the faults it catches."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import datagen, work
from perfbench.reference import bpmf as ref
from perfbench.reference import rng
from perfbench.reference import topk as ref_topk
from perfbench.tests import tiny
from perfbench.windows import gibbs, topk

CPU = tiny.CPU


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, counter, want):
    k0, k1 = (torch.tensor(x, dtype=torch.int64) for x in key)
    got = rng.threefry(k0, k1, torch.tensor(counter[0]), torch.tensor(counter[1]))
    assert tuple(int(x) for x in got) == want


def test_variates_are_the_programs_bit_for_bit():
    from repro_torch.core import prng

    k = rng.fold_in(rng.split(rng.key(tiny.SEED, CPU))[1], 7)
    assert torch.equal(k, prng.fold_in(prng.split(prng.key(tiny.SEED))[1], 7))
    ids = torch.arange(50)
    assert torch.equal(rng.normal(rng.fold_in(k, ids), (8,)), prng.normal(prng.fold_in(k, ids), (8,)))
    assert torch.equal(rng.uniform(k, (300,)), prng.uniform(k, (300,)))
    shapes = torch.tensor([0.3, 1.0, 2.5, 69262.0, 241766.5])
    assert torch.equal(rng.gamma(k, shapes), prng.gamma(k, shapes).reshape(-1))


def test_frozen_generator_is_the_programs_and_keeps_its_shape():
    from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings

    spec = {"num_users": 300, "num_movies": 90, "nnz": 3000, "true_rank": 8, "noise_std": 0.5,
            "popularity_exponent": 0.8, "activity_sigma": 1.0, "discretize": True}
    rows, cols, vals = datagen.ratings(spec, tiny.SEED)
    coo, _ = synthetic_ratings(SyntheticSpec(**spec, seed=tiny.SEED))
    assert np.array_equal(rows, coo.rows) and np.array_equal(cols, coo.cols) and np.array_equal(vals, coo.vals)
    assert len(rows) == 3000 and len(np.unique(rows.astype(np.int64) * 90 + cols)) == 3000
    assert set(np.unique(vals)) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    again = datagen.ratings(spec, tiny.SEED)
    assert all(np.array_equal(a, b) for a, b in zip((rows, cols, vals), again))
    assert not np.array_equal(datagen.ratings(spec, tiny.SEED + 1)[0], rows)


def test_work_counts_by_hand():
    # 10 ratings, 2 items, 3 opposite rows, K = 4: ids and values 80 B, nnz 8 B,
    # X 48 B, G and g 2 * 20 * 4 = 160 B; 10 * 4 * 7 flops
    assert work.gram_work(10, 2, 3, 4) == (296.0, 280.0)
    # both sides of 10 ratings over 3 users and 2 movies
    assert work.sweep_gram_need(10, 3, 2, 4) == (296.0 + 8 * 10 + 12 + 32 + 240, 560.0)
    # K = 3: Cholesky 9, precision and solves 36, linear term and sum 6
    assert work.row_draw_flops(3) == 51.0
    assert work.sweep_flops(10, 5, 3, 2, 3) == 10 * 3 * 6 * 2 + 5 * 51 + 2 * 5 * 9 + 2 * 5 * 3
    assert work.topk_flops(4096, 27278, 32) == 2.0 * 4096 * 27278 * 32
    assert work.roofline_s(3.35e12, 67e12, "NVIDIA H100 80GB HBM3") == 1.0
    assert work.roofline_s(1.0, 1.0, "a card not in the table") is None


def test_top_k_reference_by_hand():
    U = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    V = torch.tensor([[3.0, 0.0], [1.0, 0.0], [5.0, 0.0], [6.0, 0.0], [2.0, 0.0]], dtype=torch.float64)
    ids, vals = ref_topk.rank(U, V, 0.0, 1.0, 4.0, 3, ref.REFERENCE)
    assert ids.tolist() == [[2, 3, 0]] and vals.tolist() == [[4.0, 4.0, 3.0]]
    ok = ref_topk.check(ids, vals, U, V, 0.0, 1.0, 4.0, 1e-3)
    assert ok == {"topk_score_gap": 0.0, "topk_value_gap": 0.0, "topk_order_errors": 0.0}
    swapped = ref_topk.check(torch.tensor([[3, 2, 0]]), vals, U, V, 0.0, 1.0, 4.0, 1e-3)
    assert swapped["topk_order_errors"] == 2.0 and swapped["topk_score_gap"] == 0.0
    wrong = ref_topk.check(torch.tensor([[2, 3, 4]]), torch.tensor([[4.0, 4.0, 2.0]]), U, V, 0.0, 1.0, 4.0, 1e-3)
    assert wrong["topk_score_gap"] == 1.0 and wrong["topk_order_errors"] == 0.0
    repeated = ref_topk.check(torch.tensor([[2, 2, 0]]), vals, U, V, 0.0, 1.0, 4.0, 1e-3)
    assert repeated["topk_order_errors"] >= 1.0


def test_one_conditional_draw_by_hand():
    """An item's draw is N(P^-1 l, P^-1): P = Lambda + alpha sum x x^T, l = Lambda mu + alpha sum x r."""
    gen = np.random.default_rng(3)
    K, alpha = 3, 2.0
    X = torch.from_numpy(gen.normal(size=(4, K)))
    side = ref.Side(item=torch.tensor([0, 0, 1]), nbr=torch.tensor([1, 3, 2]),
                    val=torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64), num_items=2)
    A = gen.normal(size=(K, K))
    Lam, mu = torch.from_numpy(A @ A.T + K * np.eye(K)), torch.from_numpy(gen.normal(size=K))
    key = rng.key(11, CPU)
    got = ref.update_side(key, X, side, mu, Lam, alpha, ref.REFERENCE)
    z = rng.normal(rng.fold_in(key, torch.arange(2)), (K,)).double().numpy()
    x = X.numpy()
    for i, (nbrs, vals) in enumerate((([1, 3], [0.5, -1.0]), ([2], [2.0]))):
        P = Lam.numpy() + alpha * x[nbrs].T @ x[nbrs]
        lin = Lam.numpy() @ mu.numpy() + alpha * x[nbrs].T @ np.asarray(vals)
        L = np.linalg.cholesky(P)
        want = np.linalg.solve(P, lin) + np.linalg.solve(L.T, z[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-12, atol=1e-12)


def _tiny_ctx(name: str):
    import time

    from perfbench import bench

    return bench.Context(tiny.cell(name), tiny.SEED, 0.0, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", ["ml20m.gibbs", "chembl.gibbs"])
def test_control_fails_the_sweep_limits(name):
    ctx = _tiny_ctx(name)
    ratings = datagen.ratings(ctx.cell.config["data"], ctx.seed)
    got = gibbs.compare(gibbs.reference(ctx, ratings, ref.CONTROL), gibbs.reference(ctx, ratings))
    assert any(v > ctx.cell.limits[k] for k, v in got.items())


def test_control_fails_the_top_k_limits():
    ctx = _tiny_ctx("ml20m.topk")
    t = ctx.cell.traffic
    predictor, batches, factors = topk.start(ctx)
    results = [(b, *predictor.top_k(batches[b], t["k"])) for b in range(len(batches))]
    lo, hi = t["rating_range"]
    got = topk.compare(ctx, results, batches, factors,
                       ranked=lambda U, V: ref_topk.rank(U, V, t["mean_rating"], lo, hi, t["k"], ref.CONTROL))
    assert any(v > ctx.cell.limits[k] for k, v in got.items())


def _unchanged(monkeypatch):
    from repro_torch.bpmf import backends

    for cls in (backends.SequentialBackend, backends.DistributedBackend):
        orig = cls._sweep
        monkeypatch.setattr(cls, "_sweep", lambda self, key, carry, orig=orig: (carry, orig(self, key, carry)[1]))


def _half_the_rows(monkeypatch):
    from repro_torch.core import distributed, hyper

    orig = hyper.hyper_sufficient_stats

    def half(X, weights=None):
        n = X.shape[0] // 2
        stats = orig(X[:n], None if weights is None else weights[:n])
        scale = (X.shape[0] if weights is None else weights.sum()) / stats[0]
        return stats[0] * scale, stats[1] * scale, stats[2] * scale

    monkeypatch.setattr(hyper, "hyper_sufficient_stats", half)
    monkeypatch.setattr(distributed, "hyper_sufficient_stats", half)


def _half_the_rank(monkeypatch):
    from repro_torch.serve import predictor

    orig = predictor._catalog_scores
    monkeypatch.setattr(predictor, "_catalog_scores",
                        lambda u, Vt: 2.0 * orig(u[:, : u.shape[1] // 2], Vt[: u.shape[1] // 2]))


def _no_exchange(monkeypatch):
    from repro_torch.core import distributed

    monkeypatch.setattr(distributed.Ring, "rotate", lambda self, bufs: list(bufs))


def _altered_draw(monkeypatch):
    from repro_torch.core import posterior

    orig = posterior.sample_from_terms

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        return torch.cat([out[:1] + 0.5, out[1:]])

    monkeypatch.setattr(posterior, "sample_from_terms", altered)


def _altered_list(monkeypatch):
    from repro_torch.serve.predictor import PosteriorPredictor

    orig = PosteriorPredictor.top_k

    def altered(self, user, k, sharded=None):
        ids, vals = orig(self, user, k, sharded)
        ids = ids.copy()
        ids[0, 0] = ids[0, -1]
        return ids, vals

    monkeypatch.setattr(PosteriorPredictor, "top_k", altered)


FAULTS = {
    "ml20m.gibbs": (_unchanged, _half_the_rows, _altered_draw),
    "chembl.gibbs": (_unchanged, _half_the_rows, _altered_draw),
    "ml20m.ring4": (_unchanged, _half_the_rows, _no_exchange, _altered_draw),
    "ml20m.topk": (_half_the_rank, _altered_list),
}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs],
                         ids=[f"{n}-{f.__name__[1:]}" for n, fs in FAULTS.items() for f in fs])
def test_a_broken_program_reads_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run(name)
    assert out["correct"] is False
