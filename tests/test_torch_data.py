"""The port's data layer against the JAX package's: same inputs, same layout.

For the same ``(coo, pads, seed)``, the buckets, the test set and the mean
rating equal ``repro``'s element for element, and the copied synthetic
generator gives the same ratings.
"""
import numpy as np
import pytest

from repro.data import sparse as jsparse
from repro.data.synthetic import SyntheticSpec as JSpec
from repro.data.synthetic import synthetic_ratings as j_synthetic
from repro_torch.bpmf import load_dataset
from repro_torch.data import sparse
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings


def _coo(num_users, num_movies, nnz, seed):
    coo, _ = synthetic_ratings(
        SyntheticSpec(num_users=num_users, num_movies=num_movies, nnz=nnz, seed=seed)
    )
    return coo


@pytest.mark.parametrize("spec", [
    dict(num_users=150, num_movies=80, nnz=4000, seed=7),
    dict(num_users=300, num_movies=40, nnz=5000, seed=2, discretize=False, noise_std=0.3),
])
def test_synthetic_copy_equals_reference(spec):
    ours, _ = synthetic_ratings(SyntheticSpec(**spec))
    theirs, _ = j_synthetic(JSpec(**spec))
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    assert (ours.num_users, ours.num_movies) == (theirs.num_users, theirs.num_movies)


@pytest.mark.parametrize("pads,seed", [((8, 32, 128), 0), ((4, 16), 3), ((8, 32, 128, 512, 2048), 1)])
def test_build_bpmf_data_equals_reference(pads, seed):
    coo = _coo(200, 90, 6000, seed=5)
    jcoo = jsparse.RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)
    ours = sparse.build_bpmf_data(coo, pads=pads, seed=seed)
    theirs = jsparse.build_bpmf_data(jcoo, pads=pads, seed=seed)
    for side in ("users", "movies"):
        a, b = getattr(ours, side), getattr(theirs, side)
        assert a.num_items == b.num_items
        assert len(a.buckets) == len(b.buckets)
        for ba, bb in zip(a.buckets, b.buckets):
            for f in ("item_ids", "nbr", "val", "nnz"):
                x, y = getattr(ba, f).numpy(), np.asarray(getattr(bb, f))
                assert x.dtype == y.dtype, (side, f)
                np.testing.assert_array_equal(x, y)
        assert a.total_ratings() == b.total_ratings()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours.test, f).numpy(), np.asarray(getattr(theirs.test, f)))
    assert float(ours.mean_rating) == float(theirs.mean_rating)
    assert (ours.min_rating, ours.max_rating) == (theirs.min_rating, theirs.max_rating)
    assert (ours.num_users, ours.num_movies) == (theirs.num_users, theirs.num_movies)


def test_bucket_assignment_splits_heavy_items_into_pow2_pads():
    nnz = np.array([0, 3, 8, 9, 40, 130, 700])
    got = sparse.bucket_assignment(nnz, (8, 32, 128))
    assert {p: list(v) for p, v in got.items()} == {8: [0, 1, 2], 32: [3], 128: [4], 256: [5], 1024: [6]}
    want = jsparse.bucket_assignment(nnz, (8, 32, 128))
    assert {p: list(v) for p, v in want.items()} == {p: list(v) for p, v in got.items()}


def test_dataset_registry():
    coo = load_dataset("synthetic", num_users=40, num_movies=20, nnz=300)
    assert (coo.num_users, coo.num_movies) == (40, 20) and coo.nnz <= 300
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("movielens")
