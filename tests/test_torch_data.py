"""The port's data layer against the JAX package's: same inputs, same layout.

For the same ``(coo, pads, seed)``, the buckets, the test set and the mean
rating equal ``repro``'s element for element (also through the split-free
``build_bpmf_data_presplit`` with a mean passed in), and the copied
synthetic generator gives the same ratings.

The loaders: the same small MovieLens (``ratings.csv``, ``u.data``) and
ChEMBL files, written here, give ``repro``'s arrays through the port's
one-shot and chunked loaders (tests/test_movielens.py's cases: chunk sizes,
compacted ids, trailing blank lines, an empty file), and the streaming
mean is independent of the chunking and bit for bit ``repro``'s.
"""
import numpy as np
import pytest

from repro.data import movielens as jmovielens
from repro.data import sparse as jsparse
from repro.data.synthetic import SyntheticSpec as JSpec
from repro.data.synthetic import synthetic_ratings as j_synthetic
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.data import movielens, sparse
from repro_torch.data.synthetic import SyntheticSpec, sorted_unique, synthetic_ratings, weighted_choice


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


@pytest.mark.parametrize("n,size,seed", [(1, 5, 0), (7, 1000, 1), (27_278, 200_000, 2)])
def test_weighted_choice_equals_numpy(n, size, seed):
    """The same draws as ``Generator.choice`` with ``p``, and the generator left in the same state."""
    p = np.random.default_rng(seed).lognormal(sigma=1.0, size=n)
    p /= p.sum()
    ours, theirs = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    got = weighted_choice(ours, p, size)
    want = theirs.choice(n, size=size, p=p).astype(np.int64)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert ours.random() == theirs.random()


@pytest.mark.parametrize("n,high", [(0, 5), (1, 5), (1000, 7), (100_000, 2**40)])
def test_sorted_unique_equals_numpy(n, high):
    keys = np.random.default_rng(n).integers(0, high, size=n, dtype=np.int64)
    got = sorted_unique(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.unique(keys))


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


def _equal_coo(got, want) -> None:
    for f in ("rows", "cols", "vals"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert (got.num_users, got.num_movies, got.nnz) == (want.num_users, want.num_movies, want.nnz)


def test_dataset_registry(ratings_csv, chembl_csv):
    coo = load_dataset("synthetic", num_users=40, num_movies=20, nnz=300)
    assert (coo.num_users, coo.num_movies) == (40, 20) and coo.nnz <= 300
    # the real-file loaders are registered and load the reference's arrays
    _equal_coo(load_dataset("movielens", path=ratings_csv), jmovielens.load_movielens(ratings_csv))
    _equal_coo(load_dataset("chembl", path=chembl_csv), jmovielens.load_chembl(chembl_csv))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("netflix")


def _presplit_pair(seed: int):
    coo = _coo(120, 50, 3000, seed=seed)
    train, test = sparse.train_test_split(coo, 0.2, seed)
    return coo, train, test


@pytest.mark.parametrize("mean", [None, 3.25])
def test_build_bpmf_data_presplit_equals_reference(mean):
    coo, train, test = _presplit_pair(4)
    jtrain, jtest = jsparse.train_test_split(
        jsparse.RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies), 0.2, 4)
    kw = dict(pads=(8, 32), mean_rating=mean)
    ours = sparse.build_bpmf_data_presplit(train, test, **kw)
    theirs = jsparse.build_bpmf_data_presplit(jtrain, jtest, **kw)
    for side in ("users", "movies"):
        for ba, bb in zip(getattr(ours, side).buckets, getattr(theirs, side).buckets):
            for f in ("item_ids", "nbr", "val", "nnz"):
                x, y = getattr(ba, f).numpy(), np.asarray(getattr(bb, f))
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert float(ours.mean_rating) == float(theirs.mean_rating)
    assert (ours.min_rating, ours.max_rating) == (theirs.min_rating, theirs.max_rating)


# ---------- the MovieLens and ChEMBL loaders ----------

_CSV_ROWS = [
    # userId, movieId, rating: ids sparse and unsorted on purpose
    (7, 31, 4.0), (2, 17, 3.5), (7, 17, 5.0), (900, 31, 1.0),
    (2, 1000, 2.0), (3, 17, 4.5), (7, 1000, 0.5),
]


def _csv_text(trailing: str = "\n") -> str:
    lines = ["userId,movieId,rating,timestamp"]
    lines += [f"{u},{m},{r},11{i}" for i, (u, m, r) in enumerate(_CSV_ROWS)]
    return "\n".join(lines) + trailing


@pytest.fixture
def ratings_csv(tmp_path):
    path = tmp_path / "ratings.csv"
    path.write_text(_csv_text())
    return str(path)


@pytest.fixture
def chembl_csv(tmp_path):
    path = tmp_path / "chembl.csv"
    path.write_text("0,2,6.5\n3,0,7.25\n1,1,5.0\n3,2,8.0\n")
    return str(path)


@pytest.mark.parametrize("chunk_rows", [1, 3, 1000])
def test_movielens_csv_one_shot_and_chunked_equal_reference(ratings_csv, chunk_rows):
    """Every chunk size (one row, part of the file, all of it) gives the
    reference's arrays, one-shot and streamed, with compacted ids."""
    want = jmovielens._parse_ratings_csv(ratings_csv, chunk_rows=chunk_rows)
    got = movielens._parse_ratings_csv(ratings_csv, chunk_rows=chunk_rows)
    _equal_coo(got, want)
    assert (got.num_users, got.num_movies) == (4, 3)  # users {2, 3, 7, 900}, movies {17, 31, 1000}
    stream = movielens.load_movielens_chunked(ratings_csv, chunk_rows=chunk_rows)
    want_stream = jmovielens.load_movielens_chunked(ratings_csv, chunk_rows=chunk_rows)
    assert (stream.num_users, stream.num_movies, stream.nnz) == (want_stream.num_users,
                                                                  want_stream.num_movies, want_stream.nnz)
    chunks = list(stream.chunks())
    assert len(chunks) == -(-len(_CSV_ROWS) // chunk_rows)
    for a, b in zip(chunks, want_stream.chunks()):
        _equal_coo(a, b)
    _equal_coo(stream.materialize(), got)  # the chunked id map is the one-shot np.unique's


def test_movielens_udata_equals_reference(tmp_path):
    path = tmp_path / "u.data"
    path.write_text("1\t5\t3.0\t881250949\n2\t3\t4.0\t881250950\n1\t3\t1.0\t881250951\n")
    for chunk_rows in (2, 1000):
        got = movielens._parse_udata(str(path), chunk_rows=chunk_rows)
        _equal_coo(got, jmovielens._parse_udata(str(path), chunk_rows=chunk_rows))
        assert (got.num_users, got.num_movies, got.nnz) == (2, 5, 3)
        _equal_coo(movielens.load_movielens_chunked(str(path), chunk_rows=chunk_rows).materialize(), got)
    _equal_coo(movielens.load_movielens(str(path)), jmovielens.load_movielens(str(path)))


def test_movielens_trailing_blank_lines_and_empty_file(tmp_path):
    path = tmp_path / "ratings.csv"
    path.write_text(_csv_text("\n\n\n"))
    got = movielens._parse_ratings_csv(str(path), chunk_rows=len(_CSV_ROWS))
    _equal_coo(got, jmovielens._parse_ratings_csv(str(path), chunk_rows=len(_CSV_ROWS)))
    assert got.nnz == len(_CSV_ROWS)
    assert movielens.load_movielens_chunked(str(path), chunk_rows=len(_CSV_ROWS)).materialize().nnz == got.nnz
    empty = tmp_path / "empty.csv"
    empty.write_text("userId,movieId,rating,timestamp\n")
    for load in (movielens._parse_ratings_csv, movielens.load_movielens_chunked):
        with pytest.raises(ValueError, match="no ratings"):
            load(str(empty))


def test_chembl_and_dispatch_equal_reference(ratings_csv, chembl_csv):
    _equal_coo(movielens.load_movielens(ratings_csv), jmovielens.load_movielens(ratings_csv))
    got = movielens.load_chembl(chembl_csv)
    _equal_coo(got, jmovielens.load_chembl(chembl_csv))
    assert (got.num_users, got.num_movies, got.nnz) == (4, 3, 4)


def test_chunked_ratings_materialize_and_engine_accepts_them():
    coo = _coo(60, 30, 600, seed=1)
    for chunk_rows in (1, 7, 10_000):
        stream = coo.chunked(chunk_rows)
        assert stream.nnz == coo.nnz and stream.chunk_rows == chunk_rows
        assert all(c.nnz <= chunk_rows for c in stream.chunks())
        _equal_coo(stream.materialize(), coo)
        want = jsparse.RatingsCOO(coo.rows, coo.cols, coo.vals, 60, 30).chunked(chunk_rows)
        for a, b in zip(stream.chunks(), want.chunks()):
            _equal_coo(a, b)
    cfg = BPMFConfig().replace(K=4, num_sweeps=2, burn_in=1, bucket_pads=(8, 32))
    for name in ("sequential", "posterior_merge"):
        a = BPMFEngine(cfg.replace(name=name, num_partitions=2), device="cpu").fit(coo.chunked(50))
        b = BPMFEngine(cfg.replace(name=name, num_partitions=2), device="cpu").fit(coo)
        assert a.history == b.history


@pytest.mark.parametrize("sizes", [(5,), (1, 1, 3), (2 ** 20 + 3,), (2 ** 19, 2 ** 19 + 5, 7)])
def test_stable_mean_accumulator_is_chunking_invariant_and_equals_reference(sizes):
    rng = np.random.default_rng(len(sizes))
    vals = rng.uniform(0.5, 5.0, sum(sizes)).astype(np.float32)
    acc, jacc = sparse.StableMeanAccumulator(), jsparse.StableMeanAccumulator()
    lo = 0
    for n in sizes:
        acc.add(vals[lo:lo + n])
        jacc.add(vals[lo:lo + n])
        lo += n
    assert acc.mean() == jacc.mean() == sparse.stable_mean(vals) == jsparse.stable_mean(vals)
    assert sparse.StableMeanAccumulator().mean() == 0.0
