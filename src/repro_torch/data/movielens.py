"""MovieLens / ChEMBL loaders, with a synthetic stand-in when no file is given.

``load_movielens`` parses the ml-20m ``ratings.csv`` or ml-100k ``u.data``
formats when a path is given; otherwise it generates a
distribution-matched synthetic stand-in (DESIGN.md §6). Parsing goes in
chunks of ``chunk_rows`` lines, so the transient memory is bounded by the
chunk and not by the file. A numpy copy of ``repro.data.movielens``: the
same files give the same arrays.
"""
from __future__ import annotations

import itertools
import os

import numpy as np

from repro_torch.data.sparse import ChunkedRatings, RatingsCOO
from repro_torch.data.synthetic import CHEMBL_LIKE, ML20M_LIKE, ML100K_LIKE, synthetic_ratings
from repro_torch.utils import logger

_CSV_CHUNK_ROWS = 1_000_000  # ~72 MB peak per chunk against GBs for a one-shot parse


def _iter_rating_chunks(path: str, *, delimiter: str | None, skip_header: int, chunk_rows: int):
    """Yield ``(col0, col1, vals)`` raw-id chunks of a 3+-column rating file.

    Chunk boundaries are deterministic: every ``chunk_rows`` source lines,
    blank lines dropped.
    """
    with open(path) as f:
        for _ in range(skip_header):
            f.readline()
        while True:
            lines = list(itertools.islice(f, chunk_rows))
            if not lines:
                break
            lines = [ln for ln in lines if ln.strip()]
            if not lines:  # a chunk of blank lines (e.g. trailing newlines)
                continue
            chunk = np.atleast_2d(
                np.genfromtxt(lines, delimiter=delimiter, usecols=(0, 1, 2), dtype=np.float64)
            )
            if chunk.size == 0:
                continue
            yield (
                chunk[:, 0].astype(np.int64),
                chunk[:, 1].astype(np.int64),
                chunk[:, 2].astype(np.float32),
            )


def _read_rating_chunks(
    path: str, *, delimiter: str | None, skip_header: int, chunk_rows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`_iter_rating_chunks` joined: ``(col0, col1, vals)``, raw int64 ids and float32 ratings.

    Raises:
        ValueError: The file holds no rating.
    """
    id0, id1, vals = [], [], []
    for c0, c1, v in _iter_rating_chunks(
        path, delimiter=delimiter, skip_header=skip_header, chunk_rows=chunk_rows
    ):
        id0.append(c0)
        id1.append(c1)
        vals.append(v)
    if not id0:
        raise ValueError(f"no ratings parsed from {path!r}")
    return np.concatenate(id0), np.concatenate(id1), np.concatenate(vals)


def _parse_ratings_csv(path: str, chunk_rows: int = _CSV_CHUNK_ROWS) -> RatingsCOO:
    """ml-20m ratings.csv: userId,movieId,rating,timestamp (with header); ids compacted."""
    users_raw, movies_raw, vals = _read_rating_chunks(
        path, delimiter=",", skip_header=1, chunk_rows=chunk_rows
    )
    _, users = np.unique(users_raw, return_inverse=True)
    _, movies = np.unique(movies_raw, return_inverse=True)
    return RatingsCOO(
        users.astype(np.int32), movies.astype(np.int32), vals,
        int(users.max()) + 1, int(movies.max()) + 1,
    )


def _parse_udata(path: str, chunk_rows: int = _CSV_CHUNK_ROWS) -> RatingsCOO:
    """ml-100k u.data: user \\t item \\t rating \\t timestamp, 1-based ids."""
    users_raw, movies_raw, vals = _read_rating_chunks(
        path, delimiter=None, skip_header=0, chunk_rows=chunk_rows
    )
    users = users_raw - 1
    movies = movies_raw - 1
    return RatingsCOO(
        users.astype(np.int32), movies.astype(np.int32), vals,
        int(users.max()) + 1, int(movies.max()) + 1,
    )


def _synthetic_movielens(variant: str) -> RatingsCOO:
    logger.info("movielens file not found, generating %s-shaped synthetic data", variant)
    coo, _ = synthetic_ratings(ML20M_LIKE if variant == "ml-20m" else ML100K_LIKE)
    return coo


def load_movielens_chunked(
    path: str | None = None, variant: str = "ml-100k", chunk_rows: int = _CSV_CHUNK_ROWS
) -> ChunkedRatings:
    """A :class:`ChunkedRatings` stream over a rating file, without its full arrays.

    A first pass over the file derives the global id maps (the sorted raw
    ids, equal to ``np.unique``'s inverse in the one-shot loader) and the
    rating count; the stream re-reads the file in chunks on every
    iteration and remaps each chunk's ids. Without a file, the synthetic
    stand-in in chunks.

    Raises:
        ValueError: The file holds no rating.
    """
    if not (path and os.path.exists(path)):
        return _synthetic_movielens(variant).chunked(chunk_rows)

    is_csv = path.endswith(".csv")
    delimiter = "," if is_csv else None
    skip_header = 1 if is_csv else 0

    uniq_u = np.zeros(0, dtype=np.int64)
    uniq_m = np.zeros(0, dtype=np.int64)
    nnz = 0
    for c0, c1, _ in _iter_rating_chunks(
        path, delimiter=delimiter, skip_header=skip_header, chunk_rows=chunk_rows
    ):
        uniq_u = np.union1d(uniq_u, c0)
        uniq_m = np.union1d(uniq_m, c1)
        nnz += len(c0)
    if not nnz:
        raise ValueError(f"no ratings parsed from {path!r}")

    if is_csv:  # ml-20m: dense remap through the sorted id set (np.unique's inverse)
        num_users, num_movies = len(uniq_u), len(uniq_m)

        def remap(c0, c1):
            return (
                np.searchsorted(uniq_u, c0).astype(np.int32),
                np.searchsorted(uniq_m, c1).astype(np.int32),
            )
    else:  # ml-100k u.data: 1-based ids, already dense
        num_users, num_movies = int(uniq_u.max()), int(uniq_m.max())

        def remap(c0, c1):
            return (c0 - 1).astype(np.int32), (c1 - 1).astype(np.int32)

    def gen():
        for c0, c1, v in _iter_rating_chunks(
            path, delimiter=delimiter, skip_header=skip_header, chunk_rows=chunk_rows
        ):
            rows, cols = remap(c0, c1)
            yield RatingsCOO(rows, cols, v, num_users, num_movies)

    return ChunkedRatings(
        chunk_fn=gen, num_users=num_users, num_movies=num_movies, nnz=nnz, chunk_rows=chunk_rows,
    )


def load_movielens(path: str | None = None, variant: str = "ml-100k") -> RatingsCOO:
    """The ratings of an ml-20m ``ratings.csv`` or ml-100k ``u.data`` file, or the synthetic stand-in."""
    if path and os.path.exists(path):
        if path.endswith(".csv"):
            return _parse_ratings_csv(path)
        return _parse_udata(path)
    return _synthetic_movielens(variant)


def load_chembl(path: str | None = None) -> RatingsCOO:
    """ChEMBL IC50 subset: ``compound,target,pIC50`` rows of 0-based ids. Synthetic stand-in without a file."""
    if path and os.path.exists(path):
        data = np.loadtxt(path, delimiter=",", dtype=np.float64)
        rows = data[:, 0].astype(np.int32)
        cols = data[:, 1].astype(np.int32)
        vals = data[:, 2].astype(np.float32)
        return RatingsCOO(rows, cols, vals, int(rows.max()) + 1, int(cols.max()) + 1)
    logger.info("chembl file not found, generating ChEMBL-shaped synthetic data")
    coo, _ = synthetic_ratings(CHEMBL_LIKE)
    return coo
