"""Sparse rating-matrix utilities: COO/CSR conversion and nnz-bucketing.

Bucketing is the SPMD replacement for the paper's work stealing: items are
grouped by rating count into power-of-two padded buckets so that each bucket
is one dense gather + Gram launch. The logic is numpy on the host, the same
as the JAX package's; only the :class:`Bucket` / :class:`TestSet` leaves
become (CPU) tensors. ``BPMFData.to(device)`` uploads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.types import BPMFData, Bucket, BucketedSide, TestSet
from repro_torch.utils import next_power_of_two


@dataclasses.dataclass(frozen=True)
class RatingsCOO:
    """Raw ratings in coordinate format (host numpy)."""

    rows: np.ndarray  # [nnz] int32 user ids
    cols: np.ndarray  # [nnz] int32 movie ids
    vals: np.ndarray  # [nnz] float32 ratings
    num_users: int
    num_movies: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def transpose(self) -> "RatingsCOO":
        """The movies x users matrix: rows and columns (and their counts) swapped."""
        return RatingsCOO(self.cols, self.rows, self.vals, self.num_movies, self.num_users)

    def chunked(self, chunk_rows: int = 1_000_000) -> "ChunkedRatings":
        """This COO as a re-iterable stream of chunks of ``chunk_rows`` ratings."""

        def gen() -> Iterator[RatingsCOO]:
            for lo in range(0, max(self.nnz, 1), chunk_rows):
                hi = min(lo + chunk_rows, self.nnz)
                if hi > lo:
                    yield RatingsCOO(
                        self.rows[lo:hi], self.cols[lo:hi], self.vals[lo:hi],
                        self.num_users, self.num_movies,
                    )

        return ChunkedRatings(
            chunk_fn=gen, num_users=self.num_users, num_movies=self.num_movies,
            nnz=self.nnz, chunk_rows=chunk_rows,
        )


@dataclasses.dataclass(frozen=True)
class ChunkedRatings:
    """Re-iterable bounded-memory rating stream with known global dims.

    ``chunk_fn`` returns a *fresh* iterator of :class:`RatingsCOO` chunks on
    every call, in a deterministic order, with at most ``chunk_rows``
    ratings each. The ring backends build each process's shards from it
    (``core.distributed.build_distributed_data_per_host``); the other
    backends materialize it.
    """

    chunk_fn: Callable[[], Iterator[RatingsCOO]]
    num_users: int
    num_movies: int
    nnz: int
    chunk_rows: int

    def chunks(self) -> Iterator[RatingsCOO]:
        return self.chunk_fn()

    def materialize(self) -> RatingsCOO:
        """Concatenate the stream into one :class:`RatingsCOO`."""
        rows, cols, vals = [], [], []
        for c in self.chunks():
            rows.append(c.rows)
            cols.append(c.cols)
            vals.append(c.vals)
        empty = np.zeros(0)
        return RatingsCOO(
            np.concatenate(rows) if rows else empty.astype(np.int32),
            np.concatenate(cols) if cols else empty.astype(np.int32),
            np.concatenate(vals) if vals else empty.astype(np.float32),
            self.num_users, self.num_movies,
        )


def csr_from_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, num_items: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, values) CSR over ``rows``; columns sorted within rows."""
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    counts = np.bincount(r, minlength=num_items)
    indptr = np.zeros(num_items + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, c.astype(np.int32), v.astype(np.float32)


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] without a python loop."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def pad_group(
    ids: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    pad: int,
) -> Bucket:
    """Densify the CSR rows ``ids`` into a [B, pad] padded bucket."""
    ids = np.asarray(ids, dtype=np.int64)
    B = len(ids)
    nnz = (indptr[ids + 1] - indptr[ids]).astype(np.int64)
    if np.any(nnz > pad):
        raise ValueError(f"item with nnz {nnz.max()} does not fit pad {pad}")
    nbr = np.zeros((B, pad), dtype=np.int32)
    val = np.zeros((B, pad), dtype=np.float32)
    within = _concat_ranges(nnz)
    flat_dst = np.repeat(np.arange(B, dtype=np.int64) * pad, nnz) + within
    src = np.repeat(indptr[ids], nnz) + within
    nbr.reshape(-1)[flat_dst] = indices[src]
    val.reshape(-1)[flat_dst] = values[src]
    return Bucket(
        item_ids=torch.from_numpy(ids.astype(np.int32)),
        nbr=torch.from_numpy(nbr),
        val=torch.from_numpy(val),
        nnz=torch.from_numpy(nnz.astype(np.int32)),
    )


def bucket_assignment(nnz: np.ndarray, pads: Sequence[int]) -> dict[int, np.ndarray]:
    """Map pad size -> item ids. Items above the largest pad get pow2 pads."""
    pads = sorted(pads)
    out: dict[int, list[np.ndarray]] = {}
    prev = -1
    for p in pads:
        sel = np.nonzero((nnz > prev) & (nnz <= p))[0]
        if sel.size:
            out.setdefault(p, []).append(sel)
        prev = p
    big = np.nonzero(nnz > pads[-1])[0]
    if big.size:
        for i in big:
            p = next_power_of_two(int(nnz[i]))
            out.setdefault(p, []).append(np.array([i]))
    return {p: np.concatenate(v) for p, v in out.items()}


def bucketize_side(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    pads: Sequence[int],
) -> BucketedSide:
    """Bucket every CSR row (item) by nnz into padded dense groups.

    Items with zero ratings still get sampled (from the prior conditional),
    so they go to the smallest bucket.
    """
    num_items = len(indptr) - 1
    nnz = (indptr[1:] - indptr[:-1]).astype(np.int64)
    assign = bucket_assignment(nnz, pads)
    buckets = [pad_group(assign[pad], indptr, indices, values, pad) for pad in sorted(assign)]
    return BucketedSide(buckets=tuple(buckets), num_items=num_items)


# Block size of StableMeanAccumulator: the mean is a function of fixed
# value-position blocks, never of the caller's chunk boundaries.
MEAN_BLOCK = 1 << 20


class StableMeanAccumulator:
    """Streaming mean whose result is independent of how the values are fed.

    Values are regrouped into fixed ``MEAN_BLOCK``-sized position blocks;
    each complete block is summed with ``np.sum(..., dtype=float64)`` and
    the block sums are combined with ``math.fsum``. Any chunking of the same
    value sequence gives the same mean, bit for bit
    ``repro.data.sparse.StableMeanAccumulator``'s.
    """

    def __init__(self) -> None:
        self._buf: list[np.ndarray] = []
        self._pending = 0
        self._sums: list[float] = []
        self._count = 0

    def add(self, vals: np.ndarray) -> "StableMeanAccumulator":
        vals = np.asarray(vals, dtype=np.float32)
        self._count += len(vals)
        self._buf.append(vals)
        self._pending += len(vals)
        if self._pending >= MEAN_BLOCK:
            cat = np.concatenate(self._buf)
            while len(cat) >= MEAN_BLOCK:
                self._sums.append(float(np.sum(cat[:MEAN_BLOCK], dtype=np.float64)))
                cat = cat[MEAN_BLOCK:]
            self._buf = [cat]
            self._pending = len(cat)
        return self

    def mean(self) -> float:
        if not self._count:
            return 0.0
        sums = list(self._sums)
        if self._pending:
            sums.append(float(np.sum(np.concatenate(self._buf), dtype=np.float64)))
        return math.fsum(sums) / self._count


def stable_mean(vals: np.ndarray) -> float:
    """The training mean that ``build_distributed_data`` centers on.

    Chunking-invariant (:class:`StableMeanAccumulator`): bitwise
    ``repro.data.sparse.stable_mean``.
    """
    return StableMeanAccumulator().add(vals).mean()


def train_test_split(
    coo: RatingsCOO, test_fraction: float, seed: int
) -> tuple[RatingsCOO, RatingsCOO]:
    rng = np.random.default_rng(seed)
    t = rng.random(coo.nnz) < test_fraction
    tr = ~t
    return (
        RatingsCOO(coo.rows[tr], coo.cols[tr], coo.vals[tr], coo.num_users, coo.num_movies),
        RatingsCOO(coo.rows[t], coo.cols[t], coo.vals[t], coo.num_users, coo.num_movies),
    )


def build_bpmf_data(
    coo: RatingsCOO,
    pads: Sequence[int] = (8, 32, 128, 512, 2048),
    test_fraction: float = 0.1,
    seed: int = 0,
    min_rating: float | None = None,
    max_rating: float | None = None,
) -> BPMFData:
    """Full host-side pipeline: split, center, bucket both sides.

    Ratings are centered on the training mean; predictions clip to
    ``[min_rating, max_rating]``, by default the range of all ratings.
    """
    train, test = train_test_split(coo, test_fraction, seed)
    lo = float(coo.vals.min()) if min_rating is None else min_rating
    hi = float(coo.vals.max()) if max_rating is None else max_rating
    return build_bpmf_data_presplit(train, test, pads, min_rating=lo, max_rating=hi)


def build_bpmf_data_presplit(
    train: RatingsCOO,
    test: RatingsCOO,
    pads: Sequence[int] = (8, 32, 128, 512, 2048),
    mean_rating: float | None = None,
    min_rating: float | None = None,
    max_rating: float | None = None,
) -> BPMFData:
    """Center and bucket an already-split (train, test) pair.

    The split-free tail of :func:`build_bpmf_data`, for callers that
    partition the ratings *after* one global split: the ``posterior_merge``
    backend gives each chain a user subset of it, centered and clipped
    globally (pass the global ``mean_rating`` / ``min_rating`` /
    ``max_rating``; by default they derive from the pair given).
    """
    mean = (
        (float(train.vals.mean()) if train.nnz else 0.0)
        if mean_rating is None
        else float(mean_rating)
    )
    centered = train.vals - mean
    u_indptr, u_idx, u_val = csr_from_coo(train.rows, train.cols, centered, train.num_users)
    m_indptr, m_idx, m_val = csr_from_coo(train.cols, train.rows, centered, train.num_movies)

    all_vals = np.concatenate([train.vals, test.vals]) if train.nnz or test.nnz else None
    lo = (float(all_vals.min()) if all_vals is not None else -np.inf) \
        if min_rating is None else min_rating
    hi = (float(all_vals.max()) if all_vals is not None else np.inf) \
        if max_rating is None else max_rating
    return BPMFData(
        users=bucketize_side(u_indptr, u_idx, u_val, pads),
        movies=bucketize_side(m_indptr, m_idx, m_val, pads),
        test=TestSet(
            rows=torch.from_numpy(np.asarray(test.rows, np.int32)),
            cols=torch.from_numpy(np.asarray(test.cols, np.int32)),
            vals=torch.from_numpy(np.asarray(test.vals, np.float32)),
        ),
        mean_rating=torch.tensor(mean, dtype=torch.float32),
        num_users=train.num_users,
        num_movies=train.num_movies,
        min_rating=lo,
        max_rating=hi,
    )
