"""Load balancing and data distribution (paper §IV-B).

The paper balances work across nodes with a workload model — "fixed cost
plus a cost per rating" — and reorders rows/columns of R so each node owns a
contiguous, equally-costly region. Across the ring's shards the same two
ideas become:

  * cost model  c(item) = a + b * nnz(item)   (coefficients fit from the
    fig2 microbenchmark, mirroring the paper's Figure 2 methodology);
  * a partition of items into S shards minimizing the max shard cost —
    either `block` (contiguous ranges, maximal rating locality, the paper's
    reordering) or `lpt` (greedy longest-processing-time, tightest balance);
  * a relabeling permutation so shard s owns the contiguous id range
    [s*cap, s*cap + |shard s|) — this *is* the paper's row/column reorder.

A numpy copy of ``repro.core.balance`` (the port imports nothing of the
JAX package): the same partitions, permutations, capacities and loads.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """c(item) = fixed + per_rating * nnz. Defaults from the fig2 fit."""

    fixed: float = 1.0
    per_rating: float = 0.02

    def cost(self, nnz: np.ndarray) -> np.ndarray:
        return self.fixed + self.per_rating * nnz.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Result of partitioning one side's items across S shards."""

    shards: list[np.ndarray]  # original item ids per shard
    perm: np.ndarray  # old id -> new global id (= shard * cap + slot)
    inv_perm: np.ndarray  # new global id -> old id (pad slots = -1)
    cap: int  # padded per-shard capacity
    loads: np.ndarray  # [S] cost per shard

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def balance_ratio(self) -> float:
        """max/mean shard cost; 1.0 = perfectly balanced."""
        return float(self.loads.max() / max(self.loads.mean(), 1e-12))


def lpt_partition(costs: np.ndarray, num_shards: int) -> list[np.ndarray]:
    """Greedy longest-processing-time: items sorted by cost desc onto min-loaded shard."""
    order = np.argsort(-costs, kind="stable")
    assign = np.zeros(len(costs), dtype=np.int64)
    # heap-based greedy is O(n log S); fine at ChEMBL scale (~500k items, <1s)
    heap = [(0.0, s) for s in range(num_shards)]
    heapq.heapify(heap)
    for i in order:
        load, s = heapq.heappop(heap)
        assign[i] = s
        heapq.heappush(heap, (load + costs[i], s))
    return [np.nonzero(assign == s)[0] for s in range(num_shards)]


def block_partition(costs: np.ndarray, num_shards: int) -> list[np.ndarray]:
    """Contiguous ranges with near-equal cumulative cost (paper's reordering)."""
    cum = np.cumsum(costs)
    total = cum[-1]
    bounds = np.searchsorted(cum, total * np.arange(1, num_shards) / num_shards)
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(costs)]])
    return [np.arange(s, e) for s, e in zip(starts, ends)]


def partition_items(
    nnz: np.ndarray,
    num_shards: int,
    cost_model: CostModel | None = None,
    strategy: str = "lpt",
    cap_multiple: int = 8,
) -> Partition:
    """Partition + relabel one side's items.

    ``cap`` (slots per shard) is the max shard size rounded up so every shard
    has identical padded length — required for SPMD. Pad slots map to no
    original item (inv_perm = -1) and behave like rating-less items.
    """
    cost_model = cost_model or CostModel()
    costs = cost_model.cost(nnz)
    if strategy == "lpt":
        shards = lpt_partition(costs, num_shards)
    elif strategy == "block":
        shards = block_partition(costs, num_shards)
    elif strategy == "naive":  # uniform contiguous split, ignores cost (baseline)
        shards = [a for a in np.array_split(np.arange(len(nnz)), num_shards)]
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    cap = max(len(s) for s in shards)
    cap = ((cap + cap_multiple - 1) // cap_multiple) * cap_multiple
    perm = np.full(len(nnz), -1, dtype=np.int64)
    inv = np.full(num_shards * cap, -1, dtype=np.int64)
    loads = np.zeros(num_shards)
    for s, ids in enumerate(shards):
        perm[ids] = s * cap + np.arange(len(ids))
        inv[s * cap : s * cap + len(ids)] = ids
        loads[s] = costs[ids].sum()
    return Partition(shards=shards, perm=perm, inv_perm=inv, cap=cap, loads=loads)


def fit_cost_model(nnz_samples: np.ndarray, times: np.ndarray) -> CostModel:
    """Least-squares fit of (fixed, per_rating) from measured update times.

    Mirrors the paper's Figure 2: measure time-to-update-one-item vs nnz,
    regress a line, use it to weigh items during partitioning.
    """
    A = np.stack([np.ones_like(nnz_samples, dtype=np.float64), nnz_samples.astype(np.float64)], 1)
    coef, *_ = np.linalg.lstsq(A, times.astype(np.float64), rcond=None)
    return CostModel(fixed=max(float(coef[0]), 1e-9), per_rating=max(float(coef[1]), 1e-12))
