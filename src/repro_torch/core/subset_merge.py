"""Subset-posterior partitioning and merge for the ``posterior_merge`` backend.

The limited-communication regime of "Distributed Bayesian Matrix
Factorization with Limited Communication" (arXiv:1703.00734) and its HPC
implementation (arXiv:2004.02561), DESIGN.md §12: partition the ratings by
user block, run one independent Gibbs chain per partition (no bytes move
between chains while they sample), and combine the subset posteriors once,
at export.

* One global train/test split and centering first, shared with every other
  backend, so "posterior_merge against sequential" compares inference, not
  data.
* Users go to partitions by the ring's nnz cost model
  (:func:`repro_torch.core.balance.partition_items`); each chain sees *all*
  movies but only its users' ratings.

The merge treats each subset posterior as a Gaussian with the diagonal
covariance of the chain's retained sample window. The movie factors, the
only ones more than one chain samples, merge as the precision-weighted
product of the subset Gaussians (``w_c = lambda_c / sum lambda``, the same
weights for the mean and each retained draw, per consensus Monte Carlo);
user factors scatter from their one owning chain. ``"pool"``, and the
fallback when a chain holds fewer than two window samples, weighs the
chains uniformly. Before combining, each chain is rotated onto chain 0's
latent orientation by orthogonal Procrustes of its posterior-mean ``V``:
BPMF's likelihood is invariant under a joint rotation of ``(U, V)``, so
independent chains drift apart in orientation, and the rotation leaves each
chain's own predictions ``(U R)(V R)^T = U V^T`` unchanged.

The merge math is numpy float64 on the host, as in the JAX package (a
copy of ``repro.core.subset_merge``, which this package does not import):
it runs once per export and costs one ``K x K`` SVD per chain.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import balance, prng
from repro_torch.core.types import PosteriorAccum, _Movable
from repro_torch.data.sparse import RatingsCOO, train_test_split

MERGE_METHODS = ("precision", "pool")

# variance regularizer: keeps 1/var finite for factors the window happens to
# hold (numerically) constant, without visibly biasing real spread estimates
MERGE_EPS = 1e-6

#: The JAX package's recorded bands for its synthetic reference task
#: (150 users x 80 movies, nnz=4000, noise_std=0.3, data seed 7; K=8,
#: 10 sweeps, burn_in=3, keep_factor_samples=4, run seed 0): the merged
#: artifact's RMSE per partition count.
MERGE_RMSE_BAND = {2: (0.70, 0.95), 4: (0.72, 0.97)}
#: Most the merged artifact's RMSE may exceed the sequential artifact's on
#: that task, per partition count.
MERGE_DEGRADATION_MAX = {2: 0.10, 4: 0.18}


@dataclasses.dataclass(frozen=True)
class MergeAccum(_Movable):
    """Per-chain posterior accumulators of the ``posterior_merge`` backend.

    Chains advance in lock-step (one sweep per chain per engine sweep), so
    ``chains[0].count`` is *the* post-burn-in sample count.
    """

    chains: tuple[PosteriorAccum, ...]

    @property
    def count(self) -> torch.Tensor:
        """Post-burn-in samples folded per chain (chain 0's 0-dim int32 device counter)."""
        return self.chains[0].count

    @property
    def num_chains(self) -> int:
        """Number of partition chains."""
        return len(self.chains)


def partition_users(
    coo: RatingsCOO, num_partitions: int, strategy: str = "lpt"
) -> list[np.ndarray]:
    """Assign users to ``num_partitions`` chains by rating-count cost.

    Args:
        coo: Full ratings (partitioned before the split, so the partition
            does not depend on the test fraction or split seed).
        num_partitions: Number of chains C, ``1 <= C <= num_users``.
        strategy: ``balance.partition_items`` strategy name.

    Returns:
        C ascending int64 arrays of original user ids, disjoint, jointly
        covering ``range(num_users)``.
    """
    if not 1 <= num_partitions <= coo.num_users:
        raise ValueError(
            f"num_partitions must be in [1, num_users={coo.num_users}], "
            f"got {num_partitions}"
        )
    nnz = np.bincount(coo.rows, minlength=coo.num_users)
    part = balance.partition_items(nnz, num_partitions, strategy=strategy)
    return [np.sort(np.asarray(s, np.int64)) for s in part.shards]


def split_by_users(coo: RatingsCOO, user_sets: list[np.ndarray]) -> list[RatingsCOO]:
    """One :class:`RatingsCOO` per chain, each rating in its user's chain.

    Ids stay original (see :func:`localize_users`), and every subset keeps
    the global shape.
    """
    owner = np.full(coo.num_users, -1, np.int64)
    for c, uids in enumerate(user_sets):
        owner[uids] = c
    if np.any(owner < 0):
        missing = np.nonzero(owner < 0)[0]
        raise ValueError(f"user_sets do not cover users {missing[:5].tolist()}...")
    rating_owner = owner[coo.rows]
    out = []
    for c in range(len(user_sets)):
        sel = rating_owner == c
        out.append(
            RatingsCOO(coo.rows[sel], coo.cols[sel], coo.vals[sel], coo.num_users, coo.num_movies)
        )
    return out


def localize_users(sub: RatingsCOO, user_ids: np.ndarray) -> RatingsCOO:
    """Relabel a chain's subset to local user ids ``0..len(user_ids)-1``.

    Local id ``i`` is ``user_ids[i]``, so chain-local factor row ``i``
    scatters back to global row ``user_ids[i]`` at merge time. Movie ids
    stay global: every chain samples the whole movie side.
    """
    lut = np.full(sub.num_users, -1, np.int64)
    lut[user_ids] = np.arange(len(user_ids))
    local = lut[sub.rows]
    if np.any(local < 0):
        raise ValueError("sub contains ratings for users outside user_ids")
    return RatingsCOO(local.astype(np.int32), sub.cols, sub.vals, len(user_ids), sub.num_movies)


def chain_key(key: torch.Tensor, chain: int) -> torch.Tensor:
    """The key of partition chain ``chain``: ``fold_in(key, chain)``.

    A stream disjoint from the other chains' and from the sequential
    backend's (which uses ``key`` itself), the same bits as
    ``jax.random.fold_in``.
    """
    return prng.fold_in(key, chain)


def merge_weights(
    windows: np.ndarray, method: str = "precision", eps: float = MERGE_EPS
) -> np.ndarray:
    """Per-chain combination weights from the chains' sample windows.

    ``"precision"``: diagonal precisions ``1/(var + eps)`` of each chain's
    window (ddof=1), normalized across chains per ``(item, k)``; uniform
    when fewer than two window samples exist. ``"pool"``: uniform ``1/C``.

    Args:
        windows: ``[C, S, N, K]`` chronological per-chain sample stacks.
        method: One of :data:`MERGE_METHODS`.
        eps: Variance regularizer.

    Returns:
        ``[C, N, K]`` float32 weights summing to 1 over the chain axis.
    """
    if method not in MERGE_METHODS:
        raise ValueError(f"merge_method must be one of {MERGE_METHODS}, got {method!r}")
    C, S = windows.shape[0], windows.shape[1]
    if method == "precision" and S >= 2:
        lam = 1.0 / (windows.astype(np.float64).var(axis=1, ddof=1) + eps)
        return (lam / lam.sum(axis=0)).astype(np.float32)
    return np.full((C,) + windows.shape[2:], 1.0 / C, np.float32)


def precision_merge(
    means: np.ndarray, variances: np.ndarray, eps: float = MERGE_EPS
) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form product of C diagonal Gaussians: ``(mean, var)`` float32.

    ``1/v = sum_c 1/v_c`` and ``m = v * sum_c m_c / v_c``, over the leading
    (chain) axis of ``means`` and ``variances``.
    """
    lam = 1.0 / (np.asarray(variances, np.float64) + eps)
    lam_sum = lam.sum(axis=0)
    mean = (lam * np.asarray(means, np.float64)).sum(axis=0) / lam_sum
    return mean.astype(np.float32), (1.0 / lam_sum).astype(np.float32)


def procrustes_rotation(A: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Orthogonal ``[K, K]`` float32 ``R`` minimizing ``||A @ R - ref||_F``.

    ``R = W @ Z^T`` from the SVD ``A^T @ ref = W S Z^T``.
    """
    W, _, Zt = np.linalg.svd(A.astype(np.float64).T @ ref.astype(np.float64))
    return (W @ Zt).astype(np.float32)


def align_chain_trees(trees: list[dict]) -> list[dict]:
    """Rotate every chain's factors onto chain 0's latent orientation.

    Per chain, one ``R_c`` (Procrustes of its ``V_sum`` onto chain 0's)
    right-multiplies ``U_sum``, ``V_sum`` and every retained sample. Chain
    0 goes through the same arithmetic. Empty accumulators (``count ==
    0``) are returned as they are.

    Args:
        trees: Per-chain checkpoint-schema dicts.

    Returns:
        New tree dicts (the inputs are not modified).
    """
    if int(np.asarray(trees[0]["count"])) == 0:
        return trees
    ref = np.asarray(trees[0]["V_sum"], np.float32)
    out = []
    for t in trees:
        R = procrustes_rotation(np.asarray(t["V_sum"], np.float32), ref)
        out.append({
            "U_sum": np.asarray(t["U_sum"], np.float32) @ R,
            "V_sum": np.asarray(t["V_sum"], np.float32) @ R,
            "count": t["count"],
            "U_samples": np.asarray(t["U_samples"], np.float32) @ R,
            "V_samples": np.asarray(t["V_samples"], np.float32) @ R,
        })
    return out


def merge_chain_trees(
    trees: list[dict],
    user_sets: list[np.ndarray],
    num_users: int,
    method: str = "precision",
    eps: float = MERGE_EPS,
    align: bool = True,
) -> dict:
    """Combine per-chain accumulator host trees into one global posterior summary.

    The one communication event of ``posterior_merge``: movie factors merge
    by :func:`merge_weights` (mean and each retained draw alike), user
    factors scatter from their owning chain.

    Args:
        trees: Per-chain ``{"U_sum", "V_sum", "count", "U_samples",
            "V_samples"}`` dicts with equal ``count``.
        user_sets: The chains' user partitions (ascending original ids).
        num_users: Global user count.
        method: One of :data:`MERGE_METHODS`.
        eps: Variance regularizer of ``"precision"``.
        align: Procrustes-align the chains to chain 0 first.

    Returns:
        ``{"count", "U_samples", "V_samples"}`` plus ``"U_mean"`` /
        ``"V_mean"`` when ``count > 0``: the ``Backend.posterior_export``
        schema.
    """
    counts = {int(np.asarray(t["count"])) for t in trees}
    if len(counts) != 1:
        raise ValueError(f"chains out of lock-step: counts {sorted(counts)}")
    count = counts.pop()
    if align and count:
        trees = align_chain_trees(trees)
    S = min(t["V_samples"].shape[0] for t in trees)
    out: dict = {"count": count}
    if count == 0:
        out["U_samples"] = np.zeros((0, 0, 0), np.float32)
        out["V_samples"] = np.zeros((0, 0, 0), np.float32)
        return out

    n = np.float32(count)
    V_means = np.stack([np.asarray(t["V_sum"], np.float32) / n for t in trees])
    if S > 0:
        V_windows = np.stack([np.asarray(t["V_samples"], np.float32)[-S:] for t in trees])
    else:
        V_windows = np.zeros((len(trees), 0) + V_means.shape[1:], np.float32)
    w = merge_weights(V_windows, method, eps)
    out["V_mean"] = (w * V_means).sum(axis=0).astype(np.float32)
    out["V_samples"] = np.einsum("cnk,csnk->snk", w, V_windows).astype(np.float32)

    K = V_means.shape[-1]
    U_mean = np.zeros((num_users, K), np.float32)
    U_samples = np.zeros((S, num_users, K), np.float32)
    for t, uids in zip(trees, user_sets):
        U_mean[uids] = np.asarray(t["U_sum"], np.float32) / n
        if S > 0:
            U_samples[:, uids] = np.asarray(t["U_samples"], np.float32)[-S:]
    out["U_mean"] = U_mean
    out["U_samples"] = U_samples
    return out


def column_mean_rmse(coo: RatingsCOO, test_fraction: float, seed: int) -> float:
    """RMSE of the per-movie training mean on the engine's own held-out split.

    The naive predictor every backend must beat: each test rating gets its
    movie's training mean, or the global training mean for a movie with
    no training rating.
    """
    train, test = train_test_split(coo, test_fraction, seed)
    gmean = float(train.vals.mean()) if train.nnz else 0.0
    sums = np.bincount(train.cols, weights=train.vals, minlength=coo.num_movies)
    cnts = np.bincount(train.cols, minlength=coo.num_movies)
    col_mean = np.where(cnts > 0, sums / np.maximum(cnts, 1), gmean)
    preds = col_mean[test.cols]
    return float(np.sqrt(np.mean((preds - test.vals) ** 2)))
