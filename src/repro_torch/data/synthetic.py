"""Synthetic rating generators with MovieLens/ChEMBL-shaped degree skew.

Benchmark datasets are generated with the same scale parameters as the
paper's (ml-20m: 138493 x 27278, 20M ratings;
ChEMBL IC50 subset: 483500 x 5775, ~1M ratings) and a ground-truth low-rank
structure so RMSE convergence is checkable against the generative noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.sparse import RatingsCOO


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_users: int
    num_movies: int
    nnz: int
    true_rank: int = 8
    noise_std: float = 0.5
    # popularity skew of movies (zipf-ish exponent) and user-activity lognormal sigma
    popularity_exponent: float = 0.8
    activity_sigma: float = 1.0
    discretize: bool = True  # round to 1..5 stars
    seed: int = 0


ML20M_LIKE = SyntheticSpec(num_users=138_493, num_movies=27_278, nnz=20_000_000)
ML100K_LIKE = SyntheticSpec(num_users=943, num_movies=1_682, nnz=100_000)
CHEMBL_LIKE = SyntheticSpec(
    num_users=483_500, num_movies=5_775, nnz=1_023_952, discretize=False, noise_std=0.6
)


def weighted_choice(rng: np.random.Generator, p: np.ndarray, size: int) -> np.ndarray:
    """``rng.choice(len(p), size=size, p=p)`` as int64, the same draws and the same state after, faster.

    It is numpy's own algorithm (the cumulative sum scaled to end at 1, one
    ``rng.random`` per draw, the first index whose sum exceeds it), with the
    search over the host's threads (``torch.searchsorted``): at ML20M's
    26M draws numpy's one-thread search is most of the generator's time.
    """
    cdf = np.asarray(p, dtype=np.float64).cumsum()
    cdf /= cdf[-1]
    uniform = rng.random(size)
    return torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(uniform), right=True).numpy()


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by one sort and a neighbour compare.

    numpy 2.3's ``unique`` hashes integers before it sorts them: on a
    host with numpy 2.3.5 that took 76 s for ML20M's 26M keys, where a
    sort takes seconds.
    """
    keys = np.sort(keys)
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))] if keys.size else keys


def synthetic_ratings(spec: SyntheticSpec) -> tuple[RatingsCOO, dict]:
    """Generate sparse ratings R = U* V*^T + noise with skewed observation pattern.

    Returns the COO plus ground-truth info (U*, V*, noise_std) for validation.
    """
    rng = np.random.default_rng(spec.seed)
    K = spec.true_rank
    U = rng.normal(size=(spec.num_users, K)).astype(np.float32) / np.sqrt(K)
    V = rng.normal(size=(spec.num_movies, K)).astype(np.float32)

    # movie popularity ~ zipf, user activity ~ lognormal; expected pair weight
    # is the product -> sample pairs by independent categorical draws, dedupe.
    pop = 1.0 / np.arange(1, spec.num_movies + 1) ** spec.popularity_exponent
    rng.shuffle(pop)
    pop /= pop.sum()
    act = rng.lognormal(sigma=spec.activity_sigma, size=spec.num_users)
    act /= act.sum()

    target = spec.nnz
    rows_list, cols_list = [], []
    seen: np.ndarray | None = None
    got = 0
    # oversample then dedupe; a couple of rounds suffice at these densities
    for _ in range(6):
        need = int((target - got) * 1.3) + 1
        r = weighted_choice(rng, act, need)
        c = weighted_choice(rng, pop, need)
        keys = r * spec.num_movies + c
        keys = sorted_unique(keys) if seen is None else np.setdiff1d(sorted_unique(keys), seen, assume_unique=True)
        seen = keys if seen is None else sorted_unique(np.concatenate((seen, keys)))
        rows_list.append((keys // spec.num_movies).astype(np.int32))
        cols_list.append((keys % spec.num_movies).astype(np.int32))
        got = sum(len(x) for x in rows_list)
        if got >= target:
            break
    rows = np.concatenate(rows_list)[:target]
    cols = np.concatenate(cols_list)[:target]

    vals = np.einsum("nk,nk->n", U[rows], V[cols]) + rng.normal(
        scale=spec.noise_std, size=len(rows)
    ).astype(np.float32)
    if spec.discretize:
        # shift to a 1..5 star scale like MovieLens
        vals = np.clip(np.round(vals * 1.2 + 3.0), 1.0, 5.0)
    coo = RatingsCOO(rows, cols, vals.astype(np.float32), spec.num_users, spec.num_movies)
    truth = {"U": U, "V": V, "noise_std": spec.noise_std, "spec": spec}
    return coo, truth


def small_test_ratings(
    num_users: int = 64,
    num_movies: int = 48,
    nnz: int = 1500,
    true_rank: int = 4,
    noise_std: float = 0.3,
    seed: int = 0,
) -> tuple[RatingsCOO, dict]:
    """Tiny deterministic dataset for unit tests (continuous ratings)."""
    spec = SyntheticSpec(
        num_users=num_users,
        num_movies=num_movies,
        nnz=nnz,
        true_rank=true_rank,
        noise_std=noise_std,
        discretize=False,
        seed=seed,
    )
    return synthetic_ratings(spec)
