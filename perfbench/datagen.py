"""Synthetic ratings with MovieLens- and ChEMBL-shaped skew, made from the run's seed.

A frozen copy of the port's ``data/synthetic.py:synthetic_ratings`` (with
its ``weighted_choice`` and ``sorted_unique``), so that a later change to
the program cannot change what the benchmark feeds it. The ratings are
``R = U* V*^T + noise`` on a low-rank truth: movie popularity is Zipf-like
(exponent ``popularity_exponent``), user activity lognormal
(``activity_sigma``); pairs are drawn by two independent categorical draws
and deduplicated; MovieLens-shaped data is rounded to 1..5 stars.

The configuration's ``data`` object holds the sizes and shapes
(``num_users``, ``num_movies``, ``nnz``, ``true_rank``, ``noise_std``,
``popularity_exponent``, ``activity_sigma``, ``discretize``); the seed is
the run's.
"""
from __future__ import annotations

import numpy as np
import torch


def weighted_choice(rng: np.random.Generator, p: np.ndarray, size: int) -> np.ndarray:
    """``rng.choice(len(p), size=size, p=p)``: the same draws, searched over the host's threads."""
    cdf = np.asarray(p, dtype=np.float64).cumsum()
    cdf /= cdf[-1]
    uniform = rng.random(size)
    return torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(uniform), right=True).numpy()


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by one sort and a neighbour compare."""
    keys = np.sort(keys)
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))] if keys.size else keys


def ratings(spec: dict, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(rows, cols, vals)``: int32 user and movie ids and float32 ratings, ``spec["nnz"]`` of them."""
    num_users, num_movies, target = spec["num_users"], spec["num_movies"], spec["nnz"]
    rng = np.random.default_rng(seed)
    K = spec["true_rank"]
    U = rng.normal(size=(num_users, K)).astype(np.float32) / np.sqrt(K)
    V = rng.normal(size=(num_movies, K)).astype(np.float32)

    pop = 1.0 / np.arange(1, num_movies + 1) ** spec["popularity_exponent"]
    rng.shuffle(pop)
    pop /= pop.sum()
    act = rng.lognormal(sigma=spec["activity_sigma"], size=num_users)
    act /= act.sum()

    rows_list, cols_list = [], []
    seen: np.ndarray | None = None
    got = 0
    for _ in range(6):
        need = int((target - got) * 1.3) + 1
        r = weighted_choice(rng, act, need)
        c = weighted_choice(rng, pop, need)
        keys = r * num_movies + c
        keys = sorted_unique(keys) if seen is None else np.setdiff1d(sorted_unique(keys), seen, assume_unique=True)
        seen = keys if seen is None else sorted_unique(np.concatenate((seen, keys)))
        rows_list.append((keys // num_movies).astype(np.int32))
        cols_list.append((keys % num_movies).astype(np.int32))
        got = sum(len(x) for x in rows_list)
        if got >= target:
            break
    rows = np.concatenate(rows_list)[:target]
    cols = np.concatenate(cols_list)[:target]

    vals = np.einsum("nk,nk->n", U[rows], V[cols]) + rng.normal(
        scale=spec["noise_std"], size=len(rows)
    ).astype(np.float32)
    if spec["discretize"]:
        vals = np.clip(np.round(vals * 1.2 + 3.0), 1.0, 5.0)
    return rows, cols, vals.astype(np.float32)
