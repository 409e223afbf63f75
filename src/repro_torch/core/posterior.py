"""Per-item conditional posterior updates, one batched solve per bucket.

For one item i of side X (say a movie) with neighbor latents {u_j} and
centered ratings {r_ij}:

    precision  P_i = Lambda + alpha * sum_j u_j u_j^T          [K, K]
    linear     l_i = Lambda mu + alpha * sum_j u_j r_ij        [K]
    sample     x_i = P_i^{-1} l_i + chol(P_i)^{-T} z,  z ~ N(0, I_K)

Each nnz-bucket is one gather + Gram launch (the CUDA kernel on a GPU)
followed by a batched Cholesky and triangular solves.

Noise is drawn per *global item id* with ``prng.fold_in``, so every layout
draws the same sample for the same item, and the same one the JAX package
draws from the same key.

Which Gram op a bucket runs is decided once, when a backend builds its
data (:func:`plan_data`), and kept beside the buckets
(``BucketedSide.gram``); a sweep, eager or captured, runs what was
decided.

The phase clock's marks (:mod:`repro_torch.trace`): a side starts in
``gram``; a bucket's Gram terms are ``gram``, its factorization and first
solve ``solve``, its noise ``noise``, and the second solve with the
scatter into the new factors ``solve`` again.

``FACTORS`` counts the batched factorizations (calls of ``cholesky_ex``
in :func:`sample_from_terms`) and ``FACTOR_ROWS`` the matrices they
factor; a captured sweep counts them at each replay, as ``prng.LAUNCHES``
(:mod:`repro_torch.core.sweep_graph`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.core import prng
from repro_torch.core.types import BPMFConfig, BPMFData, Bucket, BucketedSide, HyperParams
from repro_torch.kernels import autotune, ops

FACTORS = 0
FACTOR_ROWS = 0


def item_noise(key: torch.Tensor, item_ids: torch.Tensor, K: int) -> torch.Tensor:
    """Per-item N(0, I_K) float32 noise ``[B, K]``, independent of batch layout."""
    return prng.normal(prng.fold_in(key, item_ids), (K,))


def gram_terms(
    X_opp: torch.Tensor,
    bucket: Bucket,
    alpha: float,
    compute_dtype: torch.dtype = torch.float32,
    gram_impl: str = "auto",
    piece: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, g) with G = alpha * sum_j x_j x_j^T  [B,K,K], g = alpha * sum_j x_j r_j [B,K]."""
    G, g = ops.bpmf_gram(
        X_opp, bucket.nbr, bucket.val, bucket.nnz,
        compute_dtype=compute_dtype, impl=gram_impl, piece=piece,
    )
    return alpha * G, alpha * g


def sample_from_terms(
    key: torch.Tensor,
    item_ids: torch.Tensor,
    G: torch.Tensor,
    g: torch.Tensor,
    hyper: HyperParams,
) -> torch.Tensor:
    """Draw x_i ~ N(P^-1 l, P^-1) for a batch of items from accumulated terms."""
    global FACTORS, FACTOR_ROWS
    K = g.shape[-1]
    trace.phase("solve")
    prec = G + hyper.Lam  # [B, K, K]
    lin = g + hyper.Lam @ hyper.mu  # [B, K]
    # cholesky_ex does not read the status back to the host, so the GPU
    # pipeline does not stall; a non-PD precision gives NaN rows, as JAX's does
    L, _ = torch.linalg.cholesky_ex(prec)
    FACTORS += 1
    FACTOR_ROWS += prec.shape[0]
    y = torch.linalg.solve_triangular(L, lin[..., None], upper=False)
    trace.phase("noise")
    z = item_noise(key, item_ids, K)
    trace.phase("solve")
    # mean = L^-T y and noise = L^-T z in one solve with two right-hand sides
    both = torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.cat([y, z[..., None]], dim=-1), upper=True
    )
    return both[..., 0] + both[..., 1]


def update_bucket(
    key: torch.Tensor,
    X_out: torch.Tensor,
    X_opp: torch.Tensor,
    bucket: Bucket,
    hyper: HyperParams,
    alpha: float,
    compute_dtype: torch.dtype = torch.float32,
    gram_impl: str = "auto",
    piece: int | None = None,
) -> None:
    """Sample all items of one bucket into ``X_out`` in place.

    ``X_out`` has one row more than the side: rows with ``item_ids == -1``
    (padding) are written to that last row, which the caller drops, the
    way JAX's ``mode="drop"`` scatter drops them. Plain indexing with -1
    would overwrite the last real item.
    """
    trace.phase("gram")
    G, g = gram_terms(X_opp, bucket, alpha, compute_dtype, gram_impl, piece)
    new = sample_from_terms(key, bucket.item_ids, G, g, hyper)
    dump = X_out.shape[0] - 1
    ids = bucket.item_ids.long()
    X_out.index_copy_(0, torch.where(ids >= 0, ids, dump), new.to(X_out.dtype))


def update_side(
    key: torch.Tensor,
    X_side: torch.Tensor,
    X_opp: torch.Tensor,
    side: BucketedSide,
    hyper: HyperParams,
    alpha: float,
    compute_dtype: torch.dtype = torch.float32,
    gram_impl: str = "auto",
) -> torch.Tensor:
    """One half-sweep: a new ``X_side`` with every item resampled given ``X_opp``.

    Buckets run smallest-P first (the paper's cheap-items-first order).
    A planned side runs each bucket's decision (``side.gram``), an
    unplanned one ``gram_impl``. ``X_side`` itself is not modified.
    """
    trace.phase("gram")
    X_out = torch.cat([X_side, X_side.new_zeros(1, X_side.shape[1])])
    for bucket, dec in zip(side.buckets, side.gram or (None,) * len(side.buckets), strict=True):
        impl, piece = (gram_impl, None) if dec is None else (dec.impl, dec.piece)
        update_bucket(key, X_out, X_opp, bucket, hyper, alpha, compute_dtype, impl, piece)
    return X_out[:-1]


def plan_side(side: BucketedSide, Ns: int, K: int, compute_dtype: torch.dtype = torch.float32,
              gram_impl: str = "auto", backend: str = "cuda") -> BucketedSide:
    """``side`` with each bucket's Gram dispatch decided (``BucketedSide.gram``).

    ``"auto"`` takes ``autotune.decide`` of the bucket's key (a cache
    entry, else the heuristic); any other ``gram_impl`` is taken as it is.
    ``Ns`` is the row count of the opposite factors.

    Raises:
        ValueError: An unknown ``gram_impl``, or K above the kernels' limit
            on a CUDA key.
    """
    if gram_impl not in ops.GRAM_IMPLS:
        raise ValueError(f"unknown gram_impl {gram_impl!r}; one of {'|'.join(ops.GRAM_IMPLS)}")
    decisions = tuple(
        autotune.decide(autotune.bucket_key(b.B, b.P, Ns, K, compute_dtype, backend))
        if gram_impl == "auto" else autotune.Decision(gram_impl)
        for b in side.buckets
    )
    return dataclasses.replace(side, gram=decisions)


def plan_data(data: BPMFData, cfg: BPMFConfig) -> BPMFData:
    """Both sides of ``data`` planned (:func:`plan_side`) for ``cfg`` on the data's device."""
    backend = data.mean_rating.device.type
    common = dict(K=cfg.K, compute_dtype=cfg.compute_dtype, gram_impl=cfg.gram_impl, backend=backend)
    return dataclasses.replace(
        data,
        users=plan_side(data.users, data.num_movies, **common),
        movies=plan_side(data.movies, data.num_users, **common),
    )


def update_item_naive(
    key: torch.Tensor,
    item_id: int,
    nbr: torch.Tensor,
    val: torch.Tensor,
    X_opp: torch.Tensor,
    hyper: HyperParams,
    alpha: float,
) -> torch.Tensor:
    """Textbook single-item update (no padding, no bucketing) — test oracle."""
    Xn = X_opp[nbr.long()]  # [n, K]
    K = Xn.shape[-1]
    prec = hyper.Lam + alpha * Xn.T @ Xn
    lin = hyper.Lam @ hyper.mu + alpha * Xn.T @ val
    L = torch.linalg.cholesky(prec)
    y = torch.linalg.solve_triangular(L, lin[:, None], upper=False)
    mean = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    z = prng.normal(prng.fold_in(key, item_id), (K,))
    return mean + torch.linalg.solve_triangular(L.T, z[:, None], upper=True)[:, 0]
