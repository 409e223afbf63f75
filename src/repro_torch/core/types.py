"""Containers for BPMF state, priors and bucketed rating data, as dataclasses of tensors.

The rating matrix ``R`` (M users x N movies, sparse) is factorized as
``R ~ U @ V.T`` with ``U: [M, K]`` and ``V: [N, K]``. Conditional
independence of items given the opposite factor matrix is the source of all
parallelism in the paper; the containers here encode the bucketed layout
that turns that parallelism into one dense kernel launch per bucket.

Field names and shapes follow ``repro.core.types`` so that
``repro_torch.convert`` can carry trees across. The counters (the sweep
index, the posterior sample counts) are 0-dim int32 tensors on the state's
device, as the JAX package keeps them inside its ``lax.scan``: the burn-in
gate is the device predicate ``sweep > burn_in``, so a block of sweeps
reads nothing back to the host and can be captured as one CUDA graph
(:mod:`repro_torch.core.sweep_graph`). Every container has ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of a container (dataclasses, tuples, tensors), in field order."""
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [t for v in tree for t in tensors(v)]
    return []


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """The container with ``fn`` applied to each of its tensors (structure and other fields kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: map_tensors(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple):
        return tuple(map_tensors(v, fn) for v in tree)
    return tree


def counter(value: int = 0, device: torch.device | str = "cpu") -> torch.Tensor:
    """A 0-dim int32 counter on ``device`` (filled on the device: no host copy)."""
    return torch.full((), int(value), dtype=torch.int32, device=device)


class _Movable:
    def to(self, device: torch.device | str):
        """This container with every tensor on ``device``."""
        return map_tensors(self, lambda t: t.to(device))


@dataclasses.dataclass(frozen=True)
class NormalWishartPrior(_Movable):
    """Fixed hyperprior p(mu, Lambda) = N(mu|mu0, (b0 Lam)^-1) W(Lam|W0, nu0)."""

    mu0: torch.Tensor  # [K]
    beta0: torch.Tensor  # scalar
    W0: torch.Tensor  # [K, K]
    nu0: torch.Tensor  # scalar

    @staticmethod
    def default(K: int, dtype: torch.dtype = torch.float32, device="cpu") -> "NormalWishartPrior":
        return NormalWishartPrior(
            mu0=torch.zeros(K, dtype=dtype, device=device),
            beta0=torch.tensor(2.0, dtype=dtype, device=device),
            W0=torch.eye(K, dtype=dtype, device=device),
            nu0=torch.tensor(float(K), dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class HyperParams(_Movable):
    """Sampled (mu, Lambda) for one side (users or movies)."""

    mu: torch.Tensor  # [K]
    Lam: torch.Tensor  # [K, K] precision

    @staticmethod
    def init(K: int, dtype: torch.dtype = torch.float32, device="cpu") -> "HyperParams":
        return HyperParams(
            mu=torch.zeros(K, dtype=dtype, device=device),
            Lam=torch.eye(K, dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class BPMFState(_Movable):
    """Full Gibbs state."""

    U: torch.Tensor  # [M, K] user latents
    V: torch.Tensor  # [N, K] movie latents
    hyper_U: HyperParams
    hyper_V: HyperParams
    sweep: torch.Tensor  # 0-dim int32, number of completed sweeps

    @property
    def K(self) -> int:
        """Latent rank."""
        return self.U.shape[-1]


@dataclasses.dataclass(frozen=True)
class PosteriorAccum(_Movable):
    """Device-resident posterior summary carried through the sweep loop.

    Running float32 sums of the post-burn-in samples and a rotating window
    of the ``keep`` most recent ones; ``U_window[count % keep]`` holds the
    sample drawn at post-burn-in index ``count``. ``filled`` counts the
    window entries that hold a sample (``min(count, keep)`` in an
    uninterrupted run). :func:`repro_torch.core.prediction.update_posterior_accum`
    updates the tensors in place.
    """

    U_sum: torch.Tensor  # [M, K] f32
    V_sum: torch.Tensor  # [N, K] f32
    count: torch.Tensor  # 0-dim int32, post-burn-in samples folded
    filled: torch.Tensor  # 0-dim int32, window entries that hold a sample
    U_window: torch.Tensor  # [keep, M, K] f32
    V_window: torch.Tensor  # [keep, N, K] f32

    @property
    def keep(self) -> int:
        return self.U_window.shape[0]

    @staticmethod
    def init(num_users: int, num_movies: int, K: int, keep: int, device="cpu") -> "PosteriorAccum":
        f32 = dict(dtype=torch.float32, device=device)
        return PosteriorAccum(
            U_sum=torch.zeros(num_users, K, **f32),
            V_sum=torch.zeros(num_movies, K, **f32),
            count=counter(0, device),
            filled=counter(0, device),
            U_window=torch.zeros(keep, num_users, K, **f32),
            V_window=torch.zeros(keep, num_movies, K, **f32),
        )


@dataclasses.dataclass(frozen=True)
class Bucket(_Movable):
    """A dense, padded group of items with similar rating counts.

    ``item_ids`` indexes the side being updated (``-1`` marks a padding
    row), ``nbr`` indexes the opposite side. Padded neighbor slots hold
    index 0 and value 0, and ``nnz`` masks them out.
    """

    item_ids: torch.Tensor  # [B] int32
    nbr: torch.Tensor  # [B, P] int32
    val: torch.Tensor  # [B, P] f32, centered ratings, 0 in padding
    nnz: torch.Tensor  # [B] int32

    @property
    def B(self) -> int:
        return self.item_ids.shape[0]

    @property
    def P(self) -> int:
        return self.nbr.shape[1]

    def mask(self) -> torch.Tensor:
        """``[B, P]`` 1.0 at real neighbor slots, 0.0 at padding, in ``val``'s dtype."""
        return (torch.arange(self.P, dtype=torch.int32, device=self.nnz.device)[None, :]
                < self.nnz[:, None]).to(self.val.dtype)


@dataclasses.dataclass(frozen=True)
class BucketedSide(_Movable):
    """All buckets of one side (the per-user or per-movie CSR, padded).

    ``gram[i]`` is the Gram dispatch decided for bucket i once, when a
    backend builds its data (:func:`repro_torch.core.posterior.plan_side`);
    empty when the side was not planned, and then each sweep resolves the
    configured ``gram_impl`` at the call.
    """

    buckets: tuple[Bucket, ...]
    num_items: int = 0
    # kernels.autotune.Decision per bucket; the port's own, not in the JAX tree
    gram: tuple[Any, ...] = dataclasses.field(default=(), metadata={"port_only": True})

    def total_ratings(self) -> int:
        return int(sum(int(b.nnz.sum()) for b in self.buckets))


@dataclasses.dataclass(frozen=True)
class TestSet(_Movable):
    """Held-out ratings for RMSE tracking."""

    rows: torch.Tensor  # [T] int32 user ids
    cols: torch.Tensor  # [T] int32 movie ids
    vals: torch.Tensor  # [T] f32 raw (uncentered) ratings


@dataclasses.dataclass(frozen=True)
class BPMFData(_Movable):
    """Everything the Gibbs sweep needs besides the state.

    ``users`` / ``movies`` are the bucketed neighbor lists for updating that
    side. ``mean_rating`` recenters ratings; predictions add it back.
    """

    users: BucketedSide  # update U: neighbors are movies
    movies: BucketedSide  # update V: neighbors are users
    test: TestSet
    mean_rating: torch.Tensor  # scalar f32
    num_users: int = 0
    num_movies: int = 0
    min_rating: float = float("-inf")
    max_rating: float = float("inf")


@dataclasses.dataclass(frozen=True)
class BPMFConfig:
    """Static configuration of the samplers (sequential and distributed)."""

    K: int = 32
    alpha: float = 2.0  # rating noise precision
    num_sweeps: int = 50  # the legacy ``gibbs.run`` loop's length
    burn_in: int = 8
    beta0: float = 2.0
    sample_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32  # Gram input rounding (f32 or bf16)
    # Gram dispatch, with the JAX package's spellings: "auto", "pallas" and
    # "pallas_fused" launch the CUDA kernel on a GPU tensor; "xla" is the
    # plain PyTorch version and is refused on a GPU tensor
    gram_impl: str = "auto"
    # distributed backends: how the opposite side's shards reach each shard
    # ("ring", "ring_async" or "allgather") and ring_async's rotations in flight
    comm_mode: str = "ring"
    pipeline_depth: int = 1

    def prior(self, device="cpu") -> NormalWishartPrior:
        p = NormalWishartPrior.default(self.K, self.sample_dtype, device)
        return dataclasses.replace(
            p, beta0=torch.tensor(self.beta0, dtype=self.sample_dtype, device=device)
        )
