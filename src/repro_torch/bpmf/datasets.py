"""Dataset registry behind ``repro_torch.bpmf.load_dataset(name, **kw)``.

Loaders return a :class:`repro_torch.data.sparse.RatingsCOO`; the engine
owns the train/test split. Registered: ``synthetic``, ``movielens`` and
``chembl`` (the real files when a path is given, else synthetic stand-ins).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.data.movielens import load_chembl, load_movielens
from repro_torch.data.sparse import RatingsCOO
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings

DATASETS: dict[str, Callable[..., RatingsCOO]] = {}


def register_dataset(name: str) -> Callable[[Callable[..., RatingsCOO]], Callable[..., RatingsCOO]]:
    """Function decorator adding a loader under ``name`` (last wins)."""

    def deco(fn: Callable[..., RatingsCOO]) -> Callable[..., RatingsCOO]:
        DATASETS[name] = fn
        return fn

    return deco


def load_dataset(name: str, **kw) -> RatingsCOO:
    """Load a registered dataset by name; ``kw`` goes to the loader.

    Raises:
        ValueError: If ``name`` is not registered.
    """
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    return DATASETS[name](**kw)


def available_datasets() -> list[str]:
    """Sorted registry names."""
    return sorted(DATASETS)


@register_dataset("synthetic")
def _synthetic(
    num_users: int = 400,
    num_movies: int = 300,
    nnz: int = 12_000,
    true_rank: int = 8,
    noise_std: float = 0.5,
    discretize: bool = False,
    seed: int = 0,
) -> RatingsCOO:
    """Low-rank + noise ratings with MovieLens-shaped degree skew."""
    spec = SyntheticSpec(
        num_users=num_users,
        num_movies=num_movies,
        nnz=nnz,
        true_rank=true_rank,
        noise_std=noise_std,
        discretize=discretize,
        seed=seed,
    )
    coo, _ = synthetic_ratings(spec)
    return coo


@register_dataset("movielens")
def _movielens(path: str | None = None, variant: str = "ml-100k") -> RatingsCOO:
    """Real ml-20m/ml-100k files when ``path`` exists, else the synthetic stand-in."""
    return load_movielens(path, variant)


@register_dataset("chembl")
def _chembl(path: str | None = None) -> RatingsCOO:
    """ChEMBL IC50 compound x target subset (paper §V workload)."""
    return load_chembl(path)
