"""Metadata of a posterior summary, in the JAX package's artifact schema.

Only :class:`ArtifactMeta` is ported so far: the predictor reads it. Writing
and loading artifacts on disk come with ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import dataclasses

SERVE_ARTIFACT_VERSION = 1
"""Artifact schema version of the JAX package this metadata follows."""


@dataclasses.dataclass(frozen=True)
class ArtifactMeta:
    """Metadata block of a serving artifact (``artifact.json``).

    Attributes:
        num_users: Row count of the factorized rating matrix.
        num_movies: Column count of the factorized rating matrix.
        K: Latent rank of the exported factors.
        mean_rating: Global training mean re-added to every prediction.
        min_rating: Lower clip bound for served predictions.
        max_rating: Upper clip bound for served predictions.
        num_mean_samples: Post-burn-in Gibbs samples averaged into
            ``U_mean`` / ``V_mean``; 0 means the last raw sample is served.
        num_kept_samples: Retained per-sweep factor samples; 0 disables
            predictive-std output.
        backend: Backend registry name that produced the posterior.
        num_sweeps_done: Completed Gibbs sweeps at export time.
        seed: ``RunConfig.seed`` of the producing run (split + sampler).
        version: Artifact schema version.
    """

    num_users: int
    num_movies: int
    K: int
    mean_rating: float
    min_rating: float
    max_rating: float
    num_mean_samples: int
    num_kept_samples: int
    backend: str
    num_sweeps_done: int
    seed: int
    version: int = SERVE_ARTIFACT_VERSION
