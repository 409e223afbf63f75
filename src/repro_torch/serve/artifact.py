"""Versioned posterior serving artifact: what ``BPMFEngine.export()`` writes.

The JAX package's artifact, file for file (schema version 1), so an
artifact either package exports serves from the other. It holds what a
serving process needs to answer rating queries without re-running MCMC:

* posterior-mean factors ``U_mean`` / ``V_mean``, averaged over every
  post-burn-in Gibbs sample,
* a bounded window of recent per-sweep factor samples ``U_samples`` /
  ``V_samples`` for the predictive std,
* the global mean rating, the clip range, and dataset/model metadata.

Layout (one directory per artifact)::

    <dir>/
        artifact.json      # schema version + metadata
        step_00000000/     # array payload via the checkpoint layer
            manifest.json
            U_mean.npy  U_samples.npy  V_mean.npy  V_samples.npy
        LATEST

The arrays commit first (the checkpoint layer's atomic rename), and
``artifact.json`` is replaced only after them, so a killed export never
leaves a loadable-looking artifact with missing arrays. Damage found at
load time surfaces as the typed :class:`ArtifactError` hierarchy.
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets

import numpy as np

from repro_torch.checkpoint import (
    CheckpointError,
    CheckpointSchemaError,
    restore_checkpoint,
    save_checkpoint,
)

SERVE_ARTIFACT_VERSION = 1
"""Artifact schema version; the JAX package's current one."""

_ARTIFACT_JSON = "artifact.json"
_ARRAYS_STEP = 0
ARRAY_KEYS = ("U_mean", "V_mean", "U_samples", "V_samples")
"""Leaf names of the array payload."""
# the payload's manifest order: the JAX package writes a dict, keys sorted
_MANIFEST_ORDER = tuple(sorted(ARRAY_KEYS))


class ArtifactError(RuntimeError):
    """Base class of serving-artifact load failures."""


class ArtifactNotFoundError(ArtifactError, FileNotFoundError):
    """The directory does not contain a committed serving artifact."""


class ArtifactCorruptError(ArtifactError):
    """The artifact exists but is damaged: unparsable ``artifact.json``,
    missing/truncated array files, or a broken checkpoint payload."""


class ArtifactSchemaError(ArtifactError):
    """The artifact is readable but does not match this schema:
    unsupported version, missing metadata keys, or array shapes that
    contradict the metadata."""


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

    def to_json(self) -> dict:
        """Plain-dict form written to ``artifact.json``."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(payload: object) -> "ArtifactMeta":
        """Validate and parse an ``artifact.json`` payload.

        Raises:
            ArtifactSchemaError: A non-dict payload, an unsupported
                ``version``, or missing/ill-typed metadata keys.
        """
        if not isinstance(payload, dict):
            raise ArtifactSchemaError(
                f"artifact.json must hold an object, got {type(payload).__name__}"
            )
        version = payload.get("version")
        if version != SERVE_ARTIFACT_VERSION:
            raise ArtifactSchemaError(
                f"unsupported artifact version {version!r} "
                f"(this build reads version {SERVE_ARTIFACT_VERSION})"
            )
        fields = {f.name: f for f in dataclasses.fields(ArtifactMeta)}
        missing = sorted(set(fields) - set(payload))
        if missing:
            raise ArtifactSchemaError(f"artifact.json missing keys: {missing}")
        kw = {}
        for name, field in fields.items():
            val = payload[name]
            want = {"int": int, "float": float, "str": str}[str(field.type)]
            if want is float and isinstance(val, int):
                val = float(val)
            if not isinstance(val, want):
                raise ArtifactSchemaError(
                    f"artifact.json key {name!r}: expected {want.__name__}, "
                    f"got {type(val).__name__}"
                )
            kw[name] = val
        return ArtifactMeta(**kw)


def _expected_shapes(meta: ArtifactMeta) -> dict[str, tuple[int, ...]]:
    S = meta.num_kept_samples
    return {
        "U_mean": (meta.num_users, meta.K),
        "V_mean": (meta.num_movies, meta.K),
        "U_samples": (S, meta.num_users, meta.K),
        "V_samples": (S, meta.num_movies, meta.K),
    }


def save_artifact(directory: str, meta: ArtifactMeta, arrays: dict[str, np.ndarray]) -> str:
    """Write a serving artifact: arrays first (atomic), metadata last.

    Args:
        directory: Artifact directory (created if needed). Exporting into
            the same directory again replaces the artifact.
        meta: Metadata block; array shapes must agree with it.
        arrays: Exactly the :data:`ARRAY_KEYS` leaves, host numpy.

    Returns:
        ``directory``.

    Raises:
        ValueError: ``arrays`` has the wrong key set or shapes that
            contradict ``meta`` (a producer bug, not a typed load error).
    """
    if set(arrays) != set(ARRAY_KEYS):
        raise ValueError(f"artifact arrays must be exactly {ARRAY_KEYS}, got {sorted(arrays)}")
    for name, want in _expected_shapes(meta).items():
        got = tuple(np.asarray(arrays[name]).shape)
        if got != want:
            raise ValueError(f"artifact array {name}: shape {got} != {want} from meta")
    os.makedirs(directory, exist_ok=True)
    # one writer (the caller): a multi-process export writes from process 0 alone
    save_checkpoint(directory, _ARRAYS_STEP, {k: np.asarray(arrays[k]) for k in _MANIFEST_ORDER},
                    collective=False)
    tmp = os.path.join(directory, f".{_ARTIFACT_JSON}-{secrets.token_hex(4)}")
    with open(tmp, "w") as f:
        json.dump(meta.to_json(), f, indent=1)
    os.replace(tmp, os.path.join(directory, _ARTIFACT_JSON))
    return directory


def load_artifact(directory: str) -> tuple[ArtifactMeta, dict[str, np.ndarray]]:
    """Load and validate a serving artifact.

    Args:
        directory: Directory written by :func:`save_artifact` or either
            package's ``BPMFEngine.export``.

    Returns:
        ``(meta, arrays)`` with host numpy arrays in the shapes ``meta``
        promises.

    Raises:
        ArtifactNotFoundError: No ``artifact.json`` under ``directory``.
        ArtifactCorruptError: Unparsable metadata, or a missing/truncated
            array payload.
        ArtifactSchemaError: Version/metadata/shape drift.
    """
    meta_path = os.path.join(directory, _ARTIFACT_JSON)
    if not os.path.exists(meta_path):
        raise ArtifactNotFoundError(f"no serving artifact under {directory!r}")
    try:
        with open(meta_path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactCorruptError(f"unreadable {meta_path}: {e}") from e
    meta = ArtifactMeta.from_json(payload)
    try:
        arrays = restore_checkpoint(directory, ARRAY_KEYS, step=_ARRAYS_STEP)
    except CheckpointSchemaError as e:
        raise ArtifactSchemaError(f"artifact array payload: {e}") from e
    except (CheckpointError, FileNotFoundError) as e:
        raise ArtifactCorruptError(f"artifact array payload: {e}") from e
    for name, want in _expected_shapes(meta).items():
        got = tuple(arrays[name].shape)
        if got != want:
            raise ArtifactSchemaError(
                f"artifact array {name}: shape {got} contradicts metadata {want}"
            )
    return meta, arrays
