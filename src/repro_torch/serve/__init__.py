"""``repro_torch.serve`` — posterior-mean serving over exported BPMF artifacts.

The port of ``repro.serve`` on one device: ``BPMFEngine.export()`` writes
the versioned artifact (:mod:`repro_torch.serve.artifact`, the JAX
package's files), :class:`PosteriorPredictor` answers ``predict`` and
``top_k`` from it, and :class:`BPMFServer` serves it over HTTP with
micro-batching (:mod:`repro_torch.serve.batcher`) and hot-swap, in the
request schema of :mod:`repro_torch.serve.schema` that
:class:`ServeClient` speaks. CLIs: ``python -m repro_torch.launch.serve``
and ``python -m repro_torch.launch.serve_server``.
"""
from repro_torch.serve.artifact import (
    ARRAY_KEYS,
    SERVE_ARTIFACT_VERSION,
    ArtifactCorruptError,
    ArtifactError,
    ArtifactMeta,
    ArtifactNotFoundError,
    ArtifactSchemaError,
    load_artifact,
    save_artifact,
)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.client import ServeClient, ServeConnectionError, ServeRequestError
from repro_torch.serve.predictor import PosteriorPredictor, PredictorHandle
from repro_torch.serve.schema import RequestError, parse_request, run_request
from repro_torch.serve.server import BPMFServer

__all__ = [
    "ARRAY_KEYS",
    "SERVE_ARTIFACT_VERSION",
    "ArtifactCorruptError",
    "ArtifactError",
    "ArtifactMeta",
    "ArtifactNotFoundError",
    "ArtifactSchemaError",
    "BPMFServer",
    "MicroBatcher",
    "PosteriorPredictor",
    "PredictorHandle",
    "RequestError",
    "ServeClient",
    "ServeConnectionError",
    "ServeRequestError",
    "load_artifact",
    "parse_request",
    "run_request",
    "save_artifact",
]
