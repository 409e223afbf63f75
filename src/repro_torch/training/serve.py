"""Serving for the reproduced system = BPMF posterior-mean prediction.

The counterpart of ``repro.training.serve``: that module's LM prefill and
decode moved to :mod:`repro_torch.training.lm_serve`, and serving the
actual workload (rating queries answered from a sampled posterior) is
owned by :mod:`repro_torch.serve`. The re-exports below keep this module
importable as the serving entry point; new code should import
:mod:`repro_torch.serve` directly.
"""
from repro_torch.serve import (  # noqa: F401 (compatibility re-exports)
    ArtifactError,
    ArtifactMeta,
    PosteriorPredictor,
    load_artifact,
    save_artifact,
)

__all__ = [
    "ArtifactError",
    "ArtifactMeta",
    "PosteriorPredictor",
    "load_artifact",
    "save_artifact",
]
