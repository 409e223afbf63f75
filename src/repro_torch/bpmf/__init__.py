"""The engine API of the PyTorch port::

    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset

Mirrors ``repro.bpmf``: config, backend registry, dataset registry and the
engine facade. Entry points run on CUDA unless asked for the CPU.
"""
from repro_torch.bpmf.backends import (
    Backend,
    SequentialBackend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.bpmf.config import BackendConfig, BPMFConfig, ModelConfig, RunConfig
from repro_torch.bpmf.datasets import available_datasets, load_dataset, register_dataset
from repro_torch.bpmf.engine import BPMFEngine

__all__ = [
    "Backend",
    "BackendConfig",
    "BPMFConfig",
    "BPMFEngine",
    "ModelConfig",
    "RunConfig",
    "SequentialBackend",
    "available_backends",
    "available_datasets",
    "get_backend",
    "load_dataset",
    "register_backend",
    "register_dataset",
]
