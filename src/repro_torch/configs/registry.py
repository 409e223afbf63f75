"""Architecture + shape registry: the assigned (arch x shape) grid.

The counterpart of ``repro.configs.registry``, with the same ten configs
and four shapes. Every config is data and loads here; only the attention
family (gemma-2b, yi-6b, chameleon-34b, nemotron-4-340b, hubert-xlarge)
builds a model so far (``repro_torch.models.model.build_model`` raises
for the others, naming the ROADMAP item that ports them).

``runnable_cells()`` applies the DESIGN.md §5 skip rules:
  * ``long_500k`` needs sub-quadratic attention — runs only for ssm/hybrid
    archs and SWA archs (mixtral's rolling window); skipped for pure
    full-attention archs.
  * encoder-only archs (hubert) have no decode step — decode shapes skipped.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One shape of the grid: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    """The published config of arch ``name`` (``KeyError`` naming the archs if unknown)."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {', '.join(ARCHS)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_archs() -> tuple[str, ...]:
    """Every registered arch name, in registry order."""
    return ARCHS


def cell_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-not). The skip rules of DESIGN.md §5."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        if cfg.is_encoder:
            return False, "encoder-only arch has no decode step"
        if not cfg.sub_quadratic:
            return False, "quadratic attention / unbounded KV at 524k is not deployable"
    return True, ""


def runnable_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair that :func:`cell_runnable` admits."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = cell_runnable(cfg, shape)
            if ok:
                out.append((arch, shape.name))
    return out
