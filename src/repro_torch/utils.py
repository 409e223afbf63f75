"""Small shared utilities: logging, integer rounding, device selection."""
from __future__ import annotations

import logging

import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks otherwise.

    ``None`` means the GPU. Without one this raises instead of quietly
    running on the CPU; the CPU is used only when the caller names it.

    Raises:
        RuntimeError: ``device`` is ``None`` or a CUDA device and no CUDA
            device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev
