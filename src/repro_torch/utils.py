"""Small shared utilities: logging, timing, tree sizes, dtypes, integer rounding, device selection.

The counterparts of ``repro.utils``. ``pytree_dataclass`` and
``static_field`` have none: the port's containers are plain dataclasses of
tensors (``repro_torch.core.types``), which need no registration.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
import subprocess
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def _leaves(tree: Any) -> Iterator[Any]:
    """The array leaves (tensors, numpy arrays) of nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _map_leaves(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with ``fn`` applied to each array leaf (structure kept)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(v, fn)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map_leaves(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _map_leaves(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)}
        )
    return tree


def tree_size_bytes(tree: Any) -> int:
    """Total size in bytes of all array leaves (tensors and numpy arrays)."""
    return sum(
        x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes for x in _leaves(tree)
    )


def tree_num_params(tree: Any) -> int:
    """Total element count of all array leaves."""
    return sum(int(np.prod(x.shape)) for x in _leaves(tree))


def block_until_ready(tree: Any) -> Any:
    """Wait until the device work producing the tree's CUDA tensors has finished; returns ``tree``."""
    devices = {x.device for x in _leaves(tree) if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    """Context-manager wall timer."""

    def __init__(self, name: str = "", log: bool = False):
        self.name, self.log = name, log
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.log:
            logger.info("%s: %.4fs", self.name, self.elapsed)


def timeit(fn: Callable[..., Any], *args: Any, iters: int = 10, warmup: int = 2, **kw: Any) -> float:
    """Median seconds per call of ``fn``, each timed until its CUDA results are finished.

    A CUDA launch returns before the card has done the work, so each call's
    result goes through :func:`block_until_ready` inside the timed region.
    """
    for _ in range(warmup):
        block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def chunked(seq: list, n: int) -> Iterator[list]:
    """Consecutive slices of ``seq`` of length ``n`` (the last may be shorter)."""
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


@functools.lru_cache(maxsize=None)
def cpu_count() -> int:
    return os.cpu_count() or 1


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating-point leaves of a tree (tensors, numpy arrays) to ``dtype``; others are kept."""

    def cast(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.to(dtype) if x.is_floating_point() else x
        if np.issubdtype(x.dtype, np.floating):
            return torch.from_numpy(x).to(dtype).numpy()
        return x

    return _map_leaves(tree, cast)


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


def device_line(device: str | torch.device) -> str:
    """What a measurement ran on: ``"cpu"``, or the card's name and power limit.

    For a CUDA device, the line ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints for it (a card may be set below its full
    power, and then runs slower); the device name alone where nvidia-smi
    cannot be run.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(index)
