"""Build a CUDA source of this package with nvcc and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At its first use in a
process the source is compiled for Hopper (``sm_90a``) into
``kernels/build/<name>-<hash>.so``, keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the library
already built. The compile goes to a temporary name and is renamed into
place, so processes that build at the same time do not read a half-written
library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc run, 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register and shared-memory report), "" when not built


_LOADED: dict[str, Library] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def load_library(name: str) -> Library:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process.

    Raises:
        RuntimeError: nvcc is missing or the compile fails (with nvcc's
            output in the message).
    """
    if name in _LOADED:
        return _LOADED[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    loaded = Library(ctypes.CDLL(str(out)), out, seconds, log)
    _LOADED[name] = loaded
    return loaded
