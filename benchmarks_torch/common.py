"""Shared utilities of the port's benchmark scripts: result IO, the device record, timed fits and the ring meter.

The scripts import ``repro_torch`` only, run on the card unless given
``--device cpu``, and write ``experiments/bench_torch/<name>.json``. A
smoke run never writes the committed file: without an explicit ``--out``
it writes to a temporary directory (:func:`smoke_out_path`).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Iterator

import torch

from repro_torch.bpmf import BPMFConfig, BPMFEngine
from repro_torch.core.distributed import InFlight, Ring
from repro_torch.utils import device_line

OUT_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments",
                                        "bench_torch"))


def save_result(name: str, payload: dict[str, Any], out: str | None = None) -> str:
    """Write a benchmark payload as JSON; returns the path.

    The default target is the committed ``experiments/bench_torch/<name>.json``;
    smoke runs pass ``out`` (:func:`smoke_out_path`) so that they never
    overwrite the committed numbers.
    """
    path = out or os.path.join(OUT_DIR, f"{name}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return os.path.normpath(path)


def smoke_out_path(name: str, smoke: bool, out: str | None) -> str | None:
    """A benchmark's output path under the smoke contract.

    An explicit ``out`` always wins; a smoke run without one writes to a
    fresh temporary directory; a full run to the committed file (``None``).
    """
    if out:
        return out
    if smoke:
        return os.path.join(tempfile.mkdtemp(prefix=f"bench-{name}-"), f"{name}.json")
    return None


def device_record(device: torch.device) -> dict[str, Any]:
    """What every payload says about where it ran: ``device`` (``"gpu"``/``"cpu"``), the card line, the count."""
    cuda = device.type == "cuda"
    return {"device": "gpu" if cuda else device.type, "card": device_line(device),
            "devices": torch.cuda.device_count() if cuda else 1}


def capture_seconds(engine: BPMFEngine) -> float:
    """Seconds of the one-time capture of the engine's sweep (its eager warm-up and the capture); 0 with no graph."""
    graph = engine.backend.graph
    return 0.0 if graph is None else graph.warmup_seconds + graph.capture_seconds


def warm_up(cfg: BPMFConfig, coo, device) -> None:
    """One 1-sweep fit of ``cfg``: the kernels' build and the libraries' handles and workspaces.

    A process's first fit pays these once (on the card about a second), so
    a driver runs this before its first timed fit.
    """
    BPMFEngine(cfg.replace(num_sweeps=1, sweeps_per_block=1), device=device).fit(coo)


def fit_timed(cfg: BPMFConfig, coo, device) -> tuple[BPMFEngine, float]:
    """(engine, seconds) of one fit after ``prepare``, the capture taken off.

    The capture is the counterpart of the JAX package's compile, which its
    benchmarks exclude by a warm-up fit; :func:`capture_seconds` gives it.
    """
    engine = BPMFEngine(cfg, device=device)
    engine.prepare(coo)
    t0 = time.perf_counter()
    engine.fit()
    return engine, time.perf_counter() - t0 - capture_seconds(engine)


def eager_seconds(engine: BPMFEngine, sweeps: int) -> float:
    """Seconds of the engine's ``sweeps`` sweeps from its initial state, run eagerly (``_eager=True``).

    The same keys as :meth:`BPMFEngine.fit` draws with; the engine's own
    state is left alone. On the CPU every run is eager.
    """
    backend = engine.backend
    carry = (backend.init_state(engine._k_init), backend.init_pred(), backend.init_accum())
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    out = backend.sweep_block(engine._k_run, *carry, sweeps, _eager=True)
    out[-1].cpu()  # the metrics' read waits for the block
    return time.perf_counter() - t0


def _block_bytes(buf: InFlight) -> int:
    return (buf.tensor if buf.tensor is not None else buf.host).nbytes


@contextlib.contextmanager
def metered_ring() -> Iterator[dict[str, int]]:
    """Count every ``Ring.rotate`` and ``Ring.all_gather`` call, and the bytes ``rotate`` hands on, inside the block.

    The port's counterpart of the reference's metered ``jax.lax.ppermute``
    (``benchmarks/fig4_scaling.py``): the two methods of
    :class:`repro_torch.core.distributed.Ring` are wrapped on the class, so
    every ring is metered, and restored on exit. ``rotate_bytes`` sums the
    blocks of every hop, one per shard this process holds, as the
    reference counts each traced ``ppermute`` once per device.
    """
    meter = {"rotate_calls": 0, "all_gather_calls": 0, "rotate_bytes": 0}
    rotate, all_gather = Ring.rotate, Ring.all_gather

    def metered_rotate(self, bufs):
        meter["rotate_calls"] += 1
        meter["rotate_bytes"] += sum(_block_bytes(b) for b in bufs)
        return rotate(self, bufs)

    def metered_all_gather(self, x):
        meter["all_gather_calls"] += 1
        return all_gather(self, x)

    Ring.rotate, Ring.all_gather = metered_rotate, metered_all_gather
    try:
        yield meter
    finally:
        Ring.rotate, Ring.all_gather = rotate, all_gather


def metered_sweep(engine: BPMFEngine) -> dict[str, int]:
    """:func:`metered_ring` over one eager ``Backend.sweep`` from a fresh state of the prepared engine."""
    backend = engine.backend
    state, pred = backend.init_state(engine._k_init), backend.init_pred()
    with metered_ring() as meter:
        backend.sweep(engine._k_run, state, pred)
    return meter
