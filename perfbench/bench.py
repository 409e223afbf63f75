"""The harness: a cell of ``BENCHMARK.json`` resolved to its files by name, run once, and reported.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found by name, so a later change adds files and never
edits one:

* ``perfbench/configs/<config>.json``: the configuration (its ``data``
  sizes and shapes, its ``model``, its ``reference``);
* ``perfbench/traffic/<traffic>.json``: the mix; its ``window`` names the
  module ``perfbench/windows/<window>.py`` that sets the cell up, runs the
  measured window and compares what the program produced with the
  reference, and the rest are that window's parameters;
* ``perfbench/metrics/<metric>.py``: one reader per metric, end-to-end or
  per-layer, which declares its unit, direction and source (and a
  per-layer one its layer and the end-to-end metric it moves) and reads
  the metric from a :class:`Run`, or returns ``None`` where it finds
  nothing to read;
* ``perfbench/limits/<workload>.json``: the limit of each number the
  cell's comparison gives.

A window module exposes ``run(ctx) -> Run``. It times set-up from the
process's start, warms up every shape, measures for ``ctx.seconds`` (with
``ctx.trace``, a window under the profiler instead) and reads the peak
memory. The metric readers then read the run while the program is still
there, and ``Run.finish`` frees the program and runs the comparison.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    root: Path = ROOT  # the checkout whose BENCHMARK.json and perfbench/ files name it


@dataclasses.dataclass
class Context:
    """What a window module gets: the cell and the run's arguments."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # time.perf_counter() at the process's start


@dataclasses.dataclass
class Run:
    """What a window module hands back, and what the metric readers read."""

    kind: str  # the window module's name
    setup_s: float
    window_s: float
    counts: dict  # work completed in the window: "sweeps", "users", "calls"
    attempted: int
    failed: int
    peak_bytes: int
    finish: Callable[[], dict]  # frees the program, then compares: number compared -> value
    shapes: dict = dataclasses.field(default_factory=dict)  # sizes the work counts need
    program: dict = dataclasses.field(default_factory=dict)  # the program's objects, until ``finish``
    trace: Any = None  # trace.Trace of the traced window
    device_kind: str = ""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix and limits."""
    cells = {w["name"]: w for w in spec(root)["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[name]
    files = root / "perfbench"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(files / "configs" / f"{w['config']}.json"),
        traffic=load_json(files / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(files / "limits" / f"{name}.json"),
        root=root,
    )


def load_module(path: Path) -> ModuleType:
    """Import a harness file by path (metric files carry dots in their names)."""
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_file_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "perfbench" / "metrics" / f"{name}.py")


def window_module(kind: str) -> ModuleType:
    return importlib.import_module(f"perfbench.windows.{kind}")


def cell_metrics(cell: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with ``trace`` its per-layer ones."""
    return [m for m in spec(root)["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> dict:
    """One run of ``cell``: the result line's object (``checks`` last)."""
    ctx = Context(cell, seed, seconds, trace, device, t0)
    run = window_module(cell.traffic["window"]).run(ctx)
    metrics = {}
    for m in cell_metrics(cell.name, trace, cell.root):
        value = metric_reader(m["name"], cell.root).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"cell {cell.name} reports no {m['name']}, which BENCHMARK.json declares for it")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {}
    for name, value in run.finish().items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in the limits of {cell.name}")
        checks[name] = {"value": float(value), "limit": float(cell.limits[name])}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": run.device_kind,
        "count": cell.chips,
        "memory_peak_bytes": int(run.peak_bytes),
    }
    out = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
