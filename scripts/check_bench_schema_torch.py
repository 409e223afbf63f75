#!/usr/bin/env python
"""Validate the port's benchmark JSON (``experiments/bench_torch``) against its schema.

Usage: ``python scripts/check_bench_schema_torch.py <name> [<name> ...]``
with ``<name>`` one of ``fig2_item_update``, ``sweep_throughput``,
``rmse_convergence`` and ``gram_cuda`` (the autotune cache the fig2 run
records, ``experiments/autotune/gram_cuda.json``: every entry names its
card, and no CUDA key holds ``"xla"``). Exits non-zero with a list of
violations.

The required keys are those ``scripts/check_bench_schema.py`` requires of
the JAX package's files of the same names (copied here, not imported),
with the port's differences: every payload names the device it ran on
(``device``: ``"gpu"`` or ``"cpu"``) and the ``card`` (on a GPU the
line ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives); a fig2 run on the card times no ``"xla"`` (the plain version runs
on the CPU only) and records the fused kernel's chunk width ``pc`` or the
per-bucket kernel's ``piece``; ``rmse_convergence`` has a checker of its
own. With ``--path FILE`` (one name only) the payload is read from
``FILE``; without it the committed file is also held to the smoke
contract: ``"smoke"`` must be present and false.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments", "bench_torch")

KERNEL_IMPLS = ("pallas_fused", "pallas")  # timed on the card
IMPLS = KERNEL_IMPLS + ("xla",)  # and the plain version, timed on the CPU only


def check_device(payload: dict) -> list[str]:
    """The device record every payload of the port carries."""
    errs: list[str] = []
    if payload.get("device") not in ("gpu", "cpu"):
        errs.append(f"device: unexpected {payload.get('device')!r}")
    card = payload.get("card")
    if not isinstance(card, str) or not card:
        errs.append("card: missing or empty")
    elif payload.get("device") == "gpu" and card == "cpu":
        errs.append("card: a gpu payload names no card")
    if not isinstance(payload.get("devices"), int) or payload.get("devices", 0) < 1:
        errs.append("devices: missing or < 1")
    return errs


def check_fig2_item_update(payload: dict) -> list[str]:
    """fig2_item_update.json: the cost-model fit and the measured kernel sweep."""
    errs: list[str] = []
    rows = payload.get("rows")
    if not isinstance(rows, list) or not rows:
        errs.append("rows: missing or empty")
    else:
        for i, r in enumerate(rows):
            for k in ("nnz", "t_naive_s", "t_single_chol_s", "t_batched_per_item_s"):
                if not isinstance(r.get(k), (int, float)):
                    errs.append(f"rows[{i}].{k}: missing or non-numeric")
    cm = payload.get("cost_model")
    if not isinstance(cm, dict) or not all(isinstance(cm.get(k), (int, float)) for k in ("fixed_us", "per_rating_us")):
        errs.append("cost_model: needs numeric fixed_us and per_rating_us")
    needed = KERNEL_IMPLS if payload.get("device") == "gpu" else IMPLS
    sweep = payload.get("kernel_sweep")
    if not isinstance(sweep, dict) or not sweep:
        errs.append("kernel_sweep: missing or empty")
        return errs
    entries = [(f"kernel_sweep[{n}]", e) for n, e in sweep.items()]
    ws = payload.get("workload_sweep")
    if ws:  # full runs only
        entries += [(f"workload_sweep.entries[{n}]", e) for n, e in ws.get("entries", {}).items()]
        for n, e in ws.get("entries", {}).items():
            if not isinstance(e.get("cap"), int):
                errs.append(f"workload_sweep.entries[{n}].cap: missing or non-int")
    for where, e in entries:
        if e.get("winner") not in needed:
            errs.append(f"{where}.winner: {e.get('winner')!r} not in {needed}")
        elif e["winner"] == "pallas_fused" and not isinstance(e.get("pc"), int):
            errs.append(f"{where}.pc: a fused winner needs its chunk width")
        t = e.get("timings_us")
        if not isinstance(t, dict) or not set(needed) <= set(t):
            errs.append(f"{where}.timings_us: needs all of {needed}")
        elif any(not isinstance(t[k], (int, float)) or t[k] <= 0 for k in needed):
            errs.append(f"{where}.timings_us: non-positive or non-numeric entry")
        elif payload.get("device") == "gpu" and "xla" in t:
            errs.append(f"{where}.timings_us: the plain version was timed on the card")
        if not isinstance(e.get("buckets"), list) or not e["buckets"]:
            errs.append(f"{where}.buckets: missing or empty")
        for k in ("Ns", "K"):
            if not isinstance(e.get(k), int):
                errs.append(f"{where}.{k}: missing or non-int")
    return errs


def check_sweep_throughput(payload: dict) -> list[str]:
    """sweep_throughput.json: the blocked run loop's rate and host traffic."""
    errs: list[str] = []
    gather = payload.get("factor_gather_bytes")
    if not isinstance(gather, (int, float)) or gather <= 0:
        errs.append("factor_gather_bytes: missing or non-positive")
    for k in ("parity_ok", "block_transfer_drop_ok"):
        if not isinstance(payload.get(k), bool):
            errs.append(f"{k}: missing or non-bool")
        elif not payload[k]:
            errs.append(f"{k}: False — blocked loop regressed")
    backends = payload.get("backends")
    if not isinstance(backends, dict) or not backends:
        errs.append("backends: missing or empty")
        return errs
    needed = ("seconds", "sweeps_per_sec", "host_bytes_per_sweep", "rmse")
    for name, entries in backends.items():
        if not isinstance(entries, dict) or "legacy_emulated" not in entries:
            errs.append(f"backends[{name}]: needs block_* and legacy_emulated entries")
            continue
        if not any(k.startswith("block_") and k != "block_1" for k in entries):
            errs.append(f"backends[{name}]: needs at least one block_>1 entry")
        for label, e in entries.items():
            for k in needed:
                if not isinstance(e.get(k), (int, float)) or e.get(k, 0) <= 0:
                    errs.append(f"backends[{name}].{label}.{k}: missing or non-positive")
        if not isinstance(entries["legacy_emulated"].get("host_bytes_per_post_burn_in_sweep"), (int, float)):
            errs.append(f"backends[{name}].legacy_emulated.host_bytes_per_post_burn_in_sweep: missing or non-numeric")
        for label in ("overlap_off", "overlap_on"):
            e = entries.get(label)
            where = f"backends[{name}].{label}"
            if not isinstance(e, dict):
                errs.append(f"{where}: missing overlap entry")
                continue
            if not isinstance(e.get("pipeline_blocks"), int) or e["pipeline_blocks"] < 1:
                errs.append(f"{where}.pipeline_blocks: missing or < 1")
            hb = e.get("host_blocked_s_per_block")
            if not isinstance(hb, (int, float)) or hb < 0:
                errs.append(f"{where}.host_blocked_s_per_block: missing or negative")
    if not isinstance(payload.get("overlap_speedup_ok"), bool):
        errs.append("overlap_speedup_ok: missing or non-bool")
    elif not payload["overlap_speedup_ok"]:
        print("sweep_throughput: warning — overlap_speedup_ok is False (recorded, not a gate)")
    lat = payload.get("save_return_latency")
    if not isinstance(lat, dict) or not all(
        isinstance(lat.get(k), (int, float)) and lat.get(k, 0) > 0 for k in ("async_s", "sync_s")
    ):
        errs.append("save_return_latency: needs positive numeric async_s and sync_s")
    elif not isinstance(lat.get("async_returns_faster"), bool):
        errs.append("save_return_latency.async_returns_faster: missing or non-bool")
    return errs


def check_rmse_convergence(payload: dict) -> list[str]:
    """rmse_convergence.json: the backends' RMSE trajectories from one seed."""
    errs: list[str] = []
    curves = payload.get("curves")
    if not isinstance(curves, dict) or "sequential" not in curves or len(curves) < 3:
        errs.append("curves: needs sequential and two distributed trajectories")
        return errs
    lengths = {len(v) if isinstance(v, list) else -1 for v in curves.values()}
    if len(lengths) != 1 or min(lengths) < 1:
        errs.append("curves: trajectories missing or of different lengths")
    elif any(not isinstance(x, (int, float)) or not x > 0 for v in curves.values() for x in v):
        errs.append("curves: non-positive or non-numeric RMSE")
    for k in ("spread", "max_trajectory_gap", "parity_tol", "noise_floor"):
        if not isinstance(payload.get(k), (int, float)):
            errs.append(f"{k}: missing or non-numeric")
    if payload.get("parity_ok") is not True:
        errs.append("parity_ok: not True — a backend's trajectory left the sequential one's band")
    return errs


def check_gram_cuda(payload: dict) -> list[str]:
    """experiments/autotune/gram_cuda.json: the autotune cache (``repro_torch.kernels.autotune``)."""
    errs: list[str] = []
    if payload.get("version") != 1:
        errs.append(f"version: {payload.get('version')!r}, want 1")
    entries = payload.get("entries")
    if not isinstance(entries, dict) or not entries:
        return errs + ["entries: missing or empty"]
    for key, e in entries.items():
        cuda = key.split("_cap")[0].endswith("_cuda")
        allowed = KERNEL_IMPLS if cuda else IMPLS
        if e.get("impl") not in allowed:
            errs.append(f"entries[{key}].impl: {e.get('impl')!r} not in {allowed}")
        if not isinstance(e.get("card"), str) or not e["card"] or (cuda and e["card"] == "cuda"):
            errs.append(f"entries[{key}].card: missing, or names no card")
        t = e.get("timings_us")
        if e.get("source") == "measured" and (not isinstance(t, dict) or not t or any(
                not isinstance(v, (int, float)) or v <= 0 for v in t.values())):
            errs.append(f"entries[{key}].timings_us: a measured entry needs positive timings")
    return errs


CHECKERS = {
    "fig2_item_update": check_fig2_item_update,
    "gram_cuda": check_gram_cuda,
    "rmse_convergence": check_rmse_convergence,
    "sweep_throughput": check_sweep_throughput,
}
# the committed file of each name
PATHS = {name: os.path.join(BENCH_DIR, f"{name}.json") for name in CHECKERS}
PATHS["gram_cuda"] = os.path.join(BENCH_DIR, "..", "autotune", "gram_cuda.json")


def check(name: str, payload: dict, committed: bool) -> list[str]:
    """Every violation of ``payload`` as the ``name`` file (``committed``: also the smoke contract)."""
    if name == "gram_cuda":
        return check_gram_cuda(payload)
    errs = check_device(payload) + CHECKERS[name](payload)
    if committed and payload.get("smoke") is not False:
        errs.append(f"smoke: {payload.get('smoke')!r} — a committed file must come from a full run")
    return errs


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description="validate experiments/bench_torch JSON")
    ap.add_argument("names", nargs="+", metavar="name", help=f"one of {sorted(CHECKERS)}")
    ap.add_argument("--path", default=None, help="read the payload from this file (one name only)")
    args = ap.parse_args(argv)
    if args.path and len(args.names) != 1:
        ap.error("--path takes exactly one name")
    rc = 0
    for name in args.names:
        if name not in CHECKERS:
            print(f"{name}: no schema checker (known: {sorted(CHECKERS)})")
            rc = 1
            continue
        path = os.path.normpath(args.path or PATHS[name])
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{name}: cannot load {path}: {e}")
            rc = 1
            continue
        errs = check(name, payload, committed=not args.path)
        if errs:
            print(f"{name}: schema FAILED ({len(errs)} violation(s))")
            for e in errs:
                print(f"  - {e}")
            rc = 1
        else:
            print(f"{name}: schema OK ({path})")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
