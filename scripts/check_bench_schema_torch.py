#!/usr/bin/env python
"""Validate the port's benchmark JSON (``experiments/bench_torch``) against its schema.

Usage: ``python scripts/check_bench_schema_torch.py <name> [<name> ...]``
with ``<name>`` one of ``fig2_item_update``, ``fig3_multicore``,
``fig4_scaling``, ``fig5_overlap``, ``fig_merge_comm``, ``serve_latency``,
``serve_load``, ``sweep_throughput``, ``rmse_convergence`` and
``gram_cuda`` (the autotune cache the fig2 run records,
``experiments/autotune/gram_cuda.json``: every entry names its card, and
no CUDA key holds ``"xla"``). Exits non-zero with a list of violations.

The required keys are those ``scripts/check_bench_schema.py`` requires of
the JAX package's files of the same names (copied here, not imported),
with the port's differences: every payload names the device it ran on
(``device``: ``"gpu"`` or ``"cpu"``) and the ``card`` (on a GPU the
line ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives); a fig2 run on the card times no ``"xla"`` (the plain version runs
on the CPU only) and records the fused kernel's chunk width ``pc`` or the
per-bucket kernel's ``piece``; ``rmse_convergence`` has a checker of its
own, and so has ``fig3_multicore`` (the reference has none): on the
card every variant must have launched the Gram kernel. The reference's
gates that hold on every file hold here too (fig4's
``model_matches``, serve_load's zero errors and drops, fig_merge_comm's
acceptance booleans outside a smoke run), and fig4's multi-process
layouts must carry the rotation bytes the model gives. With ``--path
FILE`` (one name only) the payload is read from ``FILE``; without it the
payload is a committed file, which is also held to the smoke contract
(``"smoke"`` present and false), must come from the card (``"device":
"gpu"``) and must pass :data:`COMMITTED_GATES` (fig5's ``parity_ok`` and
``ring_async_bitwise``; fig_merge_comm's ``beats_baseline``,
``within_band`` and ``zero_comm_ok``).
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


LAT_KEYS = ("p50_ms", "p99_ms", "mean_ms", "qps")


def _positive(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and x > 0


def check_fig3_multicore(payload: dict) -> list[str]:
    """fig3_multicore.json: one half-sweep per bucketing variant."""
    errs: list[str] = []
    results = payload.get("results")
    if not isinstance(results, dict):
        return ["results: missing"]
    for mode in ("bucketed_lpt", "bucketed_coarse", "maxpad_graphlab_like"):
        e = results.get(mode)
        where = f"results[{mode}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: missing")
            continue
        for k in ("seconds_per_halfsweep", "updates_per_s", "eager_seconds_per_halfsweep"):
            if not _positive(e.get(k)):
                errs.append(f"{where}.{k}: missing or non-positive")
        buckets = e.get("buckets")
        if not isinstance(buckets, list) or not buckets or any(
                not isinstance(b, list) or len(b) != 2 or not all(isinstance(x, int) for x in b) for b in buckets):
            errs.append(f"{where}.buckets: needs a non-empty list of [B, P]")
        launches = e.get("gram_launches")
        if not isinstance(launches, dict) or not all(isinstance(v, int) and v >= 0 for v in launches.values()):
            errs.append(f"{where}.gram_launches: needs non-negative int counts")
        elif payload.get("device") == "gpu" and not launches.get("LAUNCHES"):
            errs.append(f"{where}.gram_launches: the half-sweep launched no bpmf_gram kernel on the card")
    for k in ("speedup_bucketed_vs_maxpad", "eager_speedup_bucketed_vs_maxpad"):
        if not _positive(results.get(k)):
            errs.append(f"results.{k}: missing or non-positive")
    return errs


def check_fig4_scaling(payload: dict) -> list[str]:
    """fig4_scaling.json: the width sweep and the process-count sweep."""
    errs: list[str] = []
    if not isinstance(payload.get("cards"), int) or payload["cards"] < 0:
        errs.append("cards: missing or negative")
    widths = payload.get("widths")
    if not isinstance(widths, list) or not widths or any(not isinstance(w, int) or w < 1 for w in widths):
        errs.append("widths: needs a list of positive ints")
    modes = payload.get("modes")
    if not isinstance(modes, dict) or not {"ring", "allgather"} <= set(modes):
        errs.append("modes: needs ring and allgather entries")
    else:
        for mode, rows in modes.items():
            if not isinstance(rows, list) or not rows:
                errs.append(f"modes[{mode}]: missing or empty")
                continue
            for i, r in enumerate(rows):
                for k in ("devices", "seconds", "updates_per_s", "speedup"):
                    if not _positive(r.get(k)):
                        errs.append(f"modes[{mode}][{i}].{k}: missing or non-positive")
    ps = payload.get("process_sweep")
    if not isinstance(ps, dict):
        return errs + ["process_sweep: missing"]
    S = ps.get("global_devices")
    if not isinstance(S, int) or S < 1:
        errs.append("process_sweep.global_devices: missing or < 1")
    rb = ps.get("ring_bytes_per_sweep")
    if not isinstance(rb, dict) or any(not isinstance(rb.get(k), int) or rb.get(k, 0) <= 0
                                       for k in ("modelled", "measured", "cap_u", "cap_v")):
        errs.append("process_sweep.ring_bytes_per_sweep: needs positive int modelled/measured/cap_u/cap_v")
    elif rb.get("model_matches") is not True:
        errs.append(f"process_sweep.ring_bytes_per_sweep.model_matches: False — modelled {rb['modelled']} "
                    f"!= metered {rb['measured']}")
    layouts = ps.get("layouts")
    if not isinstance(layouts, list) or not layouts:
        return errs + ["process_sweep.layouts: missing or empty"]
    seen_multi = False
    for i, r in enumerate(layouts):
        where = f"process_sweep.layouts[{i}]"
        for k in ("processes", "devices_per_process"):
            if not isinstance(r.get(k), int) or r.get(k, 0) < 1:
                errs.append(f"{where}.{k}: missing or < 1")
        if isinstance(S, int) and isinstance(r.get("processes"), int) and isinstance(
                r.get("devices_per_process"), int) and r["processes"] * r["devices_per_process"] != S:
            errs.append(f"{where}: processes x devices_per_process != global_devices ({S})")
        for k in ("seconds", "sweeps_per_s"):
            if not _positive(r.get(k)):
                errs.append(f"{where}.{k}: missing or non-positive")
        cross = r.get("cross_process_bytes_per_sweep")
        if not isinstance(cross, int) or cross < 0:
            errs.append(f"{where}.cross_process_bytes_per_sweep: missing or negative")
        elif r.get("processes") == 1 and cross != 0:
            errs.append(f"{where}: single-process layout must report 0 cross-process bytes")
        elif isinstance(r.get("processes"), int) and r["processes"] > 1:
            seen_multi = True
            if cross == 0:
                errs.append(f"{where}: multi-process layout reports 0 cross-process bytes")
            if r.get("rotation_model_matches") is not True:
                errs.append(f"{where}.rotation_model_matches: the rotation bytes sent between processes "
                            f"({r.get('cross_process_rotation_bytes_per_sweep')}) are not the model's "
                            f"({r.get('modelled_cross_process_bytes_per_sweep')})")
    if not seen_multi:
        errs.append("process_sweep.layouts: needs at least one multi-process layout")
    return errs


def check_fig5_overlap(payload: dict) -> list[str]:
    """fig5_overlap.json: the comm modes' sweep times and the parity flags."""
    errs: list[str] = []
    if not isinstance(payload.get("cards"), int) or payload["cards"] < 0:
        errs.append("cards: missing or negative")
    modes = payload.get("modes")
    if not isinstance(modes, dict) or not modes:
        return errs + ["modes: missing or empty"]
    for required in ("ring", "allgather"):
        if required not in modes:
            errs.append(f"modes: missing {required!r}")
    for name, m in modes.items():
        for k in ("seconds", "seconds_per_sweep", "eager_seconds", "rmse"):
            if not _positive(m.get(k)):
                errs.append(f"modes[{name}].{k}: missing or non-positive")
    speedups = payload.get("speedup_vs_allgather")
    if not isinstance(speedups, dict) or set(speedups) != set(modes) or not all(map(_positive, speedups.values())):
        errs.append("speedup_vs_allgather: needs a positive entry per mode")
    for k in ("parity_ok", "ring_async_bitwise"):
        if not isinstance(payload.get(k), bool):
            errs.append(f"{k}: missing or non-bool")
    return errs


def check_fig_merge_comm(payload: dict) -> list[str]:
    """fig_merge_comm.json: RMSE against communication."""
    errs: list[str] = []
    if not isinstance(payload.get("baseline_rmse"), (int, float)):
        errs.append("baseline_rmse: missing or non-numeric")
    band = payload.get("merge_band")
    if (not isinstance(band, list) or len(band) != 2 or not all(isinstance(b, (int, float)) for b in band)
            or band[0] >= band[1]):
        errs.append("merge_band: needs [lo, hi] with lo < hi")
    smoke = bool(payload.get("smoke", False))
    for k in ("beats_baseline", "within_band", "zero_comm_ok"):
        if not isinstance(payload.get(k), bool):
            errs.append(f"{k}: missing or non-bool")
        elif not payload[k] and not smoke:
            errs.append(f"{k}: False — merge quality/communication bar missed")
    backends = payload.get("backends")
    if not isinstance(backends, dict) or not backends:
        return errs + ["backends: missing or empty"]
    for required in ("sequential", "ring"):
        if required not in backends:
            errs.append(f"backends: missing {required!r} entry")
    if not any(n.startswith("posterior_merge_p") for n in backends):
        errs.append("backends: needs at least one posterior_merge_p<N> entry")
    for name, e in backends.items():
        where = f"backends[{name}]"
        for k in ("rmse", "rmse_artifact", "seconds"):
            if not _positive(e.get(k)):
                errs.append(f"{where}.{k}: missing or non-positive")
        for k in ("bytes_per_sweep", "collective_ops"):
            if not isinstance(e.get(k), int) or e.get(k, -1) < 0:
                errs.append(f"{where}.{k}: missing or negative")
        if name.startswith("posterior_merge") and e.get("collective_ops", 1) != 0:
            errs.append(f"{where}.collective_ops: {e.get('collective_ops')!r} (must be 0 — a merge chain "
                        "called the ring)")
        if name in ("ring", "ring_async", "allgather") and e.get("bytes_per_sweep", 0) <= 0:
            errs.append(f"{where}.bytes_per_sweep: ring-family entry must be positive")
    return errs


def _check_artifact(payload: dict) -> list[str]:
    art = payload.get("artifact")
    if not isinstance(art, dict) or not all(
            isinstance(art.get(k), int) for k in ("num_users", "num_movies", "K", "num_mean_samples",
                                                  "num_kept_samples")):
        return ["artifact: needs int num_users/num_movies/K/num_mean_samples/num_kept_samples"]
    return []


def check_serve_latency(payload: dict) -> list[str]:
    """serve_latency.json: the predictor's batch sweep and top-k probe."""
    errs = _check_artifact(payload)
    if not isinstance(payload.get("repeats"), int) or payload.get("repeats", 0) < 1:
        errs.append("repeats: missing or < 1")
    batches = payload.get("batches")
    if not isinstance(batches, dict) or not batches:
        return errs + ["batches: missing or empty"]
    for name, e in batches.items():
        where = f"batches[{name}]"
        if not name.isdigit() or int(name) < 1:
            errs.append(f"{where}: key must be a positive batch size")
        if not isinstance(e, dict) or not all(_positive(e.get(k)) for k in LAT_KEYS):
            errs.append(f"{where}: needs positive numeric {LAT_KEYS}")
        elif e["p50_ms"] > e["p99_ms"] + 1e-9:
            errs.append(f"{where}: p50_ms > p99_ms")
    tk = payload.get("top_k")
    if not isinstance(tk, dict) or not isinstance(tk.get("k"), int) or not all(_positive(tk.get(k)) for k in LAT_KEYS):
        errs.append(f"top_k: needs int k and positive numeric {LAT_KEYS}")
    return errs


def check_serve_load(payload: dict) -> list[str]:
    """serve_load.json: sharded against replicated top-k, and closed-loop load on the server."""
    errs = _check_artifact(payload)
    lat_keys = LAT_KEYS[:3]
    tk = payload.get("top_k")
    if not isinstance(tk, dict):
        errs.append("top_k: missing")
    else:
        for mode in ("replicated", "sharded"):
            e = tk.get(mode)
            if not isinstance(e, dict) or not all(_positive(e.get(k)) for k in lat_keys):
                errs.append(f"top_k.{mode}: needs positive numeric {lat_keys}")
        if "recorded_full_catalog_p99_ms" in tk and tk.get("sharded_beats_recorded") is not True:
            errs.append(f"top_k.sharded_beats_recorded: False — sharded top-k p99 "
                        f"({tk.get('sharded', {}).get('p99_ms')}) does not beat the recorded p99 of the same "
                        f"catalog ({tk.get('recorded_full_catalog_p99_ms')})")
    load = payload.get("load")
    if not isinstance(load, dict) or not load:
        return errs + ["load: missing or empty"]
    for name, e in load.items():
        where = f"load[{name}]"
        if not name.isdigit() or int(name) < 1:
            errs.append(f"{where}: key must be a positive client count")
            continue
        for k in ("requests", "offered_qps", "batcher_occupancy", *lat_keys):
            if not _positive(e.get(k)):
                errs.append(f"{where}.{k}: missing or non-positive")
        for k in ("errors", "dropped"):  # the serving contract: no request errors, none dropped
            if e.get(k) != 0:
                errs.append(f"{where}.{k}: {e.get(k)!r} (must be 0)")
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
    "fig3_multicore": check_fig3_multicore,
    "fig4_scaling": check_fig4_scaling,
    "fig5_overlap": check_fig5_overlap,
    "fig_merge_comm": check_fig_merge_comm,
    "gram_cuda": check_gram_cuda,
    "rmse_convergence": check_rmse_convergence,
    "serve_latency": check_serve_latency,
    "serve_load": check_serve_load,
    "sweep_throughput": check_sweep_throughput,
}
# the acceptance booleans a committed file must hold true
COMMITTED_GATES = {
    "fig5_overlap": ("parity_ok", "ring_async_bitwise"),
    "fig_merge_comm": ("beats_baseline", "within_band", "zero_comm_ok"),
}
# the committed file of each name
PATHS = {name: os.path.join(BENCH_DIR, f"{name}.json") for name in CHECKERS}
PATHS["gram_cuda"] = os.path.join(BENCH_DIR, "..", "autotune", "gram_cuda.json")


def check(name: str, payload: dict, committed: bool) -> list[str]:
    """Every violation of ``payload`` as the ``name`` file (``committed``: also the smoke contract)."""
    if name == "gram_cuda":
        return check_gram_cuda(payload)
    errs = check_device(payload) + CHECKERS[name](payload)
    if committed:
        if payload.get("smoke") is not False:
            errs.append(f"smoke: {payload.get('smoke')!r} — a committed file must come from a full run")
        if payload.get("device") != "gpu":
            errs.append(f"device: {payload.get('device')!r} — a committed file must come from the card")
        errs += [f"{k}: {payload.get(k)!r} — a committed file must hold it true"
                 for k in COMMITTED_GATES.get(name, ()) if payload.get(k) is not True]
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
