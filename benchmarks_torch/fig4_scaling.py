"""Paper Figure 4 on the card: updates/s against shard count, and one ring re-split over processes.

The port's counterpart of ``benchmarks/fig4_scaling.py``, with its two sweeps:

* **width sweep**: a ring of S in ``WIDTHS`` shards for ``ring`` and
  ``allgather`` on an ml-100k-shaped synthetic, updates/s of the steady
  replayed sweeps (the capture taken off and given beside them as
  ``capture_seconds``, with ``compile_plus_run_s`` the whole fit) and the
  speedup over S = 1. ``devices`` in a row is the shard count S, the
  reference's field;
* **process sweep**: the same S re-split over 1, 2 and 4 processes, each
  layout one ``python -m repro_torch.launch.multiproc`` job (every child
  under the launcher's ``--timeout``: a dead peer would otherwise hold the
  others in ``gloo`` for 600 s). Sweeps/s come from the CLI's final line.
  ``ring_bytes_per_sweep`` holds the reference's model of the ring's
  traffic per sweep, ``S * (S-1) * (cap_u + cap_v) * K * 4``, against the
  bytes of every block that passes through ``Ring.rotate`` in one fresh
  eager sweep (metered on the ``Ring`` class and unmetered afterwards,
  :func:`benchmarks_torch.common.metered_ring`); ``model_matches`` says
  they agree. Each layout's ``cross_process_bytes_per_sweep`` is what its
  processes' rings sent to one another (rotation and gathers, from each
  rank's ``ring traffic:`` line), with the reference's per-edge model of
  the rotation's share beside it, ``processes`` of the S ring edges
  crossing processes.

Every shard and every process sits on the one card (``cards`` is 1), so
this shows what more shards and more processes cost on one device, not
scaling across cards, which waits for a machine with several (ROADMAP
Queue 1 item 9). The processes share the card over ``gloo``, and a
multi-process layout runs its sweeps eagerly. Writes
``experiments/bench_torch/fig4_scaling.json``; a smoke run writes to a
temporary directory unless ``--out`` is given::

    PYTHONPATH=src:. python -m benchmarks_torch.fig4_scaling --device cpu --smoke
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from collections.abc import Sequence

import torch

from benchmarks_torch.common import capture_seconds, device_record, fit_timed, metered_sweep, save_result, \
    smoke_out_path, warm_up
from repro_torch.bpmf import BPMFConfig, BPMFEngine
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings
from repro_torch.utils import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (1, 2, 4, 8)
PROCESSES = (1, 2, 4)

# the CLI's final line (``launch/bpmf.py``), the reference's format and pattern
_FINAL_RE = re.compile(r"after (\d+) sweeps \((\d+) this run\) in ([0-9.]+)s")
_TRAFFIC_RE = re.compile(
    r"ring traffic: process (\d+) of (\d+) sent (\d+) rotation bytes and (\d+) gather bytes to other "
    r"processes, staged (\d+) bytes through the host, in (\d+) sweeps"
)


def process_spec(smoke: bool) -> SyntheticSpec:
    """The process sweep's ratings (the reference's)."""
    return SyntheticSpec(num_users=240 if smoke else 800, num_movies=160 if smoke else 400,
                         nnz=3_000 if smoke else 12_000, discretize=False)


def ring_bytes_per_sweep(coo, K: int, S: int, device: torch.device) -> dict:
    """The modelled and the metered bytes of ``Ring.rotate`` in one sweep of an S-shard ring."""
    engine = BPMFEngine(BPMFConfig().replace(name="ring", K=K, num_sweeps=1, burn_in=0, num_shards=S),
                        device=device)
    engine.prepare(coo)
    plan = engine.backend.plan
    cap_u, cap_v = plan.part_users.cap, plan.part_movies.cap
    modelled = S * (S - 1) * (cap_u + cap_v) * K * 4
    meter = metered_sweep(engine)
    return {
        "cap_u": int(cap_u),
        "cap_v": int(cap_v),
        "rotate_calls": meter["rotate_calls"],
        "modelled": int(modelled),
        "measured": int(meter["rotate_bytes"]),
        "model_matches": bool(meter["rotate_bytes"] == modelled),
    }


def run_layout(procs: int, S: int, spec: SyntheticSpec, K: int, sweeps: int, device: torch.device,
               timeout: float) -> dict:
    """One job of ``procs`` processes holding ``S / procs`` shards each; its sweeps/s and traffic."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.multiproc", "--num-processes", str(procs),
        "--timeout", str(timeout), "--",
        "--device", device.type, "--backend", "ring", "--num-shards", str(S), "--dataset", "synthetic",
        "--users", str(spec.num_users), "--movies", str(spec.num_movies), "--nnz", str(spec.nnz),
        "--K", str(K), "--sweeps", str(sweeps), "--burn-in", "1",
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO_ROOT, "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout + 60)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"layout {procs} x {S // procs} failed rc={r.returncode}:\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-1000:]}")
    m = _FINAL_RE.search(r.stdout)
    if not m:
        raise RuntimeError(f"layout {procs} x {S // procs}: no final line in\n{r.stdout[-2000:]}")
    this_run, seconds = int(m.group(2)), float(m.group(3))
    traffic = [tuple(int(x) for x in t) for t in _TRAFFIC_RE.findall(r.stdout)]
    if procs > 1 and sorted(t[0] for t in traffic) != list(range(procs)):
        raise RuntimeError(f"layout {procs} x {S // procs}: want one ring traffic line per process in\n"
                           f"{r.stdout[-2000:]}")
    rotation = sum(t[2] for t in traffic)
    gathers = sum(t[3] for t in traffic)
    return {
        "processes": procs,
        "devices_per_process": S // procs,  # shards per process, the reference's field
        "sweeps": this_run,
        "seconds": seconds,
        # in-loop time of a fresh process, the first sweep's capture or
        # kernel build included, as the reference's includes its compile
        "sweeps_per_s": this_run / max(seconds, 1e-9),
        "wall_s": wall,
        "cross_process_bytes_per_sweep": (rotation + gathers) // this_run,
        "cross_process_rotation_bytes_per_sweep": rotation // this_run,
        "cross_process_gather_bytes_per_sweep": gathers // this_run,
        "host_staged_bytes_per_sweep": sum(t[4] for t in traffic) // this_run,
    }


def process_sweep(smoke: bool, device: torch.device, K: int, processes: Sequence[int] = PROCESSES,
                  timeout: float | None = None) -> dict:
    """The process-count sweep: one S re-split over ``processes`` (each must divide S)."""
    S = 4 if smoke else 8
    spec = process_spec(smoke)
    coo, _ = synthetic_ratings(spec)
    sweeps = 2 if smoke else 4
    timeout = timeout or (240.0 if smoke else 600.0)
    bytes_info = ring_bytes_per_sweep(coo, K, S, device)
    per_edge = bytes_info["modelled"] // S  # one ring edge's bytes per sweep
    rows = []
    for procs in processes:
        if S % procs:
            raise ValueError(f"{procs} processes do not divide {S} shards")
        row = run_layout(procs, S, spec, K, sweeps, device, timeout)
        # process-major contiguous shards: exactly `procs` of the S edges
        # cross a process boundary (none for a single process)
        row["modelled_cross_process_bytes_per_sweep"] = per_edge * procs if procs > 1 else 0
        row["rotation_model_matches"] = (row["cross_process_rotation_bytes_per_sweep"]
                                         == row["modelled_cross_process_bytes_per_sweep"])
        rows.append(row)
        print(f"[fig4] processes={procs} x {S // procs}: {row['sweeps_per_s']:.3f} sweeps/s, "
              f"cross-process {row['cross_process_bytes_per_sweep']:,} B/sweep "
              f"(rotation {row['cross_process_rotation_bytes_per_sweep']:,}, "
              f"model {row['modelled_cross_process_bytes_per_sweep']:,})", flush=True)
    return {
        "global_devices": S,  # the ring's shards, the reference's field
        "K": K,
        "dataset": {"num_users": coo.num_users, "num_movies": coo.num_movies, "nnz": int(coo.nnz)},
        "ring_bytes_per_sweep": bytes_info,
        "layouts": rows,
    }


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None,
        processes: Sequence[int] = PROCESSES, timeout: float | None = None) -> dict:
    """Both sweeps; writes the JSON and returns it. ``processes``: the process sweep's layouts."""
    device = resolve_device(device)
    spec = SyntheticSpec(num_users=600 if smoke else 3_000, num_movies=300 if smoke else 900,
                         nnz=8_000 if smoke else 90_000, discretize=False)
    coo, _ = synthetic_ratings(spec)
    K = 8 if smoke else 16
    sweeps = 2 if smoke else 5
    results: dict = {**device_record(device), "smoke": bool(smoke), "widths": list(WIDTHS), "modes": {},
                     "workload": {"users": spec.num_users, "movies": spec.num_movies, "nnz": spec.nnz, "K": K,
                                  "sweeps": sweeps}}
    cards = 0
    warm_up(BPMFConfig().replace(name="ring", K=K, num_shards=WIDTHS[0]), coo, device)
    for mode in ("ring", "allgather"):
        rows = []
        for w in WIDTHS:
            cfg = BPMFConfig().replace(name=mode, K=K, num_sweeps=sweeps, burn_in=1, num_shards=w,
                                       sweeps_per_block=sweeps)
            engine, t = fit_timed(cfg, coo, device)
            if device.type == "cuda":
                cards = max(cards, len(engine.backend.ring.distinct_devices()))
            capture = capture_seconds(engine)
            rows.append({
                "devices": w, "seconds": t, "updates_per_s": (coo.num_users + coo.num_movies) * sweeps / t,
                "rmse_final": engine.rmse, "capture_seconds": capture, "compile_plus_run_s": t + capture,
            })
            print(f"[fig4] {mode} S={w}: {rows[-1]['updates_per_s']:,.0f} updates/s "
                  f"rmse={engine.rmse:.4f} (capture {capture:.3f}s)", flush=True)
        for r in rows:
            r["speedup"] = r["updates_per_s"] / rows[0]["updates_per_s"]
        results["modes"][mode] = rows
    results["cards"] = cards
    results["process_sweep"] = process_sweep(smoke, device, K, processes, timeout)
    results["note"] = (f"every shard and process on {cards} card(s): the cost of shards and processes on one "
                       "device, not scaling across cards")
    rb = results["process_sweep"]["ring_bytes_per_sweep"]
    print(f"[fig4] ring bytes per sweep: measured {rb['measured']:,}, modelled {rb['modelled']:,}, "
          f"model_matches={rb['model_matches']}", flush=True)
    path = save_result("fig4_scaling", results, out=smoke_out_path("fig4_scaling", smoke, out_path))
    print(f"[fig4] wrote {path}", flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--processes", default=",".join(map(str, PROCESSES)),
                    help="process counts of the process sweep, comma-separated")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before a layout's job is killed (default 240 smoke, 600 full)")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device,
        processes=tuple(int(p) for p in args.processes.split(",")), timeout=args.timeout)
