"""Paper §V-B on the card: every parallel version reaches the same RMSE.

The port's counterpart of ``benchmarks/rmse_convergence.py``: the same
``(seed, data)`` through the engine's ``sequential``, ``ring`` and
``allgather`` backends (the ring ones with ``NUM_SHARDS`` shards on the
one device), and each one's RMSE trajectory (``rmse_avg`` per sweep). The
samplers share per-item randomness, so the trajectories agree to float
summation order: ``parity_ok`` holds every trajectory within
``PARITY_TOL`` of the sequential one at every sweep. Writes
``experiments/bench_torch/rmse_convergence.json``; a smoke run writes to a
temporary directory unless ``--out`` is given::

    PYTHONPATH=src:. python -m benchmarks_torch.rmse_convergence --device cpu --smoke
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks_torch.common import device_record, save_result, smoke_out_path
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.utils import resolve_device

NUM_SHARDS = 4
PARITY_TOL = 1e-3
NOISE_STD = 0.4


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """The three backends' RMSE trajectories from one seed; writes the JSON and returns it."""
    device = resolve_device(device)
    coo = load_dataset(
        "synthetic",
        num_users=300 if smoke else 1_500,
        num_movies=200 if smoke else 600,
        nnz=5_000 if smoke else 50_000,
        noise_std=NOISE_STD,
    )
    K = 8 if smoke else 16
    sweeps = 4 if smoke else 20
    cfg = BPMFConfig().replace(K=K, num_sweeps=sweeps, burn_in=max(1, sweeps // 4), seed=7, num_shards=NUM_SHARDS)

    curves = {}
    for name in ("sequential", "ring", "allgather"):
        engine = BPMFEngine(cfg.replace(name=name), device=device).fit(coo)
        label = name if name == "sequential" else f"distributed_{name}_{NUM_SHARDS}shards"
        curves[label] = [m.rmse_avg for m in engine.history]

    finals = {k: v[-1] for k, v in curves.items()}
    gap = float(max(np.max(np.abs(np.subtract(v, curves["sequential"]))) for v in curves.values()))
    out = {
        **device_record(device),
        "smoke": bool(smoke),
        "workload": {"users": coo.num_users, "movies": coo.num_movies, "nnz": coo.nnz, "K": K,
                     "sweeps": sweeps, "num_shards": NUM_SHARDS, "seed": 7},
        "curves": curves,
        "final_rmse": finals,
        "spread": max(finals.values()) - min(finals.values()),
        "max_trajectory_gap": gap,
        "parity_tol": PARITY_TOL,
        "noise_floor": NOISE_STD,
        "parity_ok": bool(gap < PARITY_TOL),
    }
    print(f"[rmse_convergence] finals={ {k: round(v, 4) for k, v in finals.items()} } "
          f"max trajectory gap={gap:.2e}", flush=True)
    path = save_result("rmse_convergence", out, out=smoke_out_path("rmse_convergence", smoke, out_path))
    print(f"[rmse_convergence] wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device)
