"""The benchmark's cells at sizes a CPU test run holds, driven through the harness on the CPU."""
from __future__ import annotations

import time

import torch

from perfbench import bench

CPU = torch.device("cpu")
SEED = 2_718_281_828  # above 2**31, as the driver's are


def cell(name: str) -> bench.Cell:
    """``name`` of ``BENCHMARK.json`` with its data cut to a few hundred rows, K = 4, blocks of 2
    sweeps (burn-in 1, so both branches of the averaging run), its limits kept."""
    c = bench.load_cell(name)
    c.config["model"]["K"] = 4
    if c.traffic["window"] == "gibbs":
        c.config["data"].update(num_users=100, num_movies=60, nnz=2000)
        c.traffic.update(sweeps_per_block=2, checked_sweeps=2, burn_in=1)
    else:
        c.config["data"].update(num_users=600, num_movies=300)
        c.traffic.update(batch_users=128)
    return c


def run(name: str, trace: bool = False, seconds: float = 0.05, c: bench.Cell | None = None) -> dict:
    """One harness run of the tiny cell on the CPU, the card check skipped."""
    return bench.run_cell(c or cell(name), SEED, seconds, trace, CPU, time.perf_counter())
