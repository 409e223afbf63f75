"""Paper Figure 5 on the card: ring against all-gather, and the pipelined ring's depths.

The port's counterpart of ``benchmarks/fig5_overlap.py``: the same
``(seed, data)`` through the engine's ``ring`` (one rotation in flight),
``allgather`` (the synchronous baseline) and ``ring_async`` at
``pipeline_depth`` 1, 2 and 4 (DESIGN.md §7), each with ``NUM_SHARDS``
shards on the one device. Each mode's sweeps are timed as the engine runs
them, the captured sweep replayed (``seconds``, the capture taken off and
given as ``capture_seconds``), and again eagerly from the same start
(``eager_seconds``, ``_eager=True``, as ``chip_smoke.py``'s
``graph_sweeps`` runs them).

* ``speedup_vs_allgather`` / ``eager_speedup_vs_allgather``: the
  all-gather mode's seconds over each mode's;
* ``parity_ok``: every mode's final RMSE within ``PARITY_TOL`` of the others;
* ``ring_async_bitwise``: the gathered factor matrices of ``ring_async`` at
  every depth equal the ring's (``torch.equal``), not only their RMSE.

On one card every shard shares the device, so a hand-over moves no bytes
between cards (``cards`` is 1): speedups near 1 are the expected reading,
and what the modes cost is their launches and copies. Overlap across cards
waits for a machine with several (ROADMAP Queue 1 item 9). Writes
``experiments/bench_torch/fig5_overlap.json``; a smoke run writes to a
temporary directory unless ``--out`` is given::

    PYTHONPATH=src:. python -m benchmarks_torch.fig5_overlap --device cpu --smoke
"""
from __future__ import annotations

import argparse

import torch

from benchmarks_torch.common import capture_seconds, device_record, eager_seconds, fit_timed, save_result, \
    smoke_out_path, warm_up
from repro_torch.bpmf import BPMFConfig
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings
from repro_torch.utils import resolve_device

PIPELINE_DEPTHS = (1, 2, 4)
NUM_SHARDS = 8  # the reference's 8-device ring, all on the one device here
PARITY_TOL = 1e-3  # the reference's reduction-order slack


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """Every comm mode on one seeded workload; writes the JSON and returns it."""
    device = resolve_device(device)
    spec = SyntheticSpec(
        num_users=600 if smoke else 4_000,
        num_movies=300 if smoke else 1_000,
        nnz=8_000 if smoke else 120_000,
        discretize=False,
    )
    coo, _ = synthetic_ratings(spec)
    K = 8 if smoke else 32
    sweeps = 2 if smoke else 6
    base = BPMFConfig().replace(K=K, num_sweeps=sweeps, burn_in=1, num_shards=NUM_SHARDS, sweeps_per_block=sweeps)

    variants = [("ring", "ring", 1), ("allgather", "allgather", 1)]
    variants += [(f"ring_async_d{d}", "ring_async", d) for d in PIPELINE_DEPTHS]
    out: dict = {
        **device_record(device),
        "smoke": bool(smoke),
        "num_shards": NUM_SHARDS,
        "workload": {"users": spec.num_users, "movies": spec.num_movies, "nnz": spec.nnz, "K": K,
                     "sweeps": sweeps},
        "modes": {},
    }
    factors: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
    warm_up(base.replace(name="ring"), coo, device)
    for label, mode, depth in variants:
        engine, t = fit_timed(base.replace(name=mode, pipeline_depth=depth), coo, device)
        t_eager = eager_seconds(engine, sweeps)
        factors[label] = tuple(torch.from_numpy(x) for x in engine.factors())
        out["cards"] = len(engine.backend.ring.distinct_devices()) if device.type == "cuda" else 0
        out["modes"][label] = {
            "comm_mode": mode, "pipeline_depth": depth,
            "seconds": t, "seconds_per_sweep": t / sweeps, "capture_seconds": capture_seconds(engine),
            "eager_seconds": t_eager, "eager_seconds_per_sweep": t_eager / sweeps,
            "rmse": engine.rmse,
        }
        print(f"[fig5] {label}: {t:.4f}s as the engine runs it, {t_eager:.4f}s eager, "
              f"rmse={engine.rmse:.4f}", flush=True)

    modes = out["modes"]
    out["speedup_vs_allgather"] = {k: modes["allgather"]["seconds"] / m["seconds"] for k, m in modes.items()}
    out["eager_speedup_vs_allgather"] = {k: modes["allgather"]["eager_seconds"] / m["eager_seconds"]
                                         for k, m in modes.items()}
    out["ring_vs_allgather_speedup"] = out["speedup_vs_allgather"]["ring"]
    rmses = [m["rmse"] for m in modes.values()]
    out["parity_tol"] = PARITY_TOL
    out["parity_ok"] = bool(max(rmses) - min(rmses) < PARITY_TOL)
    # pipelining must not change the samples at all (DESIGN.md §7)
    out["ring_async_bitwise"] = all(torch.equal(factors[f"ring_async_d{d}"][i], factors["ring"][i])
                                    for d in PIPELINE_DEPTHS for i in (0, 1))
    out["note"] = (f"{NUM_SHARDS} shards on {out['cards']} card(s): on one card a hand-over moves no bytes "
                   "between cards, so speedups near 1 are expected; overlap across cards is not measured here")
    print(f"[fig5] parity_ok={out['parity_ok']} ring_async_bitwise={out['ring_async_bitwise']}", flush=True)
    path = save_result("fig5_overlap", out, out=smoke_out_path("fig5_overlap", smoke, out_path))
    print(f"[fig5] wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device)
