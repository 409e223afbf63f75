"""RMSE against communication on the card: the ring family against ``posterior_merge``.

The port's counterpart of ``benchmarks/fig_merge_comm.py``, on the same
seeded task (the statistical harness's reference task of
``tests/test_posterior_quality.py``), through the engine's ``sequential``,
``ring``, ``ring_async`` (depth 2) and ``posterior_merge`` at each
partition count, the ring ones with ``NUM_SHARDS`` shards on the one
device:

* ``rmse``: the engine's running posterior-mean RMSE (per chain and not
  merged for ``posterior_merge``);
* ``rmse_artifact``: the RMSE of the exported predictor over the engine's
  global held-out split (for ``posterior_merge`` the merged posterior);
* ``bytes_per_sweep``: the reference's model of the traffic between
  shards per sweep, ``S * (S-1) * (cap_u + cap_v) * K * 4`` for the ring
  family (each half-sweep rotates the opposite side's shard ``S - 1``
  times on every shard), 0 for ``sequential`` and ``posterior_merge``;
* ``collective_ops``: the reference counts collective ops in the compiled
  sweep's HLO, which has no counterpart here. The port's collectives are
  the calls of ``Ring.rotate`` and ``Ring.all_gather``
  (``core/distributed.py``), and this field counts those calls in one
  eager ``Backend.sweep`` from a fresh state, through a meter on the
  ``Ring`` class that is removed afterwards
  (:func:`benchmarks_torch.common.metered_ring`). ``posterior_merge`` holds
  no ``Ring``, so its chains count 0, as ``sequential`` does; the ring
  counts its ``2 (S - 1)`` rotations;
* ``baseline_rmse``: the per-movie training mean on the same split
  (``subset_merge.column_mean_rmse``), and ``merge_band``:
  ``subset_merge.MERGE_RMSE_BAND`` at the largest partition count.

The acceptance booleans are the reference's: ``beats_baseline`` and
``within_band`` for the merged artifact at the largest partition count,
and ``zero_comm_ok`` (no collective call and no modelled byte for
``sequential`` and every ``posterior_merge``, at least one of each for the
ring family). Writes ``experiments/bench_torch/fig_merge_comm.json``; a
smoke run writes to a temporary directory unless ``--out`` is given::

    PYTHONPATH=src:. python -m benchmarks_torch.fig_merge_comm --device cpu --smoke
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks_torch.common import capture_seconds, device_record, fit_timed, metered_sweep, save_result, \
    smoke_out_path, warm_up
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import subset_merge
from repro_torch.data.sparse import train_test_split
from repro_torch.utils import resolve_device

NUM_SHARDS = 8  # the reference's 8-device ring, all on the one device here
RING_FAMILY = ("ring", "ring_async", "allgather")


def workload(smoke: bool) -> dict:
    """The task's sizes and the partition counts (the reference's)."""
    if smoke:
        return dict(users=80, movies=40, nnz=800, K=4, sweeps=4, burn_in=1, keep=2, pads=(8, 32), partitions=(2,))
    return dict(users=150, movies=80, nnz=4000, K=8, sweeps=10, burn_in=3, keep=4, pads=(8, 32, 128),
                partitions=(2, 4))


def load_task(w: dict):
    """The seeded ratings of the task."""
    return load_dataset("synthetic", num_users=w["users"], num_movies=w["movies"], nnz=w["nnz"], noise_std=0.3,
                        seed=7)


def base_config(w: dict) -> BPMFConfig:
    """The engine config every backend of the task shares."""
    return BPMFConfig().replace(K=w["K"], num_sweeps=w["sweeps"], burn_in=w["burn_in"],
                                keep_factor_samples=w["keep"], bucket_pads=w["pads"], num_shards=NUM_SHARDS)


def bytes_per_sweep(engine: BPMFEngine) -> int:
    """The reference's model of the bytes between shards per sweep (module docstring)."""
    if engine.cfg.backend.name not in RING_FAMILY:
        return 0  # sequential: one device; posterior_merge: independent chains
    backend = engine.backend
    S = backend.num_shards
    return S * (S - 1) * (backend.plan.part_users.cap + backend.plan.part_movies.cap) * engine.cfg.model.K * 4


def collective_ops(engine: BPMFEngine) -> int:
    """``Ring.rotate`` and ``Ring.all_gather`` calls in one eager sweep of the prepared engine."""
    meter = metered_sweep(engine)
    return meter["rotate_calls"] + meter["all_gather_calls"]


def artifact_rmse(engine: BPMFEngine, coo) -> float:
    """The exported predictor's RMSE over the engine's own global held-out split."""
    _, test = train_test_split(coo, engine.cfg.run.test_fraction, engine.cfg.run.seed)
    preds = engine.predict(test.rows, test.cols)
    return float(np.sqrt(np.mean((preds - test.vals) ** 2)))


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """Every backend on the task; writes the JSON and returns it."""
    device = resolve_device(device)
    w = workload(smoke)
    coo = load_task(w)
    base = base_config(w)
    configs = [("sequential", base.replace(name="sequential")),
               ("ring", base.replace(name="ring")),
               ("ring_async", base.replace(name="ring_async", pipeline_depth=2))]
    configs += [(f"posterior_merge_p{P}", base.replace(name="posterior_merge", num_partitions=P))
                for P in w["partitions"]]

    baseline = subset_merge.column_mean_rmse(coo, base.run.test_fraction, base.run.seed)
    out: dict = {
        **device_record(device),
        "smoke": bool(smoke),
        "num_shards": NUM_SHARDS,
        "workload": {"users": w["users"], "movies": w["movies"], "nnz": w["nnz"], "K": w["K"],
                     "sweeps": w["sweeps"], "burn_in": w["burn_in"], "keep_factor_samples": w["keep"]},
        "baseline_rmse": baseline,
        "merge_band": list(subset_merge.MERGE_RMSE_BAND[max(w["partitions"])]),
        "backends": {},
    }
    warm_up(configs[0][1], coo, device)
    for name, cfg in configs:
        engine, seconds = fit_timed(cfg, coo, device)
        entry = {
            "rmse": engine.rmse,
            "rmse_artifact": artifact_rmse(engine, coo),
            "bytes_per_sweep": bytes_per_sweep(engine),
            "collective_ops": collective_ops(engine),
            "seconds": seconds,
            "capture_seconds": capture_seconds(engine),
        }
        out["backends"][name] = entry
        print(f"[fig_merge_comm] {name}: rmse={entry['rmse']:.4f} artifact={entry['rmse_artifact']:.4f} "
              f"{entry['bytes_per_sweep']} B/sweep {entry['collective_ops']} ring calls ({seconds:.3f}s)", flush=True)

    merged = out["backends"][f"posterior_merge_p{max(w['partitions'])}"]
    lo, hi = out["merge_band"]
    out["beats_baseline"] = bool(merged["rmse_artifact"] < baseline)
    out["within_band"] = bool(lo <= merged["rmse_artifact"] <= hi)
    backends = out["backends"]
    out["zero_comm_ok"] = bool(
        all(e["collective_ops"] == 0 and e["bytes_per_sweep"] == 0
            for n, e in backends.items() if n.startswith("posterior_merge") or n == "sequential")
        and all(e["collective_ops"] > 0 and e["bytes_per_sweep"] > 0 for n, e in backends.items() if n in RING_FAMILY)
    )
    print(f"[fig_merge_comm] baseline={baseline:.4f} beats_baseline={out['beats_baseline']} "
          f"within_band={out['within_band']} zero_comm_ok={out['zero_comm_ok']}", flush=True)
    path = save_result("fig_merge_comm", out, out=smoke_out_path("fig_merge_comm", smoke, out_path))
    print(f"[fig_merge_comm] wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device)
