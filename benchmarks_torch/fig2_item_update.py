"""Paper Figure 2 (the cost-model fit) and the Gram autotuning run, on the card.

The port's counterpart of ``benchmarks/fig2_item_update.py``:

* the Figure 2 curves: per-item update time against rating count for the
  naive update (``posterior.update_item_naive``), a one-item bucket and a
  64-item bucket (per item), and the ``(fixed, per_rating)`` cost model
  fitted to the batched curve (``core/balance.py:fit_cost_model``), which
  ``kernels.autotune.load_fig2_cost_model`` reads back;
* the autotune sweep: for every step shape of ``STEP_SHAPES`` (the JAX
  package's) every candidate of ``kernels.autotune.candidates`` (the fused
  kernel at each chunk width, the per-bucket kernel at each piece width)
  is timed through the real dispatch path by ``autotune.measure_step``,
  after its output was held against the plain version, and the winner is
  recorded into the cache (``experiments/autotune/gram_cuda.json``);
* a workload sweep (full runs only): the exact ring-step keys of the JAX
  package's small workload (``WORKLOAD``, 4 shards, K = 16), so that an
  engine run of it finds measured entries.

Writes ``experiments/bench_torch/fig2_item_update.json``. ``--smoke``
measures the first two shapes with two candidates, writes to a temporary
directory unless ``--out`` is given, and records into a cache beside its
output, never the committed one::

    PYTHONPATH=src:. python -m benchmarks_torch.fig2_item_update --device cpu --smoke
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from benchmarks_torch.common import OUT_DIR, device_record, save_result, smoke_out_path
from repro_torch.core import posterior, prng
from repro_torch.core.balance import fit_cost_model
from repro_torch.core.types import Bucket, HyperParams
from repro_torch.kernels import autotune
from repro_torch.utils import resolve_device, timeit

# (name, per-bucket (B, P) shapes, Ns, K): the JAX package's autotuned step shapes
STEP_SHAPES: list[tuple[str, list[tuple[int, int]], int, int]] = [
    ("multi_med", [(48, 64), (16, 32)], 128, 32),
    ("multi_wide", [(32, 128), (16, 64)], 192, 32),
    ("multi_small", [(32, 32), (16, 128)], 128, 16),
    ("one_tall", [(64, 32)], 256, 32),
    ("one_wide", [(8, 512)], 512, 32),
    ("many_tiny", [(128, 8)], 128, 16),
    ("two_big", [(16, 128), (16, 128)], 1024, 32),
    ("small_rank", [(64, 64)], 512, 8),
]
WORKLOAD = dict(num_users=400, num_movies=300, nnz=12_000, seed=0)
WORKLOAD_SHARDS = 4
WORKLOAD_K = 16


def _bucket_for(nnz: int, num_items: int, num_opposite: int, device: torch.device, seed: int = 0) -> Bucket:
    rng = np.random.default_rng(seed)
    pad = max(8, 1 << int(np.ceil(np.log2(max(nnz, 1)))))
    nbr = rng.integers(0, num_opposite, size=(num_items, pad), dtype=np.int32)
    val = rng.normal(size=(num_items, pad)).astype(np.float32)
    val[:, nnz:] = 0.0
    return Bucket(
        item_ids=torch.arange(num_items, dtype=torch.int32, device=device),
        nbr=torch.from_numpy(nbr).to(device),
        val=torch.from_numpy(val).to(device),
        nnz=torch.full((num_items,), nnz, dtype=torch.int32, device=device),
    )


def _fig2_rows(smoke: bool, device: torch.device) -> list[dict]:
    """The paper's Figure 2 curves: per-item update seconds against rating count."""
    K = 16 if smoke else 32
    num_opposite = 2_000
    nnz_grid = [8, 32, 128, 512] if smoke else [8, 16, 32, 64, 128, 256, 512, 1024, 2048]
    iters = 3 if smoke else 10
    key = prng.key(0, device)
    X = prng.normal(key, (num_opposite, K))
    hyper = HyperParams.init(K, device=device)
    B = 64
    # update_bucket writes into its output in place, with one spare row for padding
    out1 = torch.zeros(2, K, device=device)
    outB = torch.zeros(B + 1, K, device=device)

    def update(out: torch.Tensor, bucket: Bucket) -> torch.Tensor:
        posterior.update_bucket(key, out, X, bucket, hyper, 2.0)
        return out

    rng = np.random.default_rng(1)
    rows = []
    for nnz in nnz_grid:
        nbr = torch.from_numpy(rng.integers(0, num_opposite, size=nnz, dtype=np.int32)).to(device)
        val = torch.from_numpy(rng.normal(size=nnz).astype(np.float32)).to(device)
        t_naive = timeit(posterior.update_item_naive, key, 0, nbr, val, X, hyper, 2.0, iters=iters)
        t_single = timeit(update, out1, _bucket_for(nnz, 1, num_opposite, device), iters=iters)
        t_batch = timeit(update, outB, _bucket_for(nnz, B, num_opposite, device), iters=iters) / B
        rows.append({"nnz": nnz, "t_naive_s": t_naive, "t_single_chol_s": t_single,
                     "t_batched_per_item_s": t_batch})
    return rows


def _sweep_entry(dec: autotune.Decision, timings: dict, bucket_shapes, Ns: int, K: int) -> dict:
    """One JSON entry of a measure_step result: the fastest of each implementation, and every candidate."""
    labels = autotune.candidates("cuda") | autotune.candidates("cpu")
    per_impl: dict[str, float] = {}
    for label, t in timings.items():
        impl = labels[label].impl
        per_impl[impl] = min(per_impl.get(impl, float("inf")), t)
    entry = {"buckets": [list(s) for s in bucket_shapes], "Ns": Ns, "K": K, "timings_us": per_impl,
             "candidates_us": timings, "winner": dec.impl, "pc": dec.pc, "piece": dec.piece}
    if "pallas" in per_impl and "pallas_fused" in per_impl:
        entry["fused_vs_bucket_speedup"] = per_impl["pallas"] / max(per_impl["pallas_fused"], 1e-9)
    return entry


def _kernel_sweep(smoke: bool, device: torch.device, cache: autotune.AutotuneCache) -> dict[str, dict]:
    """The measured candidates of every step shape, recorded into ``cache``."""
    shapes = STEP_SHAPES[:2] if smoke else STEP_SHAPES
    labels = None  # every candidate
    if smoke:
        labels = ["pallas_fused_pc128", "pallas"] + (["xla"] if device.type == "cpu" else [])
    sweep = {}
    for name, bucket_shapes, Ns, K in shapes:
        dec, timings = autotune.measure_step(bucket_shapes, Ns, K, iters=48 if smoke else 16, labels=labels,
                                             cache=cache, device=device)
        sweep[name] = _sweep_entry(dec, timings, bucket_shapes, Ns, K)
        print(f"  {name}: winner={dec} timings_us={sweep[name]['timings_us']}", flush=True)
    return sweep


def _workload_sweep(smoke: bool, device: torch.device, cache: autotune.AutotuneCache) -> dict:
    """Measure every distinct step key an engine run of ``WORKLOAD`` looks up (full runs only).

    Shards share their bucket shapes at a step, so each (side, step) of the
    layout is one key.
    """
    if smoke:
        return {}
    from repro_torch.bpmf import load_dataset
    from repro_torch.core.distributed import build_distributed_data

    coo = load_dataset("synthetic", **WORKLOAD)
    data, _ = build_distributed_data(coo, num_shards=WORKLOAD_SHARDS)
    uniq: dict[str, tuple] = {}
    for key, shapes in autotune.workload_step_keys(data, WORKLOAD_K, backend=device.type):
        uniq.setdefault(key.encode(), (key, shapes))
    entries = {}
    for enc, (key, shapes) in uniq.items():
        dec, timings = autotune.measure_step(shapes, key.Ns, key.K, cap=key.cap, iters=8, cache=cache,
                                             device=device)
        entries[enc] = dict(_sweep_entry(dec, timings, shapes, key.Ns, key.K), cap=key.cap)
        print(f"  {enc}: winner={dec}", flush=True)
    return {"workload": {**WORKLOAD, "num_shards": WORKLOAD_SHARDS, "K": WORKLOAD_K},
            "distinct_keys": len(uniq), "measured_keys": len(entries), "entries": entries}


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """Figure 2 curves, the cost-model fit and the autotune sweep; writes the JSON and returns it."""
    device = resolve_device(device)
    path = smoke_out_path("fig2_item_update", smoke, out_path)
    if smoke:  # a smoke run never records into the committed cache
        cache = autotune.AutotuneCache(os.path.join(os.path.dirname(os.path.abspath(path)), autotune.CACHE_FILE))
    else:
        cache = autotune.get_cache()
    rows = _fig2_rows(smoke, device)
    nnzs = np.array([r["nnz"] for r in rows], dtype=np.float64)
    tb = np.array([r["t_batched_per_item_s"] for r in rows])
    cm = fit_cost_model(nnzs, tb * 1e6)  # microseconds: well-scaled coefficients

    print(f"kernel sweep ({'smoke: 2' if smoke else len(STEP_SHAPES)} step shapes) on {device}:", flush=True)
    out = {
        **device_record(device),
        "smoke": bool(smoke),
        "rows": rows,
        "cost_model": {"fixed_us": cm.fixed, "per_rating_us": cm.per_rating},
        "batched_speedup_at_min_nnz": rows[0]["t_single_chol_s"] / max(rows[0]["t_batched_per_item_s"], 1e-12),
        "kernel_sweep": _kernel_sweep(smoke, device, cache),
        "workload_sweep": _workload_sweep(smoke, device, cache),
        "autotune_cache": os.path.relpath(cache.path, os.path.join(OUT_DIR, "..", "..")),
    }
    written = save_result("fig2_item_update", out, out=path)
    print(f"[fig2_item_update] wrote {written}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="2 shapes, 2 candidates; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    r = run(smoke=args.smoke, out_path=args.out, device=args.device)
    print("cost model:", r["cost_model"])
    print("kernel winners:", {k: v["winner"] for k, v in r["kernel_sweep"].items()})
