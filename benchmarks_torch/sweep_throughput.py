"""Blocked sweep-loop throughput on the card: sweeps per second and host bytes per sweep.

The port's counterpart of ``benchmarks/sweep_throughput.py``, over
``backends x sweeps_per_block in {1, 4, 8}`` (the ring backends with
``NUM_SHARDS`` shards on the one device):

* ``sweeps_per_sec``: the engine's wall clock of a fit after ``prepare``,
  less the one-time capture of the sweep as a CUDA graph (its eager
  warm-up sweep and the capture, ``capture_seconds``), the counterpart of
  the JAX package's compile, which its benchmark excludes by a warm-up fit;
* ``host_bytes_per_sweep``: bytes the engine read from the device per
  sweep (``host_metric_bytes``: one ``[block, 4]`` float32 metrics block);
* ``legacy_emulated``: the loop before blocks, one sweep per block and a
  gather of the whole ``(U, V)`` to the host after every post-burn-in
  sweep;
* ``overlap_off`` / ``overlap_on``: the same run at ``pipeline_blocks`` 1
  and 2 with ``host_blocked_s_per_block``, the host's wait for each
  block's metrics; ``save_return_latency``: how soon ``engine.save()``
  returns with asynchronous and synchronous writes.

Every run's gathered factors must equal the first run's bit for bit
(``parity_ok``). Writes ``experiments/bench_torch/sweep_throughput.json``
(``scripts/check_bench_schema_torch.py sweep_throughput``)::

    PYTHONPATH=src:. python -m benchmarks_torch.sweep_throughput --device cpu --smoke
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmarks_torch.common import capture_seconds, device_record, fit_timed, save_result, smoke_out_path, \
    warm_up
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.utils import resolve_device

BLOCK_SIZES = (1, 4, 8)
BACKENDS = ("sequential", "ring", "ring_async", "allgather")
NUM_SHARDS = 4  # the ring's shards, all on the one device (chip_smoke.py's S)


def _legacy_emulated(cfg: BPMFConfig, coo, device) -> tuple[BPMFEngine, float, int]:
    """The loop before blocks: one sweep per block, and the whole (U, V) gathered after each post-burn-in sweep."""
    cfg = cfg.replace(sweeps_per_block=1)
    engine = BPMFEngine(cfg, device=device)
    engine.prepare(coo)
    gathered = 0
    t0 = time.perf_counter()
    for m in engine.sample():
        if int(m.sweep) > cfg.run.burn_in:
            U, V = engine.factors()
            gathered += U.nbytes + V.nbytes
    seconds = time.perf_counter() - t0 - capture_seconds(engine)
    return engine, seconds, gathered + engine.host_metric_bytes


def _save_latency(cfg: BPMFConfig, coo, device) -> dict:
    """``engine.save()`` return latency with asynchronous and synchronous writes (recorded, not asserted)."""
    out: dict = {}
    for label, async_w in (("async_s", True), ("sync_s", False)):
        d = tempfile.mkdtemp(prefix="bpmf-savelat-")
        try:
            engine = BPMFEngine(cfg.replace(num_sweeps=2, burn_in=1, checkpoint_dir=d,
                                            async_checkpoint_writes=async_w), device=device)
            engine.fit(coo)
            t0 = time.perf_counter()
            engine.save()
            out[label] = time.perf_counter() - t0
            engine._ckpt.wait()  # the write lands before the directory goes
        finally:
            shutil.rmtree(d, ignore_errors=True)
    out["async_returns_faster"] = out["async_s"] <= out["sync_s"]
    return out


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """Every backend at every block size, the legacy loop and the overlap columns; writes the JSON."""
    device = resolve_device(device)
    users = 400 if smoke else 2_000
    movies = 200 if smoke else 800
    nnz = 6_000 if smoke else 80_000
    K = 8 if smoke else 32
    sweeps = 8 if smoke else 24
    burn_in = 2 if smoke else 8
    coo = load_dataset("synthetic", num_users=users, num_movies=movies, nnz=nnz)
    base = BPMFConfig().replace(K=K, num_sweeps=sweeps, burn_in=burn_in, keep_factor_samples=4,
                                num_shards=NUM_SHARDS)
    warm_up(base, coo, device)

    out: dict = {
        **device_record(device),
        "smoke": bool(smoke),
        "workload": {"users": users, "movies": movies, "nnz": nnz, "K": K, "sweeps": sweeps,
                     "burn_in": burn_in, "num_shards": NUM_SHARDS},
        # what the loop before blocks gathered per post-burn-in sweep: the whole float32 (U, V)
        "factor_gather_bytes": (users + movies) * K * 4,
        "backends": {},
    }
    parity = True
    for name in BACKENDS:
        entries: dict = {}
        factors0 = None
        for spb in BLOCK_SIZES:
            engine, t = fit_timed(base.replace(name=name, sweeps_per_block=spb), coo, device)
            U, V = engine.factors()
            if factors0 is None:
                factors0 = (U, V)
            parity = parity and np.array_equal(U, factors0[0]) and np.array_equal(V, factors0[1])
            entries[f"block_{spb}"] = {
                "sweeps_per_block": spb, "seconds": t, "sweeps_per_sec": sweeps / t,
                "capture_seconds": capture_seconds(engine),
                "host_bytes_per_sweep": engine.host_metric_bytes / sweeps, "rmse": engine.rmse,
            }
            print(f"[sweep_throughput] {name} block={spb}: {t:.4f}s ({sweeps / t:.2f} sweeps/s, "
                  f"{engine.host_metric_bytes / sweeps:.0f} B/sweep)", flush=True)
        engine, t, legacy_bytes = _legacy_emulated(base.replace(name=name), coo, device)
        metric_row = 4 * 4  # one [1, 4] float32 metrics row per sweep
        entries["legacy_emulated"] = {
            "seconds": t, "sweeps_per_sec": sweeps / t,
            "host_bytes_per_sweep": legacy_bytes / sweeps,
            "host_bytes_per_post_burn_in_sweep": (legacy_bytes - sweeps * metric_row) / (sweeps - burn_in)
            + metric_row,
            "rmse": engine.rmse,
        }
        print(f"[sweep_throughput] {name} legacy: {t:.4f}s ({legacy_bytes / sweeps:.0f} B/sweep)", flush=True)
        spb_ov = 4  # several blocks in flight
        nblocks = -(-sweeps // spb_ov)
        for label, depth in (("overlap_off", 1), ("overlap_on", 2)):
            engine, t = fit_timed(base.replace(name=name, sweeps_per_block=spb_ov, pipeline_blocks=depth),
                                  coo, device)
            U, V = engine.factors()
            parity = parity and np.array_equal(U, factors0[0]) and np.array_equal(V, factors0[1])
            entries[label] = {
                "pipeline_blocks": depth, "seconds": t, "sweeps_per_sec": sweeps / t,
                "host_bytes_per_sweep": engine.host_metric_bytes / sweeps,
                "host_blocked_s_per_block": engine.host_blocked_s / nblocks, "rmse": engine.rmse,
            }
            print(f"[sweep_throughput] {name} {label}: {t:.4f}s "
                  f"({engine.host_blocked_s / nblocks * 1e6:.0f} us host-blocked/block)", flush=True)
        out["backends"][name] = entries

    out["parity_ok"] = bool(parity)
    out["overlap_speedup_ok"] = all(e["overlap_on"]["seconds"] <= e["overlap_off"]["seconds"]
                                    for e in out["backends"].values())
    out["save_return_latency"] = _save_latency(base.replace(name="sequential"), coo, device)
    gather = out["factor_gather_bytes"]
    out["block_transfer_drop_ok"] = all(
        e["legacy_emulated"]["host_bytes_per_post_burn_in_sweep"] - e[f"block_{spb}"]["host_bytes_per_sweep"]
        >= gather
        for e in out["backends"].values() for spb in BLOCK_SIZES if spb > 1
    )
    lat = out["save_return_latency"]
    print(f"[sweep_throughput] save() return latency: async {lat['async_s'] * 1e3:.2f} ms, "
          f"sync {lat['sync_s'] * 1e3:.2f} ms", flush=True)
    path = save_result("sweep_throughput", out, out=smoke_out_path("sweep_throughput", smoke, out_path))
    print(f"[sweep_throughput] wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device)
