"""Serving latency on the card: the batch sweep, and closed-loop load on a live server.

The port's counterpart of ``benchmarks/serve_latency.py``, with its two
modes and flags:

* default: train a small synthetic run (``sequential`` unless
  ``--backend``), export its artifact, load it with
  ``PosteriorPredictor.load`` on the device, and time ``predict`` per batch
  size (p50, p99, mean and predictions/s; each call returns host arrays,
  so the device has finished) and a ``top_k`` probe. Writes
  ``experiments/bench_torch/serve_latency.json``.
* ``--load``: a random-factor artifact at the given catalog
  (``build_random_artifact``: serving sees only arrays), ``top_k`` timed
  ``replicated`` against ``sharded`` (``SERVE_ITEM_SHARDS`` item shards from
  ``serve.predictor.serve_devices``, all on the one card), then
  closed-loop clients (each a thread issuing requests back to back through
  ``ServeClient``, a 4:1 mix of ``predict`` of 4 pairs and ``top_k(10)``)
  against a live ``BPMFServer`` at each client count, recording offered
  qps, p50/p99, the micro-batcher's occupancy and coalesced share, errors
  and dropped requests. Writes ``experiments/bench_torch/serve_load.json``.
  The reference's gate ``sharded_beats_recorded`` compares the sharded
  p99 with the committed ``serve_latency.json``'s top-k p99 (the port's
  file, never the reference's); it is recorded only when that file's
  catalog is this run's, since a top-k over another catalog is other work.

Smoke runs (``--smoke``) write to a temporary directory unless ``--out``
is given::

    PYTHONPATH=src:. python -m benchmarks_torch.serve_latency --device cpu --smoke
    PYTHONPATH=src:. python -m benchmarks_torch.serve_latency --device cpu --smoke --load
    PYTHONPATH=src:. python -m benchmarks_torch.serve_latency --load --users 138493 --movies 27278 --K 32
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from benchmarks_torch.common import OUT_DIR, device_record, save_result, smoke_out_path
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.serve import ArtifactMeta, BPMFServer, PosteriorPredictor, ServeClient, save_artifact
from repro_torch.serve.predictor import serve_devices
from repro_torch.utils import resolve_device

SERVE_ITEM_SHARDS = 4  # the item shards of the sharded top-k, all on the one card (chip_smoke.py's)
# the catalog the committed serve_load.json is measured at: MovieLens-20M's,
# the one chip_smoke.py serves (--users 138493 --movies 27278 --K 32)
ML20M_CATALOG = {"users": 138_493, "movies": 27_278, "K": 32}


def _percentiles(times_s: list[float], batch: int) -> dict:
    arr = np.asarray(times_s) * 1e3
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(arr.mean()),
        "qps": float(batch / max(arr.mean() / 1e3, 1e-12)),
    }


def _artifact_record(meta: ArtifactMeta) -> dict:
    return {"num_users": meta.num_users, "num_movies": meta.num_movies, "K": meta.K,
            "num_mean_samples": meta.num_mean_samples, "num_kept_samples": meta.num_kept_samples,
            "backend": meta.backend}


def build_artifact(args, device: torch.device) -> str:
    """Train a small synthetic run on ``device`` and export its serving artifact."""
    coo = load_dataset("synthetic", num_users=args.users, num_movies=args.movies, nnz=args.nnz, noise_std=0.3,
                       seed=0)
    cfg = BPMFConfig().replace(name=args.backend, K=args.K, num_sweeps=args.sweeps,
                               burn_in=max(1, args.sweeps // 3), bucket_pads=(8, 32, 128))
    engine = BPMFEngine(cfg, device=device).fit(coo)
    return engine.export(tempfile.mkdtemp(prefix="bpmf-serve-bench-") + "/artifact")


def build_random_artifact(users: int, movies: int, K: int, seed: int = 0) -> str:
    """A random-factor artifact at a catalog size (no training): serving sees only arrays."""
    rng = np.random.default_rng(seed)
    meta = ArtifactMeta(
        num_users=users, num_movies=movies, K=K, mean_rating=3.5, min_rating=1.0, max_rating=5.0,
        num_mean_samples=8, num_kept_samples=0, backend="synthetic", num_sweeps_done=0, seed=seed,
    )
    arrays = {
        "U_mean": rng.normal(scale=0.5, size=(users, K)).astype(np.float32),
        "V_mean": rng.normal(scale=0.5, size=(movies, K)).astype(np.float32),
        "U_samples": np.zeros((0, users, K), np.float32),
        "V_samples": np.zeros((0, movies, K), np.float32),
    }
    return save_artifact(tempfile.mkdtemp(prefix="bpmf-serve-load-") + "/artifact", meta, arrays)


def _time_topk(predictor: PosteriorPredictor, users_pool: list[int], k: int, repeats: int, sharded: bool) -> dict:
    for _ in range(3):
        predictor.top_k(users_pool[0], k, sharded=sharded)
    times = []
    for i in range(repeats):
        u = users_pool[i % len(users_pool)]
        t0 = time.perf_counter()
        predictor.top_k(u, k, sharded=sharded)  # host arrays: the device has finished
        times.append(time.perf_counter() - t0)
    return {"k": k, **_percentiles(times, 1)}


def _recorded_topk(num_movies: int) -> float | None:
    """p99 of the committed ``serve_latency.json``'s top-k probe, when its catalog has ``num_movies`` items."""
    try:
        with open(os.path.join(OUT_DIR, "serve_latency.json")) as f:
            payload = json.load(f)
        if payload["artifact"]["num_movies"] != num_movies:
            return None
        return float(payload["top_k"]["p99_ms"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


class _ClosedLoopClient(threading.Thread):
    """One closed-loop client: mixed requests back to back until told to stop, each one's wall latency kept."""

    def __init__(self, address: str, meta: ArtifactMeta, seed: int, stop_event: threading.Event):
        super().__init__(daemon=True)
        self.address = address
        self.meta = meta
        self.rng = np.random.default_rng(seed)
        self.stop_event = stop_event
        self.latencies: list[float] = []
        self.errors = 0
        self.issued = 0

    def run(self) -> None:
        client = ServeClient(self.address)
        n_users, n_movies = self.meta.num_users, self.meta.num_movies
        try:
            while not self.stop_event.is_set():
                # 4:1 predict (batch 4) : top-k, a recommender-shaped mix
                if self.rng.integers(0, 5) < 4:
                    req = {"rows": self.rng.integers(0, n_users, 4).tolist(),
                           "cols": self.rng.integers(0, n_movies, 4).tolist()}
                else:
                    req = {"user": int(self.rng.integers(0, n_users)), "k": 10}
                self.issued += 1
                t0 = time.perf_counter()
                try:
                    if "error" in client.request(req):
                        self.errors += 1
                except Exception:  # a failed request is a counted error; the client goes on
                    self.errors += 1
                self.latencies.append(time.perf_counter() - t0)
        finally:
            client.close()


def _load_level(address: str, meta: ArtifactMeta, clients: int, duration_s: float) -> dict:
    probe = ServeClient(address)
    before = probe.stats()["batcher"]
    stop = threading.Event()
    threads = [_ClosedLoopClient(address, meta, seed=i, stop_event=stop) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    wall = time.perf_counter() - t0
    after = probe.stats()["batcher"]
    probe.close()
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"{clients} clients: a client thread did not stop within 30 s")
    lats = [x for t in threads for x in t.latencies]
    issued = sum(t.issued for t in threads)
    d_req = after["requests"] - before["requests"]
    d_cyc = after["cycles"] - before["cycles"]
    return {
        "clients": clients,
        "requests": len(lats),
        "errors": sum(t.errors for t in threads),
        "dropped": issued - len(lats),  # issued but never completed; 0 in a healthy run
        "offered_qps": len(lats) / wall,
        "batcher_occupancy": d_req / d_cyc if d_cyc else 0.0,
        "coalesced_share": (after["coalesced_requests"] - before["coalesced_requests"]) / d_req if d_req else 0.0,
        **_percentiles(lats, 1),
    }


def run_load(args, device: torch.device) -> dict:
    """The ``--load`` mode: sharded against replicated top-k, then closed-loop clients; returns the payload."""
    artifact = args.artifact or build_random_artifact(args.users, args.movies, args.K)
    predictor = PosteriorPredictor.load(artifact, device=device,
                                        item_devices=serve_devices(SERVE_ITEM_SHARDS, device))
    meta = predictor.meta
    rng = np.random.default_rng(1)
    users_pool = [int(u) for u in rng.integers(0, meta.num_users, 64)]
    k = min(args.top_k, meta.num_movies)
    topk: dict = {
        "replicated": _time_topk(predictor, users_pool, k, args.repeats, sharded=False),
        "sharded": _time_topk(predictor, users_pool, k, args.repeats, sharded=True),
        "item_shards": SERVE_ITEM_SHARDS,
    }
    topk["sharded_vs_replicated_p99_ratio"] = topk["sharded"]["p99_ms"] / topk["replicated"]["p99_ms"]
    recorded = _recorded_topk(meta.num_movies)
    if recorded is not None:
        topk["recorded_full_catalog_p99_ms"] = recorded
        topk["sharded_beats_recorded"] = topk["sharded"]["p99_ms"] < recorded
    for name in ("replicated", "sharded"):
        e = topk[name]
        print(f"[serve_load] top_{k} {name:10s}: p50 {e['p50_ms']:.3f} ms  p99 {e['p99_ms']:.3f} ms", flush=True)
    del predictor

    server = BPMFServer(artifact, deadline_ms=args.deadline_ms, topk_mode="auto", watch=False, device=device)
    host, port = server.start()
    load = {}
    try:
        for clients in [int(c) for c in args.clients.split(",")]:
            entry = _load_level(f"{host}:{port}", meta, clients, args.duration)
            load[str(clients)] = entry
            print(f"[serve_load] clients {clients:3d}: {entry['offered_qps']:8.0f} req/s  "
                  f"p50 {entry['p50_ms']:.3f} ms  p99 {entry['p99_ms']:.3f} ms  "
                  f"occupancy {entry['batcher_occupancy']:.2f}  errors {entry['errors']}", flush=True)
    finally:
        server.shutdown()
    return {
        **device_record(device),
        "smoke": bool(args.smoke),
        "repeats": args.repeats,
        "deadline_ms": args.deadline_ms,
        "duration_s": args.duration,
        "artifact": _artifact_record(meta),
        "top_k": topk,
        "load": load,
    }


def run_latency(args, device: torch.device) -> dict:
    """The default mode: ``predict`` per batch size and a ``top_k`` probe; returns the payload."""
    artifact = args.artifact or build_artifact(args, device)
    predictor = PosteriorPredictor.load(artifact, device=device)
    meta = predictor.meta
    rng = np.random.default_rng(0)
    batches = {}
    for batch in [int(b) for b in args.batches.split(",")]:
        rows = rng.integers(0, meta.num_users, batch).astype(np.int32)
        cols = rng.integers(0, meta.num_movies, batch).astype(np.int32)
        for _ in range(3):  # warm-up
            predictor.predict(rows, cols)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            predictor.predict(rows, cols)  # host arrays: the device has finished
            times.append(time.perf_counter() - t0)
        batches[str(batch)] = _percentiles(times, batch)
        print(f"[serve_latency] batch {batch:5d}: p50 {batches[str(batch)]['p50_ms']:.3f} ms  "
              f"p99 {batches[str(batch)]['p99_ms']:.3f} ms  {batches[str(batch)]['qps']:,.0f} preds/s", flush=True)
    k = min(args.top_k, meta.num_movies)
    for _ in range(3):
        predictor.top_k(0, k)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        predictor.top_k(0, k)
        times.append(time.perf_counter() - t0)
    top_k = {"k": k, **_percentiles(times, 1)}
    print(f"[serve_latency] top_{k}: p50 {top_k['p50_ms']:.3f} ms  p99 {top_k['p99_ms']:.3f} ms", flush=True)
    return {
        **device_record(device),
        "smoke": bool(args.smoke),
        "repeats": args.repeats,
        "artifact": _artifact_record(meta),
        "batches": batches,
        "top_k": top_k,
    }


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny run; writes to a temp path unless --out")
    ap.add_argument("--load", action="store_true",
                    help="closed-loop clients against a live BPMFServer (writes serve_load.json)")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--artifact", default=None, help="existing artifact directory (skips training)")
    ap.add_argument("--backend", default="sequential")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--movies", type=int, default=800)
    ap.add_argument("--nnz", type=int, default=40_000)
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=8)
    ap.add_argument("--batches", default="1,8,64,512", help="comma-separated query batch sizes")
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--clients", default="1,4,16", help="closed-loop client counts (--load)")
    ap.add_argument("--duration", type=float, default=3.0, help="seconds per client-count level (--load)")
    ap.add_argument("--deadline-ms", type=float, default=2.0, help="server micro-batch deadline (--load)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Parse the flags, run the chosen mode, write its JSON and return the payload."""
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.users, args.movies, args.nnz = 200, 100, 3000
        args.K, args.sweeps = 6, 3
        args.batches, args.repeats = "1,8,64", 25
        args.clients, args.duration = "1,4", 1.0
    device = resolve_device(args.device)
    name = "serve_load" if args.load else "serve_latency"
    payload = run_load(args, device) if args.load else run_latency(args, device)
    path = save_result(name, payload, out=smoke_out_path(name, args.smoke, args.out))
    print(f"[{name}] wrote {path}", flush=True)
    return payload


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None,
        load: bool = False, argv: list[str] | None = None) -> dict:
    """In-process entry of the drivers' harness: :func:`main` with these flags (``argv``: more flags)."""
    flags = ["--smoke"] if smoke else []
    flags += ["--load"] if load else []
    flags += ["--out", out_path] if out_path else []
    flags += ["--device", str(device)] if device is not None else []
    return main(flags + list(argv or []))


if __name__ == "__main__":
    main()
