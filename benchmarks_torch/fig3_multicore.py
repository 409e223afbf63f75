"""Paper Figure 3 on the card: one half-sweep, bucketed against max-padded.

The port's counterpart of ``benchmarks/fig3_multicore.py``. The paper's
load-balancing variants map to how the movies side's items are padded
into buckets, on a ChEMBL-shaped synthetic:

* ``bucketed_lpt`` (TBB-like): size-classed buckets, pads ``(8, 32, 128,
  512, 2048)``;
* ``bucketed_coarse`` (OpenMP-like): one static class, pads ``(2048,)``;
* ``maxpad_graphlab_like`` (GraphLab-like): every movie padded to the
  next power of two at or above the largest count, one bucket.

Items above the largest pad get power-of-two pads of their own
(``data.sparse.bucket_assignment``). Each variant is one
``posterior.update_side`` over the movies (its Gram terms through the
per-bucket kernel ``bpmf_gram``, decided by ``posterior.plan_data`` before
any timing), timed as a captured CUDA graph replayed
(``kernels.autotune.time_us``, as ``autotune.measure_step`` times a step;
on the CPU the host clock) and eagerly beside it (the host clock around
a call and a synchronize). ``gram_launches`` counts the kernel's launches
(and its second passes) of one eager half-sweep;
``speedup_bucketed_vs_maxpad`` is the max-padded half-sweep's time over
``bucketed_lpt``'s. Writes ``experiments/bench_torch/fig3_multicore.json``;
a smoke run writes to a temporary directory unless ``--out`` is given::

    PYTHONPATH=src:. python -m benchmarks_torch.fig3_multicore --device cpu --smoke
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from benchmarks_torch.common import device_record, save_result, smoke_out_path
from repro_torch.core import posterior, prng
from repro_torch.core.sweep_graph import launch_counts
from repro_torch.core.types import BPMFConfig, HyperParams
from repro_torch.data.sparse import build_bpmf_data, csr_from_coo
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings
from repro_torch.kernels import autotune
from repro_torch.utils import resolve_device

LPT_PADS = (8, 32, 128, 512, 2048)
COARSE_PADS = (2048,)


def spec(smoke: bool) -> SyntheticSpec:
    """The ChEMBL-shaped ratings (the reference's sizes)."""
    return SyntheticSpec(num_users=2_000 if smoke else 20_000, num_movies=400 if smoke else 1_200,
                         nnz=20_000 if smoke else 400_000, discretize=False)


def variant_pads(coo) -> dict[str, tuple[int, ...]]:
    """Each variant's pads; the max-padded one's from the largest movie count over all ratings."""
    indptr, _, _ = csr_from_coo(coo.cols, coo.rows, coo.vals, coo.num_movies)
    max_nnz = int((indptr[1:] - indptr[:-1]).max())
    maxpad = 1 << int(np.ceil(np.log2(max(max_nnz, 8))))
    return {"bucketed_lpt": LPT_PADS, "bucketed_coarse": COARSE_PADS, "maxpad_graphlab_like": (maxpad,)}


def movie_buckets(data) -> list[list[int]]:
    """``[B, P]`` of every movies-side bucket, in order."""
    return [[b.B, b.P] for b in data.movies.buckets]


def _eager_seconds(fn, device: torch.device, iters: int) -> float:
    """Median host seconds of ``fn`` and a synchronize, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run(smoke: bool = False, out_path: str | None = None, device: str | torch.device | None = None) -> dict:
    """The three variants' half-sweeps; writes the JSON and returns it."""
    device = resolve_device(device)
    s = spec(smoke)
    coo, _ = synthetic_ratings(s)
    K = 16 if smoke else 32
    cfg = BPMFConfig(K=K)
    iters = 3 if smoke else 8
    key = prng.key(0, device)
    hyper = HyperParams.init(K, device=device)
    gen = torch.Generator().manual_seed(0)
    U = torch.randn(coo.num_users, K, generator=gen).to(device)
    V = torch.randn(coo.num_movies, K, generator=gen).to(device)

    results: dict = {}
    for mode, pads in variant_pads(coo).items():
        data = posterior.plan_data(build_bpmf_data(coo, pads=pads, test_fraction=0.1, seed=0).to(device), cfg)

        def half(data=data):
            return posterior.update_side(key, V, U, data.movies, hyper, cfg.alpha, cfg.compute_dtype)

        before = launch_counts()
        half()
        launches = {name: n - before[name] for name, n in launch_counts().items()}
        t_eager = _eager_seconds(half, device, iters)
        t = autotune.time_us({mode: half}, device, iters)[mode] * 1e-6
        results[mode] = {
            "seconds_per_halfsweep": t,
            "updates_per_s": coo.num_movies / t,
            "eager_seconds_per_halfsweep": t_eager,
            "pads": list(pads),
            "buckets": movie_buckets(data),
            "gram_launches": launches,
            "decisions": sorted({f"{d.impl}/{d.piece}" for d in data.movies.gram}),
        }
        print(f"[fig3] {mode}: {t * 1e3:.3f} ms {'replayed' if device.type == 'cuda' else 'timed'}, "
              f"{t_eager * 1e3:.3f} ms eager per half-sweep, "
              f"{len(data.movies.buckets)} buckets, launches {launches}", flush=True)
        del data
    results["speedup_bucketed_vs_maxpad"] = (results["maxpad_graphlab_like"]["seconds_per_halfsweep"]
                                             / results["bucketed_lpt"]["seconds_per_halfsweep"])
    results["eager_speedup_bucketed_vs_maxpad"] = (results["maxpad_graphlab_like"]["eager_seconds_per_halfsweep"]
                                                   / results["bucketed_lpt"]["eager_seconds_per_halfsweep"])
    out = {
        **device_record(device),
        "smoke": bool(smoke),
        "spec": {"num_users": s.num_users, "num_movies": s.num_movies, "nnz": s.nnz, "discretize": s.discretize,
                 "seed": s.seed, "K": K},
        "timing": "replayed CUDA graph (autotune.time_us), median of iters" if device.type == "cuda"
        else "host clock, median of iters",
        "iters": iters,
        "results": results,
    }
    print(f"[fig3] bucketed-vs-maxpad speedup: {results['speedup_bucketed_vs_maxpad']:.2f}x "
          f"(eager {results['eager_speedup_bucketed_vs_maxpad']:.2f}x)", flush=True)
    path = save_result("fig3_multicore", out, out=smoke_out_path("fig3_multicore", smoke, out_path))
    print(f"[fig3] wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny workload; writes to a temp path unless --out")
    ap.add_argument("--out", default=None, help="output JSON path (default: the committed file)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run(smoke=args.smoke, out_path=args.out, device=args.device)
