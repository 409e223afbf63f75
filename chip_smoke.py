#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check every part of it.

    python3 chip_smoke.py          # from the repository root, on a machine with one GPU

Phases (any failure stops the run with a non-zero exit and no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold the Gram kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the shapes of tests/test_kernels.py and at three
   MovieLens-20M bucket shapes, and time the kernel, the plain version and
   ``torch.bmm`` on the pre-gathered block (contraction only, gather
   excluded): one JSON line per shape;
4. the sequential sampler at MovieLens-20M scale (138,493 x 27,278, 20 M
   ratings, K = 32, default pads) through ``BPMFEngine``: 4 sweeps, with the
   launch counters reset just before and read just after; then every bucket
   of that data held against the plain version and timed;
5. requests: ``predict`` with ``return_std`` and ``top_k`` on the posterior,
   checked against numpy;
6. one more sweep under torch.profiler: device time by kernel, kernel
   launches, and the device's busy share of a steady sweep;
7. the small seeded task of tests/test_posterior_quality.py on the card,
   inside its recorded RMSE band;
8. the ``kernels`` JSON line, the card line again, and last the ``ok`` line.

Tolerance of the kernel against the plain version: the plain version
contracts in float64 (the correctly rounded sum), the kernel sums float32
products one at a time in p order, so entry (i, j) may be off by a few
float32 epsilons times sqrt(P) times sum_p |x_i x_j|, which is at most
sqrt(G_ii G_jj). The check allows 16 eps sqrt(P) sqrt(G_ii G_jj), and
sqrt(G_ii sum_p val^2) for g.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TEST_SHAPES = [(16, 8, 1, 8), (64, 32, 13, 70), (128, 32, 8, 128), (100, 16, 5, 300),
               (256, 64, 4, 512), (32, 128, 3, 17), (300, 32, 2, 1024)]
# (Ns, B, P, smallest nnz) of MovieLens-20M buckets at K = 32: users P=128,
# movies P=512, and the heaviest movies P=131,072
ML20M_SHAPES = [(27_278, 59_711, 128, 33), (138_493, 20_391, 512, 129), (138_493, 5, 131_072, 65_537)]
RMSE_BAND = (0.70, 0.82)  # tests/test_posterior_quality.py's recorded band


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gram_work(nnz_total: int, B: int, Ns: int, K: int) -> tuple[float, float]:
    """(bytes, flops) the Gram function needs for these inputs.

    Bytes: each real rating's neighbor id and value once, nnz, X once, and
    G and g written once. Flops: the K (K + 3) / 2 multiply-adds per rating
    of the lower triangle of G (G is symmetric) and of g.
    """
    bytes_ = 8.0 * nnz_total + 4.0 * B + 4.0 * Ns * K + 4.0 * B * (K * K + K)
    flops = float(nnz_total) * K * (K + 3)
    return bytes_, flops


def bound_ms(bytes_: float, flops: float) -> float:
    return 1e3 * max(bytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def gram_error(torch, got, want, val, P: int) -> tuple[float, float]:
    """(max abs error, max error over its allowance); raises past the allowance."""
    G, g = got
    Gw, gw = want
    tol = 16 * torch.finfo(torch.float32).eps * math.sqrt(max(P, 1))
    d = torch.diagonal(Gw, dim1=1, dim2=2).clamp_min(0)
    v2 = (val.double() ** 2).sum(1, keepdim=True).float()
    scale_G = tol * (d[:, :, None] * d[:, None, :]).sqrt() + 1e-30
    scale_g = tol * (d * v2).sqrt() + 1e-30
    err = max(float((G - Gw).abs().max()), float((g - gw).abs().max())) if G.numel() else 0.0
    ratio = max(float(((G - Gw).abs() / scale_G).max()), float(((g - gw).abs() / scale_g).max())) \
        if G.numel() else 0.0
    if not (torch.isfinite(G).all() and torch.isfinite(g).all()) or ratio > 1.0:
        raise AssertionError(f"Gram kernel disagrees with the plain version: max abs {err}, "
                             f"{ratio:.3f} x the allowance 16 eps sqrt(P)")
    return err, ratio


def random_bucket(torch, gen, Ns: int, K: int, B: int, P: int, lo_nnz: int):
    dev = "cuda"
    X = (0.5 * torch.randn(Ns, K, generator=gen)).to(dev)
    nnz = torch.randint(lo_nnz, P + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    nbr = torch.randint(0, Ns, (B, P), generator=gen, dtype=torch.int32).to(dev)
    mask = torch.arange(P, device=dev)[None] < nnz[:, None]
    val = (torch.randn(B, P, generator=gen).to(dev) * mask).contiguous()
    return X, nbr, val, nnz


def phase_kernel_shapes(torch, gram_kernel) -> None:
    gen = torch.Generator().manual_seed(0)
    shapes = [(Ns, K, B, P, 0, "tests/test_kernels.py") for Ns, K, B, P in TEST_SHAPES]
    shapes += [(Ns, 32, B, P, lo, "ML20M bucket") for Ns, B, P, lo in ML20M_SHAPES]
    for Ns, K, B, P, lo, origin in shapes:
        X, nbr, val, nnz = random_bucket(torch, gen, Ns, K, B, P, lo)
        nnz_total = int(nnz.sum())
        big = B * P > 1_000_000
        for cd in (torch.float32, torch.bfloat16):
            got = gram_kernel.bpmf_gram(X, nbr, val, nnz, cd)
            again = gram_kernel.bpmf_gram(X, nbr, val, nnz, cd)
            want = gram_kernel.bpmf_gram_plain(X, nbr, val, nnz, cd)
            torch.cuda.synchronize()
            err, ratio = gram_error(torch, got, want, val, P)
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"two launches on the same inputs differ at {(Ns, K, B, P)}")
            del got, again, want
            line = {"phase": "kernel_vs_plain", "shape": origin, "Ns": Ns, "K": K, "B": B, "P": P,
                    "nnz": nnz_total, "compute_dtype": str(cd).replace("torch.", ""),
                    "max_abs_err": err, "err_over_allowance": ratio}
            if cd == torch.float32:
                reps = 5 if big else 20
                line["kernel_ms"] = time_ms(torch, lambda: gram_kernel.bpmf_gram(X, nbr, val, nnz), reps)
                line["plain_ms"] = time_ms(
                    torch, lambda: gram_kernel.bpmf_gram_plain(X, nbr, val, nnz), 3 if big else 10)
                mask = torch.arange(P, device="cuda")[None] < nnz[:, None]
                Y = torch.cat([X[nbr.long()] * mask[..., None], val[..., None]], dim=-1)
                Yt = Y.transpose(1, 2)
                line["bmm_contraction_only_ms"] = time_ms(torch, lambda: torch.bmm(Yt, Y), reps)
                del Y, Yt, mask
                line["bound_ms"] = bound_ms(*gram_work(nnz_total, B, Ns, K))
            print(json.dumps(line), flush=True)
        del X, nbr, val, nnz
        torch.cuda.empty_cache()


def phase_ml20m(torch, gram_kernel, repro_torch_mods) -> dict:
    BPMFConfig, BPMFEngine, ML20M_LIKE, synthetic_ratings = repro_torch_mods
    t0 = time.perf_counter()
    coo, _ = synthetic_ratings(ML20M_LIKE)
    generate_s = time.perf_counter() - t0
    cfg = BPMFConfig().replace(K=32, num_sweeps=4, burn_in=1, sweeps_per_block=2)
    engine = BPMFEngine(cfg)
    engine.prepare(coo)
    data = engine.backend.data
    n_buckets = len(data.users.buckets) + len(data.movies.buckets)
    print(json.dumps({
        "phase": "ml20m_setup", "users": coo.num_users, "movies": coo.num_movies, "ratings": coo.nnz,
        "K": 32, "host_seconds": {"generate": generate_s, **engine.backend.prepare_seconds},
        "buckets": {side: [[b.P, b.B] for b in getattr(data, side).buckets] for side in ("users", "movies")},
        "train_ratings": {side: getattr(data, side).total_ratings() for side in ("users", "movies")},
    }), flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gram_kernel.LAUNCHES = 0
    gram_kernel.PLAIN_CALLS = 0
    block_s = []
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()  # the block's metrics were read: the device is done
            block_s.append(now - t_prev)
            t_prev = now
    launches, plain_calls = gram_kernel.LAUNCHES, gram_kernel.PLAIN_CALLS
    peak = torch.cuda.max_memory_allocated()

    rmse = [[m.rmse_sample, m.rmse_avg] for m in engine.history]
    print(json.dumps({
        "phase": "ml20m_sweeps", "sweeps": engine.num_sweeps_done,
        "seconds_per_sweep_by_block": [s / cfg.run.sweeps_per_block for s in block_s],
        "rmse_sample_avg": rmse, "launches": launches, "plain_calls": plain_calls,
        "buckets_per_sweep": n_buckets, "max_memory_allocated_bytes": peak,
    }), flush=True)
    if not all(math.isfinite(v) for row in rmse for v in row):
        raise AssertionError(f"non-finite RMSE at ML20M scale: {rmse}")
    if not rmse[-1][0] < rmse[0][0]:
        raise AssertionError(f"RMSE did not fall from sweep 1 to sweep 4: {rmse}")
    if launches != n_buckets * engine.num_sweeps_done:
        raise AssertionError(f"{launches} kernel launches, want {n_buckets} buckets x "
                             f"{engine.num_sweeps_done} sweeps")
    if plain_calls != 0:
        raise AssertionError(f"the main path ran the plain Gram version {plain_calls} times")

    # every bucket of the run, at the run's own factors: kernel vs plain, timed
    state = engine.state
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    max_err = 0.0
    per_bucket = []
    for X, name, side in ((state.U, "movies", data.movies), (state.V, "users", data.users)):
        for b in side.buckets:
            got = gram_kernel.bpmf_gram(X, b.nbr, b.val, b.nnz)
            want = gram_kernel.bpmf_gram_plain(X, b.nbr, b.val, b.nnz)
            torch.cuda.synchronize()
            max_err = max(max_err, gram_error(torch, got, want, b.val, b.P)[0])
            del got, want
            ms = time_ms(torch, lambda: gram_kernel.bpmf_gram(X, b.nbr, b.val, b.nnz), 5)
            plain = time_ms(torch, lambda: gram_kernel.bpmf_gram_plain(X, b.nbr, b.val, b.nnz), 2)
            torch.cuda.empty_cache()
            nnz = int(b.nnz.sum())
            byt, fl = gram_work(nnz, b.B, X.shape[0], X.shape[1])
            per_bucket.append([name, b.P, b.B, nnz, int(b.nnz.max()), ms, plain, bound_ms(byt, fl)])
            totals["ms"] += ms
            totals["plain_ms"] += plain
            totals["bytes"] += byt
            totals["flops"] += fl
    per_sweep = {
        "phase": "ml20m_gram_per_sweep", "launches": n_buckets, "kernel_ms": totals["ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": bound_ms(totals["bytes"], totals["flops"]),
        "bound_by": "operations" if totals["flops"] / PEAK_F32_FLOPS > totals["bytes"] / PEAK_BYTES_PER_S
        else "bytes", "max_abs_err": max_err, "bytes": totals["bytes"], "flops": totals["flops"],
        "buckets_side_P_B_nnz_maxnnz_kernel_plain_bound_ms": per_bucket,
    }
    print(json.dumps(per_sweep), flush=True)
    return {"engine": engine, "launches": launches, "gram": per_sweep,
            "steady_sweep_s": block_s[-1] / cfg.run.sweeps_per_block}


def phase_requests(torch, np, engine) -> None:
    meta, arrays = engine._artifact_payload()
    U, V = arrays["U_mean"], arrays["V_mean"]
    Us, Vs = arrays["U_samples"], arrays["V_samples"]
    rng = np.random.default_rng(0)
    rows = rng.integers(0, meta.num_users, 32)
    cols = rng.integers(0, meta.num_movies, 32)
    pred = engine.predictor()
    pred.predict(rows, cols, return_std=True)  # first call places the factors
    t0 = time.perf_counter()
    p, s = pred.predict(rows, cols, return_std=True)
    predict_ms = 1e3 * (time.perf_counter() - t0)
    lo, hi = meta.min_rating, meta.max_rating
    want_p = np.clip((U[rows] * V[cols]).sum(-1) + meta.mean_rating, lo, hi)
    want_s = np.clip(np.einsum("sbk,sbk->sb", Us[:, rows], Vs[:, cols]) + meta.mean_rating, lo, hi).std(0)
    if not (np.allclose(p, want_p, rtol=0, atol=1e-4) and np.allclose(s, want_s, rtol=0, atol=1e-4)):
        raise AssertionError("predict disagrees with numpy on the posterior-mean factors")
    users = [0, 17, 4242, meta.num_users - 1]
    topk_ms = []
    for u in users:
        t0 = time.perf_counter()
        ids, vals = pred.top_k(u, 10)
        topk_ms.append(1e3 * (time.perf_counter() - t0))
        scores = np.clip(U[u] @ V.T + meta.mean_rating, lo, hi)
        if not np.allclose(vals, scores[ids], rtol=0, atol=1e-4):
            raise AssertionError(f"top_k scores for user {u} disagree with numpy")
        if not np.allclose(vals, -np.sort(-scores)[:10], rtol=0, atol=1e-4):
            raise AssertionError(f"top_k for user {u} is not the numpy top 10")
    print(json.dumps({"phase": "requests", "predict_pairs": 32, "predict_with_std_ms": predict_ms,
                      "top_k_users": users, "top_k_ms": topk_ms}), flush=True)


def phase_profile(torch, engine, steady_sweep_s: float) -> None:
    """One more ML20M sweep under torch.profiler (CUDA activity only).

    Prints device time by kernel and the number of kernel launches. The
    device's busy share is the summed kernel time over the steady sweep's
    wall time measured without the profiler (``steady_sweep_s``), since the
    profiler's own cost inflates the wall time of the traced sweep.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.backend.sweep_block(engine._k_run, engine.state, engine._pred, engine._accum, 1)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(json.dumps({
        "phase": "profile_one_sweep", "device_kernel_ms": busy_ms,
        "kernel_launches": sum(r[1] for r in rows), "steady_sweep_ms": 1e3 * steady_sweep_s,
        "busy_share": busy_ms / (1e3 * steady_sweep_s),
        "top_kernels_ms_count": [[round(ms, 4), n, name[:100]] for ms, n, name in rows[:15]],
    }), flush=True)


def phase_small_task(gram_kernel, BPMFConfig, BPMFEngine, load_dataset) -> None:
    coo = load_dataset("synthetic", num_users=150, num_movies=80, nnz=4000, noise_std=0.3, seed=7)
    cfg = BPMFConfig().replace(K=8, num_sweeps=10, burn_in=3, bucket_pads=(8, 32, 128),
                               keep_factor_samples=4)
    before = gram_kernel.LAUNCHES
    engine = BPMFEngine(cfg).fit(coo)
    lo, hi = RMSE_BAND
    print(json.dumps({"phase": "small_task", "rmse": engine.rmse, "band": RMSE_BAND,
                      "launches": gram_kernel.LAUNCHES - before}), flush=True)
    if not lo < engine.rmse < hi:
        raise AssertionError(f"small-task RMSE {engine.rmse} left the band {RMSE_BAND}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "bpmf_gram.cu").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
    from repro_torch.data.synthetic import ML20M_LIKE, synthetic_ratings
    from repro_torch.kernels import bpmf_gram as gram_kernel
    from repro_torch.kernels.build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t_all = time.perf_counter()

    built = load_library("bpmf_gram")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "build", "nvcc_seconds": built.seconds, "library": built.path.name,
                      "ptxas": ptxas}), flush=True)

    phase_kernel_shapes(torch, gram_kernel)
    ml = phase_ml20m(torch, gram_kernel, (BPMFConfig, BPMFEngine, ML20M_LIKE, synthetic_ratings))
    phase_requests(torch, np, ml["engine"])
    phase_profile(torch, ml["engine"], ml["steady_sweep_s"])
    del ml["engine"]
    torch.cuda.empty_cache()
    phase_small_task(gram_kernel, BPMFConfig, BPMFEngine, load_dataset)

    gram = ml["gram"]
    kernels = {"kernels": [{
        "name": "bpmf_gram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bpmf_gram.cu",
        "replaces": "src/repro/kernels/bpmf_gram.py:124",
        "launches": ml["launches"],
        "max_abs_err": gram["max_abs_err"],
        "ms": gram["kernel_ms"],
        "plain_ms": gram["plain_ms"],
        "bound_ms": gram["bound_ms"],
        "bound_by": gram["bound_by"],
        "library_ms": None,
        "note": f"ms, plain_ms and bound_ms cover the {gram['launches']} launches of one "
                "ML20M sweep; no single PyTorch call computes the masked gather + Gram",
    }]}
    print(f"total seconds: {time.perf_counter() - t_all:.1f}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
