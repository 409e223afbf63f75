#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check every part of it.

    python3 chip_smoke.py          # from the repository root, on a machine with one GPU

Phases (any failure stops the run with a non-zero exit and no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernels (one source, ``src/repro_torch/kernels/csrc/
   bpmf_gram.cu``, with the per-bucket and the fused ring-step kernel and
   their second passes) with nvcc, and print ptxas's registers and spills
   of each kernel instance;
3. hold the Gram kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the shapes of tests/test_kernels.py, at three
   MovieLens-20M bucket shapes and where its pieces turn (nnz = W - 1, W,
   W + 1, P, and one item with all 131,072 slots), and time the kernel, the
   plain version and ``torch.bmm`` on the pre-gathered block (contraction
   only, gather excluded): one JSON line per shape; then the same for the
   fused kernel at the edge shapes of tests/test_gram_fused.py and at a row
   whose chunks span three pieces;
4. the sequential sampler at MovieLens-20M scale (138,493 x 27,278, 20 M
   ratings, K = 32, default pads) through ``BPMFEngine``: 4 sweeps, with the
   launch counters reset just before and read just after (one launch per
   bucket, and one second pass per bucket that is split, for each of the 4
   sweeps and the one eager warm-up sweep that precedes the capture: every
   sampler below runs its blocks as its captured sweep replayed, a CUDA
   graph, and the counters count each replay's launches); then every bucket
   of that data held against the plain version and timed beside
   ``torch.bmm`` on its pre-gathered block, with its milliseconds per
   million real ratings; then the fused kernel on the movies side's buckets
   flattened into one step, which is step 0 of the movies side of a 1-shard
   ring (it holds the P = 131,072 class);
   The run saves a checkpoint at sweep 2 (asynchronously; the block's
   time excludes the save and its write);
   ``graph_sweeps``: the same 4 sweeps eagerly (``_eager=True``) from the
   same start, in blocks of 2; every metrics row and every tensor of the
   carry (U, V, hyper-parameters, counters, accumulators) must equal the
   replayed run's bit for bit, and an eager sweep's Gram launches the
   graph's per replay; capture seconds, captured and eager s/sweep,
   replays and kernel launches per sweep, each one's device kernel time
   and busy share (one replayed and one eager sweep under torch.profiler)
   and peak memory; then ``no_host_read``: one eager block of 2 sweeps
   under ``torch.cuda.set_sync_debug_mode("error")``, which must complete;
5. ``ml20m_checkpoint``: ``restore(step=2)`` on the same engine and sweeps
   3-4 again, with the counters reset just before and read just after;
   every ``SweepMetrics`` and both factor matrices must equal the first
   pass bit for bit; the checkpoint's bytes on disk and the ms of the async
   ``save``, of ``wait()`` and of ``restore``; then ``pipeline``: the same
   engine resumed from sweep 2 twice more, in blocks of one sweep at
   ``pipeline_blocks`` 1 and 2, each bit for bit the first pass, with the
   host's blocked seconds of each;
6. requests: ``predict`` with ``return_std`` and ``top_k`` on the posterior,
   checked against numpy; then ``serve``: the ML20M artifact exported and
   loaded with ``PosteriorPredictor.load(..., device="cuda")`` answers bit
   for bit as ``engine.predictor()``; ``BPMFServer`` on 127.0.0.1 takes 200
   requests through ``ServeClient`` (half ``predict`` of 32 pairs with
   std, half ``top_k(user, 10)``) from 1 and then 8 threads, every answer
   bit for bit the in-process one, with req/s and p50/p99 latency per
   kind; a second export is hot-swapped in by ``poll_artifact_now()``;
7. one more sweep under torch.profiler: device time by kernel, kernel
   launches, and the device's busy share of a steady sweep;
8. the ring at MovieLens-20M scale on the same ratings: ``ring`` with 4
   shards, all on this one card, through ``BPMFEngine``, 4 sweeps in blocks
   of 2 with the counters reset just before and read just after; each
   sweep's RMSE held to the sequential phase's, saving at sweep 2 as the
   sequential run does; ``graph_sweeps`` and ``no_host_read`` as for the
   sequential sampler (``no_host_read`` for the ``ring``, ``ring_async``
   and ``allgather`` comm modes); ``ring_checkpoint``, as
   ``ml20m_checkpoint`` (the save holds the shards concatenated,
   ``[S * cap, K]``); then
   ``ring_async`` (depth 2) and ``allgather`` for 2 sweeps from the same
   start, held to the ring's state; one traced ring sweep; and every
   (side, step, shard) layout of a sweep held against the fused kernel's
   plain version and timed beside ``torch.bmm`` on its pre-gathered chunks;
9. ``posterior_merge`` at MovieLens-20M scale on the same ratings: 4
   chains (``lpt`` partition, ``precision`` merge), all on this one card,
   through ``BPMFEngine``, 4 sweeps in blocks of 2 with the counters reset
   just before and read just after (one ``bpmf_gram`` launch per bucket of
   every chain, and one second pass per split bucket); the host build
   seconds, seconds per sweep, peak memory and each chain's users, ratings
   and largest pads; the combined RMSE finite and falling from sweep 1 to
   4; ``graph_sweeps`` and ``no_host_read`` as above (all 4 chains and the
   metrics' combination are one graph); ``merge_checkpoint``, as
   ``ml20m_checkpoint`` (every chain's U and V too); ``merge_export``: the merged artifact loaded on the card answers
   32 ``predict`` pairs with std and ``top_k(user, 10)`` bit for bit as
   ``engine.predictor()``, and its held-out RMSE stays within
   ``MERGE_DEGRADATION_MAX[4]`` of the sequential artifact's at the same
   sweep count (the column-mean baseline printed beside them);
   ``merge_buckets``: each chain's heaviest-movie bucket and largest-P
   users bucket against the plain version, timed beside ``torch.bmm``;
10. the small seeded task of tests/test_posterior_quality.py on the card,
   inside its recorded RMSE band; then ``posterior_merge`` there at P = 2
   and 4, each merged artifact inside ``MERGE_RMSE_BAND[P]``, below 0.95 x
   the column-mean baseline and within ``MERGE_DEGRADATION_MAX[P]`` of the
   sequential artifact;
11. the ``yardsticks`` line: each kernel against ``torch.bmm`` where this
   change is held to it (the heaviest-movie bucket, every bucket with at
   least 1 M real ratings, every movies-side ring layout) and the balance
   of the movies buckets' device time per real rating; these are measured
   and printed, not gates;
12. the autotuner (``repro_torch.kernels.autotune``): the whole run uses
   a fresh, empty cache (``REPRO_TORCH_AUTOTUNE_DIR``), so every engine
   above ran the dispatch without measurements; ``autotune_cold`` holds
   the heuristic to that dispatch for every sequential bucket key and every
   (side, step, shard) key of the ring, and the engines' plans to it;
   ``autotune_measure``: ``measure_step`` on every distinct ring step key
   into a fresh cache (the candidates' µs and the winner per key; every
   candidate first held to the plain version); ``autotune_ring``: a fresh
   ring engine on that cache, 4 sweeps with the counters reset just before
   and read just after and held to its plans, RMSE within 1e-3 of the
   sequential, ``graph_sweeps`` (captured against eager, bit for bit);
   ``autotune_gram_per_sweep``: every (side, step, shard) replayed with the
   cold plan and the warmed one in turns, ms per sweep by side;
   ``autotune_multiproc``: the 2-process gang on the warmed cache plans
   the same and equals this run bit for bit; ``autotune_ring_per_bucket``:
   a ring whose cache puts every step on the per-bucket kernel (at the
   piece width measured fastest), held to its plans' launches, to the
   sequential RMSE and to its own eager sweeps bit for bit;
13. ``bench_drivers``: every one of ``benchmarks_torch``'s drivers once at
   its smoke size (fig2, sweep_throughput, rmse_convergence, fig3,
   fig4 with its process sweep at 1 and 2 processes sharing the card,
   fig5, fig_merge_comm, serve_latency and its ``--load`` mode), into a
   temporary directory, each JSON through
   ``scripts/check_bench_schema_torch.py`` (the gate a committed file
   passes, less the committed-file rules), with the Gram launch counters
   reset just before each driver and read just after, and its headline
   (fig3's speedup, fig4's metered against modelled ring bytes, fig5's
   ``ring_async_bitwise``, fig_merge_comm's acceptance triple, serve_load's
   p99 and errors per client count); then ``examples``: the three
   ``examples_torch`` scripts at their own sizes on the card, each ending
   with its own checks passed, with their launch counts;
14. the LM scaffold (``repro_torch.models``, ``training``), with the Gram
   counters reset just before and read just after (it must launch no Gram
   kernel): ``lm_reduced_parity``, each reduced attention-family config
   (gemma-2b, yi-6b, chameleon-34b, nemotron-4-340b, hubert-xlarge) in
   f32 on the card against the port's CPU run from the same params:
   forward logits through the dense and the flash path, one train step's
   loss and grad norm, each within 1e-4 (TF32 stays off);
   ``lm_gemma2b_train``, gemma-2b at full width (its 2,506,172,416
   params, f32 params, bf16 activations, ``remat="full"``) on one
   4,096-token sequence (train_4k with its global batch cut to 1), 8 steps
   at lr 1e-4 on that batch: every loss finite and the last below the
   first; step ms, tokens/s, model FLOPs per token and their share of the
   dense bf16 peak, peak memory, and one more step traced;
   ``lm_gemma2b_decode``, teacher-forced decode of 16 tokens after a
   4,096-token prefill against ``forward`` (within 5e-2 of the largest
   logit), then prefill ms, greedy decode ms per token over 32 tokens and
   the cache's bytes. ``python3 chip_smoke.py --lm-only`` runs these
   phases alone and prints no result line;
15. the ``kernels`` JSON line, the card line again, and last the ``ok`` line.

Tolerance of a kernel against its plain version: the plain version
contracts in float64 (the correctly rounded sum), the kernel sums float32
products one at a time in p order, so entry (i, j) may be off by a few
float32 epsilons times sqrt(P) times sum_p |x_i x_j|, which is at most
sqrt(G_ii G_jj). The check allows 16 eps sqrt(P) sqrt(G_ii G_jj), and
sqrt(G_ii sum_p val^2) for g. The fused kernel is compared from zero sums,
where its output is alpha times such a Gram, with P the most ratings one
row has in the step. Both kernels sum a long row in pieces and add the
pieces in a second pass, which only shortens the float32 chains.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
RING_SHARDS = 4
MERGE_PARTITIONS = 4
ALPHA = 2.0  # the engine's default rating precision
# tests/test_gram_fused.py's edge shapes: (Ns, K, cap, [(B, P, dead rows, all empty)])
COUNTERS = ("LAUNCHES", "REDUCE_LAUNCHES", "PLAIN_CALLS", "FUSED_LAUNCHES", "FUSED_REDUCE_LAUNCHES",
            "FUSED_PLAIN_CALLS")
CHECKPOINT_AT = 2  # the sweep both ML20M runs save at, and resume from
SERVE_REQUESTS = 200
FUSED_SHAPES = {
    "multibucket": (96, 16, 64, [(16, 8, (), False), (9, 32, (), False), (4, 128, (), False)]),
    "B_not_multiple_of_tb": (64, 8, 24, [(13, 64, (), False)]),
    "all_padding": (32, 8, 16, [(8, 16, (), True), (8, 16, (), False)]),
    "item_minus_one": (48, 16, 20, [(10, 32, (0, 3, 9), False)]),
    "multichunk": (64, 16, 16, [(8, 300, (), False)]),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of each kernel instance, from nvcc's ``-Xptxas -v`` output."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d(bpmf_gram\w*?kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (k.group(1) + (f"<MT={k.group(2)}>" if k.group(2) else "")) if k else m.group(1)
            out.append({"kernel": name})
        elif out:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                out[-1]["spill_store_bytes"], out[-1]["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[-1]["registers"] = int(m.group(1))
    return out


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


def device_ms(torch, fn, launches: int = 20) -> float:
    """Milliseconds per call of ``fn`` over a run of back-to-back calls, by CUDA events.

    The device time of a kernel: the host enqueues the next call while the
    device runs this one, so the host's own latency per call (which
    :func:`time_ms` includes, the device being idle when each call starts)
    is hidden wherever the device is the slower of the two.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


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


def random_bucket(torch, gen, Ns: int, K: int, B: int, P: int, lo_nnz: int, nnz=None):
    """A bucket with nnz drawn from [lo_nnz, P], or the given ``nnz`` list."""
    dev = "cuda"
    X = (0.5 * torch.randn(Ns, K, generator=gen)).to(dev)
    if nnz is None:
        nnz = torch.randint(lo_nnz, P + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    else:
        nnz = torch.tensor(nnz, dtype=torch.int32, device=dev)
    nbr = torch.randint(0, Ns, (B, P), generator=gen, dtype=torch.int32).to(dev)
    mask = torch.arange(P, device=dev)[None] < nnz[:, None]
    val = (torch.randn(B, P, generator=gen).to(dev) * mask).contiguous()
    return X, nbr, val, nnz


def bmm_ms(torch, X, nbr, val, nnz, reps: int) -> float:
    """``torch.bmm`` of the pre-gathered masked block ``Y = [x | val]`` with itself: contraction only."""
    P = nbr.shape[1]
    mask = torch.arange(P, device="cuda")[None] < nnz[:, None]
    Y = torch.cat([X[nbr.long()] * mask[..., None], (val * mask)[..., None]], dim=-1)
    Yt = Y.transpose(1, 2)
    ms = time_ms(torch, lambda: torch.bmm(Yt, Y), reps)
    del Y, Yt, mask
    return ms


def phase_kernel_shapes(torch, gram_kernel) -> None:
    gen = torch.Generator().manual_seed(0)
    shapes = [(Ns, K, B, P, 0, None, "tests/test_kernels.py") for Ns, K, B, P in TEST_SHAPES]
    shapes += [(Ns, 32, B, P, lo, None, "ML20M bucket") for Ns, B, P, lo in ML20M_SHAPES]
    # where the pieces turn: W - 1, W, W + 1 and P ratings, and one item with every slot real
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    W = gram_kernel.piece_width(6, 4 * gram_kernel.MIN_PIECE_RATINGS, sms)
    shapes += [(27_278, 32, 6, 4 * gram_kernel.MIN_PIECE_RATINGS, 0,
                [0, W - 1, W, W + 1, 4 * gram_kernel.MIN_PIECE_RATINGS, 3], "split boundaries"),
               (138_493, 32, 1, 131_072, 0, [131_072], "one item, every slot")]
    for Ns, K, B, P, lo, nnz_list, origin in shapes:
        X, nbr, val, nnz = random_bucket(torch, gen, Ns, K, B, P, lo, nnz_list)
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
                    "W": gram_kernel.piece_width(B, P, sms), "nnz": nnz_total,
                    "compute_dtype": str(cd).replace("torch.", ""),
                    "max_abs_err": err, "err_over_allowance": ratio}
            if cd == torch.float32:
                reps = 5 if big else 20
                line["kernel_ms"] = time_ms(torch, lambda: gram_kernel.bpmf_gram(X, nbr, val, nnz), reps)
                line["plain_ms"] = time_ms(
                    torch, lambda: gram_kernel.bpmf_gram_plain(X, nbr, val, nnz), 3 if big else 10)
                line["bmm_contraction_only_ms"] = bmm_ms(torch, X, nbr, val, nnz, reps)
                line["bound_ms"] = bound_ms(*gram_work(nnz_total, B, Ns, K))
            print(json.dumps(line), flush=True)
        del X, nbr, val, nnz
        torch.cuda.empty_cache()


def fused_work(step, Ns: int, K: int) -> tuple[float, float]:
    """(bytes, flops) one fused launch needs: each real rating's id and value,
    X once, each chunk's item and count, and the running (G, g) row of every
    live item read and written once; K (K + 3) flops per rating."""
    ratings = float(step.cnt.sum())
    bytes_ = 8.0 * ratings + 4.0 * Ns * K + 8.0 * step.cnt.shape[0] + 2 * 4.0 * (K * K + K) * step.num_rows
    return bytes_, ratings * K * (K + 3)


def fused_error(torch, got, want, step, alpha: float) -> tuple[float, float]:
    """(max abs error, max error over its allowance) of a launch from zero sums; raises past it."""
    G, g = got
    Gw, gw = want
    live = step.item >= 0
    rows = step.item[live].long()
    per_row = torch.zeros(Gw.shape[0], dtype=torch.float64, device=Gw.device)
    per_row.index_add_(0, rows, step.cnt[live].double())
    v2 = torch.zeros_like(per_row).index_add_(0, rows, (step.val[live].double() ** 2).sum(1))
    tol = 16 * torch.finfo(torch.float32).eps * math.sqrt(max(float(per_row.max()), 1.0))
    d = torch.diagonal(Gw, dim1=1, dim2=2).clamp_min(0).double()
    scale_G = tol * (d[:, :, None] * d[:, None, :]).sqrt() + 1e-30
    scale_g = tol * (d * alpha * v2[:, None]).sqrt() + 1e-30
    err = max(float((G - Gw).abs().max()), float((g - gw).abs().max()))
    ratio = max(float(((G - Gw).abs() / scale_G).max()), float(((g - gw).abs() / scale_g).max()))
    if not (torch.isfinite(G).all() and torch.isfinite(g).all()) or ratio > 1.0:
        raise AssertionError(f"fused kernel disagrees with the plain version: max abs {err}, "
                             f"{ratio:.3f} x the allowance 16 eps sqrt(P)")
    return err, ratio


def check_fused(torch, gram_kernel, X, step, cap: int, label: dict, full: bool) -> dict:
    """The fused kernel against its plain version on one layout, from zero sums, and timed.

    Timed beside ``torch.bmm`` on the pre-gathered chunks (contraction
    only). ``full`` adds bfloat16 and two-launch bit equality; each dtype
    prints one JSON line.
    """
    K = X.shape[1]
    byt, fl = fused_work(step, X.shape[0], K)
    out = {}
    for cd in (torch.float32, torch.bfloat16) if full else (torch.float32,):
        def launch(G, g, fn=gram_kernel.bpmf_gram_fused):
            return fn(G, g, X, step.nbr, step.val, step.item, step.cnt, ALPHA, cd, step.order)

        def zeros():
            return (torch.zeros(cap, K, K, device="cuda"), torch.zeros(cap, K, device="cuda"))

        got = launch(*zeros())
        want = launch(*zeros(), fn=gram_kernel.bpmf_gram_fused_plain)
        torch.cuda.synchronize()
        err, ratio = fused_error(torch, got, want, step, ALPHA)
        plan = step.order.pieces
        line = {"phase": "fused_vs_plain", **label, "Ns": X.shape[0], "K": K, "cap": cap,
                "chunks": step.cnt.shape[0], "live_rows": step.num_rows, "pieces": plan.num_pieces,
                "split_rows": plan.num_split_rows,
                "ratings": int(step.cnt.sum()), "compute_dtype": str(cd).replace("torch.", ""),
                "max_abs_err": err, "err_over_allowance": ratio}
        if full:
            again = launch(*zeros())
            torch.cuda.synchronize()
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"two fused launches on the same inputs differ at {label}")
            del again
        del got, want
        if cd == torch.float32:
            G, g = zeros()
            line["kernel_ms"] = time_ms(torch, lambda: launch(G, g), 5)
            line["kernel_device_ms"] = device_ms(torch, lambda: launch(G, g))
            line["plain_ms"] = time_ms(torch, lambda: launch(G, g, fn=gram_kernel.bpmf_gram_fused_plain), 2)
            del G, g
            line["bmm_contraction_only_ms"] = bmm_ms(torch, X, step.nbr, step.val, step.cnt, 5)
            line["bound_ms"] = bound_ms(byt, fl)
            line["bound_by"] = "operations" if fl / PEAK_F32_FLOPS > byt / PEAK_BYTES_PER_S else "bytes"
            out = {"ms": line["kernel_ms"], "device_ms": line["kernel_device_ms"], "plain_ms": line["plain_ms"],
                   "bytes": byt, "flops": fl, "err": err, "bmm_ms": line["bmm_contraction_only_ms"]}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return out


def phase_fused_shapes(torch, np, gram_kernel, ops, Bucket) -> None:
    for name, (Ns, K, cap, shapes) in FUSED_SHAPES.items():
        rng = np.random.default_rng(len(name))
        X = torch.from_numpy(rng.normal(size=(Ns, K)).astype(np.float32)).cuda()
        buckets = []
        for B, P, dead, empty in shapes:
            nnz = np.zeros(B, np.int32) if empty else rng.integers(0, P + 1, B).astype(np.int32)
            nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
            val = rng.normal(size=(B, P)).astype(np.float32)
            val[np.arange(P)[None] >= nnz[:, None]] = 0.0
            ids = rng.permutation(cap)[:B].astype(np.int32)
            ids[list(dead)] = -1
            buckets.append(Bucket(*(torch.from_numpy(a).cuda() for a in (ids, nbr, val, nnz))))
        check_fused(torch, gram_kernel, X, ops.fused_step(tuple(buckets)), cap,
                    {"shape": f"tests/test_gram_fused.py {name}"}, full=True)
    # row 5 owns 48 chunks in three buckets, other rows' chunks between them:
    # three pieces of 16 chunks, added by the second pass
    rng = np.random.default_rng(13)
    X = torch.from_numpy(rng.normal(size=(27_278, 32)).astype(np.float32)).cuda()
    buckets = []
    for ids, nnz in (([5, 0], [2048, 100]), ([1, 5], [7, 2048]), ([2, 5, 3], [50, 2048, 1])):
        nbr = rng.integers(0, X.shape[0], (len(ids), 2048)).astype(np.int32)
        val = rng.normal(size=(len(ids), 2048)).astype(np.float32)
        val[np.arange(2048)[None] >= np.asarray(nnz)[:, None]] = 0.0
        arrays = (np.asarray(ids, np.int32), nbr, val, np.asarray(nnz, np.int32))
        buckets.append(Bucket(*(torch.from_numpy(a).cuda() for a in arrays)))
    step = ops.fused_step(tuple(buckets))
    if step.order.pieces.row_len.tolist() != [3]:
        raise AssertionError(f"the three-piece layout has split rows {step.order.pieces.row_len.tolist()}")
    check_fused(torch, gram_kernel, X, step, 8, {"shape": "row over three pieces"}, full=True)


def timed_save(engine) -> dict:
    """``engine.save()`` (asynchronous), then the wait for its write: the ms of each."""
    t0 = time.perf_counter()
    step = engine.save()
    t1 = time.perf_counter()
    engine._manager().wait()
    t2 = time.perf_counter()
    return {"step": step, "save_return_ms": 1e3 * (t1 - t0), "wait_ms": 1e3 * (t2 - t1)}


def history_rows(history):
    """``[n, 3]`` float32 rows ``(rmse_sample, rmse_avg, sweep)`` of a run's metrics, as its checkpoint keeps them."""
    import numpy as np

    return np.asarray([[m.rmse_sample, m.rmse_avg, m.sweep] for m in history], np.float32).reshape(-1, 3)


def ml20m_config(BPMFConfig, checkpoint_dir: str):
    """The engine config of every ML20M run: K = 32, 4 sweeps in blocks of 2, burn-in 1."""
    return BPMFConfig().replace(K=32, num_sweeps=4, burn_in=1, sweeps_per_block=2, checkpoint_dir=checkpoint_dir)


def phase_ml20m(torch, gram_kernel, repro_torch_mods, ckpt_root: Path) -> dict:
    from repro_torch.core import sweep_graph

    BPMFConfig, BPMFEngine, ML20M_LIKE, synthetic_ratings = repro_torch_mods
    t0 = time.perf_counter()
    coo, _ = synthetic_ratings(ML20M_LIKE)
    generate_s = time.perf_counter() - t0
    cfg = ml20m_config(BPMFConfig, str(ckpt_root / "ml20m"))
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

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_buckets = sum(1 for side in (data.users, data.movies) for b in side.buckets
                        if b.P > gram_kernel.piece_width(b.B, b.P, sms))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gram_kernel.LAUNCHES = 0
    gram_kernel.REDUCE_LAUNCHES = 0
    gram_kernel.PLAIN_CALLS = 0
    block_s, save = [], {}
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()  # the block's metrics were read: the device is done
            block_s.append(now - t_prev)
            if m.sweep == CHECKPOINT_AT:
                save = timed_save(engine)  # not charged to the next block
                now = time.perf_counter()
            t_prev = now
    launches, plain_calls = gram_kernel.LAUNCHES, gram_kernel.PLAIN_CALLS
    reduce_launches = gram_kernel.REDUCE_LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    rmse = [[m.rmse_sample, m.rmse_avg] for m in engine.history]
    # the first block captures the sweep, after one eager warm-up sweep
    swept = engine.num_sweeps_done + sweep_graph.WARMUP_SWEEPS
    print(json.dumps({
        "phase": "ml20m_sweeps", "sweeps": engine.num_sweeps_done,
        "warmup_sweeps": sweep_graph.WARMUP_SWEEPS, "graph_replays": engine.backend.graph.replays,
        "seconds_per_sweep_by_block": [s / cfg.run.sweeps_per_block for s in block_s],
        "rmse_sample_avg": rmse, "launches": launches, "reduce_launches": reduce_launches,
        "plain_calls": plain_calls, "buckets_per_sweep": n_buckets,
        "split_buckets_per_sweep": split_buckets, "max_memory_allocated_bytes": peak,
    }), flush=True)
    if not all(math.isfinite(v) for row in rmse for v in row):
        raise AssertionError(f"non-finite RMSE at ML20M scale: {rmse}")
    if not rmse[-1][0] < rmse[0][0]:
        raise AssertionError(f"RMSE did not fall from sweep 1 to sweep 4: {rmse}")
    if launches != n_buckets * swept:
        raise AssertionError(f"{launches} kernel launches, want {n_buckets} buckets x {swept} sweeps "
                             "(the run's and the capture's warm-up)")
    if reduce_launches != split_buckets * swept:
        raise AssertionError(f"{reduce_launches} second passes, want {split_buckets} split buckets x "
                             f"{swept} sweeps")
    if plain_calls != 0:
        raise AssertionError(f"the main path ran the plain Gram version {plain_calls} times")

    # every bucket of the run, at the run's own factors: kernel vs plain, timed
    state = engine.state
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bmm_ms": 0.0, "bytes": 0.0, "flops": 0.0}
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
            dev_ms = device_ms(torch, lambda: gram_kernel.bpmf_gram(X, b.nbr, b.val, b.nnz))
            plain = time_ms(torch, lambda: gram_kernel.bpmf_gram_plain(X, b.nbr, b.val, b.nnz), 2)
            bmm = bmm_ms(torch, X, b.nbr, b.val, b.nnz, 5)
            torch.cuda.empty_cache()
            nnz_host = b.nnz.cpu().numpy()
            nnz = int(nnz_host.sum())
            W = gram_kernel.piece_width(b.B, b.P, sms)
            item, _, _, direct = gram_kernel.bucket_pieces(nnz_host, b.P, W)
            byt, fl = gram_work(nnz, b.B, X.shape[0], X.shape[1])
            line = {"phase": "ml20m_bucket", "side": name, "P": b.P, "B": b.B, "nnz": nnz,
                    "max_nnz": int(nnz_host.max()), "W": W, "working_blocks": int(item.shape[0]),
                    "split_items": len(set(item[~direct].tolist())),
                    "kernel_ms": ms, "kernel_device_ms": dev_ms, "plain_ms": plain,
                    "bmm_contraction_only_ms": bmm, "bound_ms": bound_ms(byt, fl),
                    "ms_per_million_ratings": 1e6 * ms / max(nnz, 1),
                    "device_ms_per_million_ratings": 1e6 * dev_ms / max(nnz, 1)}
            print(json.dumps(line), flush=True)
            per_bucket.append(line)
            totals["ms"] += ms
            totals["device_ms"] += dev_ms
            totals["plain_ms"] += plain
            totals["bmm_ms"] += bmm
            totals["bytes"] += byt
            totals["flops"] += fl
    per_sweep = {
        "phase": "ml20m_gram_per_sweep", "launches": n_buckets, "reduce_launches": split_buckets,
        "kernel_ms": totals["ms"], "kernel_device_ms": totals["device_ms"], "plain_ms": totals["plain_ms"],
        "bmm_contraction_only_ms": totals["bmm_ms"], "bound_ms": bound_ms(totals["bytes"], totals["flops"]),
        "bound_by": "operations" if totals["flops"] / PEAK_F32_FLOPS > totals["bytes"] / PEAK_BYTES_PER_S
        else "bytes", "max_abs_err": max_err, "bytes": totals["bytes"], "flops": totals["flops"],
        "buckets": per_bucket,
    }
    print(json.dumps({k: v for k, v in per_sweep.items() if k != "buckets"}), flush=True)
    return {"engine": engine, "launches": launches, "reduce_launches": reduce_launches, "gram": per_sweep,
            "coo": coo, "cfg": cfg, "save": save, "peak": peak,
            "expected_per_sweep": {"LAUNCHES": n_buckets, "REDUCE_LAUNCHES": split_buckets},
            "steady_sweep_s": block_s[-1] / cfg.run.sweeps_per_block,
            "rmse_sample": [m.rmse_sample for m in engine.history]}


def phase_fused_one_shard(torch, gram_kernel, ops, engine) -> None:
    """Step 0 of the movies side of a 1-shard ring: every movie with all its users.

    That step's buckets are the sequential movies buckets (same pad classes,
    ascending ids; the ring only pads B to a multiple of 8 with dead rows),
    so they are flattened here at the run's own factors.
    """
    data, state = engine.backend.data, engine.state
    step = ops.fused_step(data.movies.buckets)
    check_fused(torch, gram_kernel, state.U, step, data.num_movies,
                {"shape": "ML20M ring S=1 movies step 0", "side": "movies", "step": 0, "shard": 0}, full=True)


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


def kernel_rows(torch, prof) -> list:
    """(device ms, launches, name) of each CUDA kernel in a profile, the longest first."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_sweep(torch, backend, key, carry, eager: bool) -> dict:
    """One sweep of ``carry`` under torch.profiler (CUDA activity only): kernel ms by name, launches.

    The sweep is the replayed graph, or with ``eager`` the op-by-op loop.
    Also the sweep's span on the card by CUDA events (for a replay: the
    graph's kernels and the gaps between them).
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        backend.sweep_block(key, *carry, 1, _eager=eager)
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    span_ms = time_ms(torch, lambda: backend.sweep_block(key, *carry, 1, _eager=eager), 3, warmup=0)
    return {"device_kernel_ms": sum(r[0] for r in rows), "kernel_launches": sum(r[1] for r in rows),
            "event_span_ms": span_ms,
            "top_kernels_ms_count": [[round(ms, 4), n, name[:100]] for ms, n, name in rows[:15]]}


def phase_profile(torch, engine, steady_sweep_s: float, label: str = "profile_one_sweep") -> None:
    """One more ML20M sweep under torch.profiler: on the card, a replay of the captured sweep.

    Prints device time by kernel and the number of kernel launches. The
    device's busy share is the summed kernel time over the steady sweep's
    wall time measured without the profiler (``steady_sweep_s``), since the
    profiler's own cost inflates the wall time of the traced sweep.
    """
    prof = profile_sweep(torch, engine.backend, engine._k_run, (engine.state, engine._pred, engine._accum),
                         eager=False)
    print(json.dumps({
        "phase": label, "device_kernel_ms": prof["device_kernel_ms"],
        "kernel_launches": prof["kernel_launches"], "steady_sweep_ms": 1e3 * steady_sweep_s,
        "busy_share": prof["device_kernel_ms"] / (1e3 * steady_sweep_s),
        "replay_event_span_ms": prof["event_span_ms"], "top_kernels_ms_count": prof["top_kernels_ms_count"],
    }), flush=True)


def phase_graph_sweeps(torch, engine, run: dict, label: str, card: str, dist=None) -> None:
    """The run's captured sweeps against the eager loop from the same start, then ``no_host_read``.

    Runs right after the engine's 4 sweeps, whose carry (the graph's static
    buffers) holds sweep 4. Four eager sweeps (blocks of 2) from the
    initial carry must give every metrics row and every tensor of the
    carry (U and V, hyper-parameters, counters, prediction and posterior
    accumulators) bit for bit, and the Gram launches of an eager sweep must
    equal the graph's per replay. Prints capture seconds, captured and eager
    s/sweep (the second block of each), replays and kernel launches per
    sweep, each sweep's device kernel time and busy share (profiled: one
    replayed and one eager sweep), and peak memory. The engine's carry is
    put back afterwards. Then one eager block of each backend (and, for a
    ring, of each comm mode) under ``set_sync_debug_mode("error")``.
    """
    from repro_torch.core import sweep_graph

    b = engine.backend
    graph = b.graph
    key = engine._k_run
    captured = (engine._state, engine._pred, engine._accum)
    saved = sweep_graph.map_tensors(captured, torch.clone)
    captured_rows = [list(m) for m in engine.history]
    carry = (b.init_state(engine._k_init), b.init_pred(), b.init_accum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, block_s, counts = [], [], []
    for n in (2, 2):
        before = sweep_graph.launch_counts()
        t0 = time.perf_counter()
        *carry, r = b.sweep_block(key, *carry, n, _eager=True)
        rows += r.cpu().numpy().tolist()
        block_s.append(time.perf_counter() - t0)
        counts.append({k: (v - before[k]) // n for k, v in sweep_graph.launch_counts().items()})
    eager_peak = torch.cuda.max_memory_allocated()
    carry = tuple(carry)
    same_rows = [r[:3] for r in rows] == captured_rows and not any(r[3] for r in rows)
    pairs = list(zip(sweep_graph.tensors(carry), sweep_graph.tensors(saved)))
    same_tensors = len(pairs) == len(sweep_graph.tensors(saved)) and all(torch.equal(x, y) for x, y in pairs)
    U_e, V_e = b.factors(carry[0])
    U_g, V_g = b.factors(saved[0])
    same_uv = bool((U_e == U_g).all() and (V_e == V_g).all())
    replayed = profile_sweep(torch, b, key, sweep_graph.map_tensors(saved, torch.clone), eager=False)
    eager = profile_sweep(torch, b, key, sweep_graph.map_tensors(carry, torch.clone), eager=True)
    for dst, src in zip(sweep_graph.tensors(captured), sweep_graph.tensors(saved)):
        dst.copy_(src)  # the engine's carry as it was: the profiles replayed over it
    captured_s, eager_s = run["steady_sweep_s"], block_s[-1] / 2
    line = {
        "phase": "graph_sweeps", "backend": label, "card": card, "sweeps": len(rows),
        "bit_identical": {"metrics": same_rows, "every_carry_tensor": same_tensors, "U_V": same_uv},
        "capture_seconds": graph.capture_seconds, "warmup_seconds": graph.warmup_seconds,
        "captured_s_per_sweep": captured_s, "eager_s_per_sweep": eager_s,
        "graph_replays_per_sweep": 1, "graph_replays": graph.replays,
        "gram_launches_per_replay": graph.launches_per_replay, "gram_launches_per_eager_sweep": counts[-1],
        "kernel_launches_per_sweep": {"captured": replayed["kernel_launches"], "eager": eager["kernel_launches"]},
        "device_kernel_ms_per_sweep": {"captured": replayed["device_kernel_ms"],
                                       "eager": eager["device_kernel_ms"]},
        "busy_share": {"captured": replayed["device_kernel_ms"] / (1e3 * captured_s),
                       "eager": eager["device_kernel_ms"] / (1e3 * eager_s)},
        "replay_event_span_ms": replayed["event_span_ms"],
        "max_memory_allocated_bytes": {"captured_run": run["peak"], "eager_sweeps": eager_peak},
        "top_kernels_captured": replayed["top_kernels_ms_count"][:8],
    }
    print(json.dumps(line), flush=True)
    if not all(line["bit_identical"].values()):
        raise AssertionError(f"{label}: the captured sweeps differ from the eager ones: {line['bit_identical']}")
    if any(c != graph.launches_per_replay for c in counts):
        raise AssertionError(f"{label}: Gram launches per eager sweep {counts}, per replay "
                             f"{graph.launches_per_replay}")

    # no host read inside an eager block: a sync would raise
    modes = [None] if dist is None else ["ring", "ring_async", "allgather"]
    for mode in modes:
        start = (b.init_state(engine._k_init), b.init_pred(), b.init_accum())
        if mode is None:
            def block(c=start):
                return b.sweep_block(key, *c, 2, _eager=True)
        else:
            mcfg = dataclasses.replace(b.core_cfg, comm_mode=mode, pipeline_depth=2)

            def block(c=start, mcfg=mcfg):
                return dist.dist_gibbs_sweep_block(key, *c, b.data, mcfg, b.ring, 2, b.prior)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = block()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        finite = bool(torch.isfinite(out[3]).all())
        print(json.dumps({"phase": "no_host_read", "backend": label, "comm_mode": mode, "sweeps": 2,
                          "completed": True, "seconds": secs, "finite_metrics": finite}), flush=True)
        if not finite:
            raise AssertionError(f"{label} {mode}: the eager block under the sync check gave {out[3]}")
        del out, start


def phase_pipeline(torch, engine, card: str) -> None:
    """The sequential sampler at ``pipeline_blocks`` 1 and 2: the same history, bit for bit.

    The ML20M engine again, resumed from its sweep-2 checkpoint with blocks
    of one sweep and its queue depth set to 1, then 2; each pass must give
    the first run's history and factors. Prints ``host_blocked_s`` and the
    metrics bytes read for each.
    """
    first, (U0, V0), cfg0 = list(engine.history), engine.factors(), engine.cfg
    line = {"phase": "pipeline", "card": card, "resumed_from": CHECKPOINT_AT}
    try:
        for depth in (1, 2):
            engine.cfg = cfg0.replace(pipeline_blocks=depth, sweeps_per_block=1)
            engine.restore(step=CHECKPOINT_AT)
            blocked, nbytes = engine.host_blocked_s, engine.host_metric_bytes
            t0 = time.perf_counter()
            list(engine.sample())
            U, V = engine.factors()
            line[f"depth_{depth}"] = {
                "host_blocked_s": engine.host_blocked_s - blocked,
                "host_metric_bytes": engine.host_metric_bytes - nbytes,
                "wall_s": time.perf_counter() - t0,
                "history_bit_identical": engine.history == first,
                "U_V_bit_identical": bool((U == U0).all() and (V == V0).all()),
            }
    finally:
        engine.cfg = cfg0
    print(json.dumps(line), flush=True)
    if not all(line[f"depth_{d}"][k] for d in (1, 2) for k in ("history_bit_identical", "U_V_bit_identical")):
        raise AssertionError(f"pipeline_blocks 1 and 2 differ from the first run: {line}")


def phase_ring(torch, gram_kernel, BPMFEngine, dist, ml: dict, ckpt_root: Path) -> dict:
    """The 4-shard ring at ML20M on this card, its async and allgather variants, and its kernel."""
    from repro_torch.core import sweep_graph

    cfg = ml["cfg"].replace(name="ring", num_shards=RING_SHARDS, checkpoint_dir=str(ckpt_root / "ring"))
    engine = BPMFEngine(cfg)
    engine.prepare(ml["coo"])
    b = engine.backend
    expected_per_sweep = b.data.fused_launches_per_sweep()
    split_layouts = sum(1 for side in (b.data.users, b.data.movies) for per_step in side.fused
                        for f in per_step if f is not None and f.order.pieces.num_split_rows)
    print(json.dumps({
        "phase": "ring_setup", "num_shards": b.num_shards, "shards_per_device": b.ring.shards_per_device(),
        "host_seconds": b.prepare_seconds, "cap": {"users": b.data.users.cap, "movies": b.data.movies.cap},
        "fused_launches_per_sweep": expected_per_sweep, "fused_second_passes_per_sweep": split_layouts,
        "buckets_per_step": {side: [len(per_step[0]) for per_step in getattr(b.data, side).steps]
                             for side in ("users", "movies")},
    }), flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    block_s, after_block1, save = [], None, {}
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()
            block_s.append(now - t_prev)
            if after_block1 is None:  # the graph's buffers, which block 2 overwrites: copy
                after_block1 = sweep_graph.map_tensors(engine.state, torch.clone)
            if m.sweep == CHECKPOINT_AT:
                save = timed_save(engine)  # not charged to the next block
                now = time.perf_counter()
            t_prev = now
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    peak = torch.cuda.max_memory_allocated()
    # what the 2-process ring of multiproc_ring must reproduce, bit for bit
    reference = {"hist": history_rows(engine.history), "factors": engine.factors()}
    rmse = [m.rmse_sample for m in engine.history]
    gap = [abs(a - b_) for a, b_ in zip(rmse, ml["rmse_sample"])]
    swept = engine.num_sweeps_done + sweep_graph.WARMUP_SWEEPS  # the capture's warm-up too
    print(json.dumps({
        "phase": "ring_sweeps", "sweeps": engine.num_sweeps_done,
        "warmup_sweeps": sweep_graph.WARMUP_SWEEPS, "graph_replays": b.graph.replays,
        "seconds_per_sweep_by_block": [s_ / cfg.run.sweeps_per_block for s_ in block_s],
        "rmse_sample": rmse, "rmse_avg": [m.rmse_avg for m in engine.history],
        "sequential_rmse_sample": ml["rmse_sample"], "rmse_gap_to_sequential": gap,
        "counts": counts, "expected_fused_launches": expected_per_sweep * swept,
        "max_memory_allocated_bytes": peak,
    }), flush=True)
    if counts["FUSED_LAUNCHES"] != expected_per_sweep * swept:
        raise AssertionError(f"{counts['FUSED_LAUNCHES']} fused launches, want {expected_per_sweep} "
                             f"per sweep x {swept} sweeps")
    if counts["FUSED_REDUCE_LAUNCHES"] != split_layouts * swept:
        raise AssertionError(f"{counts['FUSED_REDUCE_LAUNCHES']} fused second passes, want {split_layouts} "
                             f"per sweep x {swept} sweeps")
    if counts["PLAIN_CALLS"] or counts["FUSED_PLAIN_CALLS"] or counts["LAUNCHES"] or counts["REDUCE_LAUNCHES"]:
        raise AssertionError(f"the ring ran something other than the fused kernel: {counts}")
    if not all(math.isfinite(v) for v in rmse) or max(gap) > 1e-3:
        raise AssertionError(f"ring RMSE {rmse} is not within 1e-3 of the sequential {ml['rmse_sample']}")

    # ring_async and allgather from the same start, 2 sweeps each
    for mode, depth in (("ring_async", 2), ("allgather", 1)):
        mcfg = dataclasses.replace(b.core_cfg, comm_mode=mode, pipeline_depth=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, _, rows = dist.dist_gibbs_sweep_block(
            engine._k_run, b.init_state(engine._k_init), b.init_pred(), b.init_accum(),
            b.data, mcfg, b.ring, 2)
        rows = rows.cpu().numpy()
        secs = (time.perf_counter() - t0) / 2
        reference[mode] = {"rows": rows, "factors": b.factors(st)}
        diff = max(float((x - y).abs().max()) for xs, ys in ((st.U, after_block1.U), (st.V, after_block1.V))
                   for x, y in zip(xs, ys))
        print(json.dumps({"phase": "ring_variant", "comm_mode": mode, "pipeline_depth": depth,
                          "seconds_per_sweep": secs, "rmse_sample": rows[:, 0].tolist(),
                          "max_abs_diff_to_ring": diff}), flush=True)
        if (mode == "ring_async" and diff != 0.0) or diff > 1e-5:
            raise AssertionError(f"{mode} differs from ring by {diff} after 2 sweeps")
        del st
    return {"engine": engine, "launches": counts["FUSED_LAUNCHES"],
            "reduce_launches": counts["FUSED_REDUCE_LAUNCHES"], "save": save, "peak": peak,
            "reference": reference, "plans": plan_table(b.data),
            "expected_per_sweep": {"FUSED_LAUNCHES": expected_per_sweep, "FUSED_REDUCE_LAUNCHES": split_layouts},
            "steady_sweep_s": block_s[-1] / cfg.run.sweeps_per_block}


def phase_ring_layouts(torch, gram_kernel, engine) -> dict:
    """Every (side, step, shard) layout of one ring sweep, at the run's final factors."""
    b, state = engine.backend, engine.state
    S = b.num_shards
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bmm_ms": 0.0, "bytes": 0.0, "flops": 0.0,
              "err": 0.0, "launches": 0, "second_passes": 0}
    per_layout = []
    for side_name, X_opp in (("movies", state.U), ("users", state.V)):
        side = getattr(b.data, side_name)
        for t in range(S):
            for d in range(S):
                step = side.fused[t][d]
                if step is None or step.num_rows == 0:
                    continue
                full = d == 0 and t < 2
                r = check_fused(torch, gram_kernel, X_opp[(d - t) % S], step, side.cap,
                                {"shape": f"ML20M ring S={S}", "side": side_name, "step": t, "shard": d},
                                full=full)
                for k in ("ms", "device_ms", "plain_ms", "bmm_ms", "bytes", "flops"):
                    totals[k] += r[k]
                totals["err"] = max(totals["err"], r["err"])
                totals["launches"] += 1
                totals["second_passes"] += bool(step.order.pieces.num_split_rows)
                per_layout.append({"side": side_name, "step": t, "shard": d, "ms": r["ms"],
                                   "device_ms": r["device_ms"], "bmm_ms": r["bmm_ms"]})
    bound = bound_ms(totals["bytes"], totals["flops"])
    per_sweep = {"phase": "ring_fused_per_sweep", "launches": totals["launches"],
                 "second_passes": totals["second_passes"], "kernel_ms": totals["ms"],
                 "kernel_device_ms": totals["device_ms"],
                 "plain_ms": totals["plain_ms"], "bmm_contraction_only_ms": totals["bmm_ms"], "bound_ms": bound,
                 "bound_by": "operations" if totals["flops"] / PEAK_F32_FLOPS > totals["bytes"] / PEAK_BYTES_PER_S
                 else "bytes", "max_abs_err": totals["err"], "bytes": totals["bytes"], "flops": totals["flops"]}
    print(json.dumps(per_sweep), flush=True)
    per_sweep["layouts"] = per_layout
    return per_sweep


def chain_factors(engine) -> list:
    """Each ``posterior_merge`` chain's (U, V) on the host; empty for a backend with one state."""
    if not isinstance(engine.state, tuple):
        return []
    return [(st.U.cpu().numpy(), st.V.cpu().numpy()) for st in engine.state]


def phase_checkpoint(torch, np, gram_kernel, engine, run: dict, label: str, card: str) -> None:
    """Restore the sweep-2 checkpoint into the same engine, run to sweep 4 again, and require the first pass's bits.

    The counters are reset just before the resumed sweeps and read just
    after: the kernels of the path must have run, and nothing else.
    """
    first = list(engine.history)
    U0, V0 = engine.factors()
    chains0 = chain_factors(engine)
    step_dir = Path(engine.cfg.run.checkpoint_dir) / f"step_{CHECKPOINT_AT:08d}"
    u_leaf = next(name for name, path in engine.backend.checkpoint_leaves()
                  if path[0] == "state" and path[-1] == "U")
    files = sorted(step_dir.iterdir())
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = engine.restore(step=CHECKPOINT_AT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    resumed = list(engine.sample())
    t2 = time.perf_counter()
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    U1, V1 = engine.factors()
    identical = {"metrics": engine.history == first and resumed == first[step:],
                 "U": bool(np.array_equal(U0, U1)), "V": bool(np.array_equal(V0, V1))}
    if chains0:
        identical["every_chain_U_V"] = all(
            np.array_equal(a, b) for pair0, pair1 in zip(chains0, chain_factors(engine))
            for a, b in zip(pair0, pair1))
    sweeps = engine.num_sweeps_done - step
    expected = {name: n * sweeps for name, n in run["expected_per_sweep"].items()}
    print(json.dumps({
        "phase": label, "card": card, "step": step, "leaves": len(files) - 1,
        "bytes_on_disk": sum(f.stat().st_size for f in files),
        "state_U_shape": list(np.load(step_dir / f"{u_leaf}.npy", mmap_mode="r").shape),
        "save_return_ms": run["save"]["save_return_ms"], "wait_ms": run["save"]["wait_ms"],
        "restore_ms": 1e3 * (t1 - t0), "resumed_sweeps": sweeps, "resumed_seconds": t2 - t1,
        "bit_identical": identical, "counts": counts, "expected_counts": expected,
    }), flush=True)
    if not all(identical.values()):
        raise AssertionError(f"{label}: the resumed run differs from the first pass: {identical}")
    if any(counts[name] != n for name, n in expected.items()):
        raise AssertionError(f"{label}: kernel launches {counts}, want {expected}")
    if counts["PLAIN_CALLS"] or counts["FUSED_PLAIN_CALLS"]:
        raise AssertionError(f"{label}: the resumed sweeps ran a plain version: {counts}")


def percentile_ms(seconds: list[float], q: float) -> float:
    xs = sorted(seconds)
    return 1e3 * xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def drive_server(ServeClient, address: str, payloads: list, expected: list, threads: int) -> dict:
    """Send ``payloads`` through ``threads`` clients (request i on thread ``i % threads``); check each answer."""
    lock = threading.Lock()
    latency = {"predict": [], "top_k": []}
    errors, mismatched = [], []

    def worker(t: int) -> None:
        client = ServeClient(address)
        try:
            for i in range(t, len(payloads), threads):
                t0 = time.perf_counter()
                try:
                    resp = client.request(payloads[i])
                except ConnectionError as e:
                    resp = {"error": f"{type(e).__name__}: {e}"}
                dt = time.perf_counter() - t0
                with lock:
                    latency["predict" if "rows" in payloads[i] else "top_k"].append(dt)
                    if "error" in resp:
                        errors.append(resp["error"])
                    elif resp != expected[i]:
                        mismatched.append(i)
        finally:
            client.close()

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in pool):
        raise AssertionError(f"a client thread of {threads} did not finish")
    out = {"threads": threads, "requests": len(payloads), "seconds": wall, "req_per_s": len(payloads) / wall,
           "errors": len(errors), "mismatched": len(mismatched)}
    for kind, xs in latency.items():
        out[kind] = {"n": len(xs), "p50_ms": percentile_ms(xs, 0.5), "p99_ms": percentile_ms(xs, 0.99)}
    if errors or mismatched:
        raise AssertionError(f"server answers with {threads} threads: errors {errors[:3]}, "
                             f"{len(mismatched)} differ from the in-process answers")
    return out


def phase_sum_order(torch, np, served, card: str) -> None:
    """What the fixed sum order costs, beside the plain products it replaces.

    The plain forms (``U[users] @ V.T`` and ``(U[r] * V[c]).sum(-1)``) may
    sum in another order at another batch size; count the rows of a batch
    whose bits differ from the same queries one at a time, and time both
    forms at batch sizes 1 and 8 (top-k scores) and 32 (pairs), by CUDA
    events. The fixed order must differ in no row.
    """
    from repro_torch.serve.predictor import _catalog_scores, _dot_k

    U, V, Vt, mean = served._U, served._V, served._Vt, served._mean
    lo, hi = served.meta.min_rating, served.meta.max_rating
    rng = np.random.default_rng(3)
    users = torch.from_numpy(rng.integers(0, served.meta.num_users, 8)).cuda()
    rows = torch.from_numpy(rng.integers(0, served.meta.num_users, 32)).cuda()
    cols = torch.from_numpy(rng.integers(0, served.meta.num_movies, 32)).cuda()
    forms = {
        "top_k_fixed": lambda u: (_catalog_scores(U[u], Vt) + mean).clamp(lo, hi),
        "top_k_plain": lambda u: (U[u] @ V.T + mean).clamp(lo, hi),
        "predict_fixed": lambda r, c: (_dot_k(U[r], V[c]) + mean).clamp(lo, hi),
        "predict_plain": lambda r, c: ((U[r] * V[c]).sum(-1) + mean).clamp(lo, hi),
    }
    line = {"phase": "serve_sum_order", "card": card}
    for name, fn in forms.items():
        args = (users,) if name.startswith("top_k") else (rows, cols)
        batch = fn(*args)
        alone = torch.cat([fn(*(a[i:i + 1] for a in args)) for i in range(args[0].shape[0])])
        differ = (batch != alone).reshape(args[0].shape[0], -1).any(dim=1)
        line[name] = {"rows_differing_from_alone": int(differ.sum()), "of": int(args[0].shape[0])}
        for n in ((1, 8) if name.startswith("top_k") else (1, 32)):
            line[name][f"ms_batch_{n}"] = time_ms(torch, lambda: fn(*(a[:n] for a in args)), 20)
    print(json.dumps(line), flush=True)
    if line["top_k_fixed"]["rows_differing_from_alone"] or line["predict_fixed"]["rows_differing_from_alone"]:
        raise AssertionError(f"the fixed sum order changed bits with the batch: {line}")


def phase_serve(torch, np, gram_kernel, engine, tmp: Path, card: str) -> None:
    """Export, load on the card, and serve the ML20M posterior over HTTP; every answer the in-process one's bits."""
    from repro_torch.serve import BPMFServer, PosteriorPredictor, ServeClient, parse_request, run_request

    art = str(tmp / "ml20m_artifact")
    t0 = time.perf_counter()
    engine.export(art)
    t1 = time.perf_counter()
    served = PosteriorPredictor.load(art, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ours = engine.predictor()
    meta = served.meta
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, meta.num_users, 256), rng.integers(0, meta.num_movies, 256)
    for a, b in zip(served.predict(rows, cols, return_std=True), ours.predict(rows, cols, return_std=True)):
        if a.tobytes() != b.tobytes():
            raise AssertionError("the loaded artifact's predict differs from engine.predictor()'s")
    users = rng.integers(0, meta.num_users, 16)
    for a, b in zip(served.top_k(users, 10), ours.top_k(users, 10)):
        if a.tobytes() != b.tobytes():
            raise AssertionError("the loaded artifact's top_k differs from engine.predictor()'s")
    phase_sum_order(torch, np, served, card)

    payloads = []
    for i in range(SERVE_REQUESTS):
        if i % 2 == 0:
            payloads.append({"rows": rng.integers(0, meta.num_users, 32).tolist(),
                             "cols": rng.integers(0, meta.num_movies, 32).tolist(), "std": True})
        else:
            payloads.append({"user": int(rng.integers(0, meta.num_users)), "k": 10})
    expected = [run_request(ours, parse_request(p)) for p in payloads]
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    runs = []
    with BPMFServer(art, host="127.0.0.1", port=0, watch=False) as srv:
        host, port = srv.address
        for threads in (1, 8):
            runs.append(drive_server(ServeClient, f"{host}:{port}", payloads, expected, threads))
        engine.export(art)  # a second export into the served directory
        swapped = srv.poll_artifact_now()
        generation = srv.generation
        stats = srv.stats()["batcher"]
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    print(json.dumps({
        "phase": "serve", "card": card, "export_ms": 1e3 * (t1 - t0), "load_ms": 1e3 * (t2 - t1),
        "artifact_bytes": sum(f.stat().st_size for f in Path(art).rglob("*") if f.is_file()),
        "num_kept_samples": meta.num_kept_samples, "runs": runs,
        "batcher": {k: stats[k] for k in ("cycles", "requests", "coalesced_requests", "max_cycle_requests")},
        "hot_swap": {"swapped": swapped, "generation": generation}, "counts": counts,
    }), flush=True)
    if not swapped or generation != 1:
        raise AssertionError(f"the second export was not swapped in (generation {generation})")


def heldout_rmse(np, predictor, test) -> float:
    """RMSE of a predictor's posterior-mean predictions on the held-out ratings."""
    preds = predictor.predict(test.rows, test.cols)
    return float(np.sqrt(np.mean((preds - test.vals) ** 2)))


def phase_merge(torch, gram_kernel, BPMFEngine, ml: dict, ckpt_root: Path) -> dict:
    """``posterior_merge`` with 4 chains on this card at ML20M: 4 sweeps, every launch counted."""
    from repro_torch.core import sweep_graph

    cfg = ml["cfg"].replace(name="posterior_merge", num_partitions=MERGE_PARTITIONS, partition_strategy="lpt",
                            merge_method="precision", checkpoint_dir=str(ckpt_root / "merge"))
    engine = BPMFEngine(cfg)
    engine.prepare(ml["coo"])
    b = engine.backend
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chains = []
    for c, data in enumerate(b.chain_data):
        buckets = list(data.users.buckets) + list(data.movies.buckets)
        chains.append({
            "chain": c, "device": str(b.devices[c]), "users": len(b.user_sets[c]),
            "train_ratings": data.users.total_ratings(), "test_ratings": b._test_counts[c],
            "buckets": len(buckets),
            "split_buckets": sum(1 for bk in buckets if bk.P > gram_kernel.piece_width(bk.B, bk.P, sms)),
            "largest_pad": {"users": max(bk.P for bk in data.users.buckets),
                            "movies": max(bk.P for bk in data.movies.buckets)},
        })
    n_buckets = sum(ch["buckets"] for ch in chains)
    split_buckets = sum(ch["split_buckets"] for ch in chains)
    print(json.dumps({"phase": "merge_setup", "num_partitions": b.num_partitions,
                      "host_seconds": b.prepare_seconds, "chains": chains}), flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    block_s, save = [], {}
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()
            block_s.append(now - t_prev)
            if m.sweep == CHECKPOINT_AT:
                save = timed_save(engine)  # not charged to the next block
                now = time.perf_counter()
            t_prev = now
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    peak = torch.cuda.max_memory_allocated()
    rmse = [[m.rmse_sample, m.rmse_avg] for m in engine.history]
    sweeps = engine.num_sweeps_done + sweep_graph.WARMUP_SWEEPS  # the capture's warm-up too
    print(json.dumps({
        "phase": "merge_sweeps", "sweeps": engine.num_sweeps_done,
        "warmup_sweeps": sweep_graph.WARMUP_SWEEPS, "graph_replays": b.graph.replays,
        "seconds_per_sweep_by_block": [s_ / cfg.run.sweeps_per_block for s_ in block_s],
        "rmse_sample_avg": rmse, "counts": counts,
        "expected": {"LAUNCHES": n_buckets * sweeps, "REDUCE_LAUNCHES": split_buckets * sweeps},
        "max_memory_allocated_bytes": peak,
    }), flush=True)
    if not all(math.isfinite(v) for row in rmse for v in row):
        raise AssertionError(f"non-finite combined RMSE of the merge chains: {rmse}")
    if not rmse[-1][0] < rmse[0][0]:
        raise AssertionError(f"the merge chains' RMSE did not fall from sweep 1 to sweep 4: {rmse}")
    if counts["LAUNCHES"] != n_buckets * sweeps:
        raise AssertionError(f"{counts['LAUNCHES']} kernel launches, want {n_buckets} buckets of "
                             f"{b.num_partitions} chains x {sweeps} sweeps")
    if counts["REDUCE_LAUNCHES"] != split_buckets * sweeps:
        raise AssertionError(f"{counts['REDUCE_LAUNCHES']} second passes, want {split_buckets} x {sweeps}")
    if counts["PLAIN_CALLS"] or counts["FUSED_PLAIN_CALLS"] or counts["FUSED_LAUNCHES"]:
        raise AssertionError(f"the merge chains ran something other than bpmf_gram: {counts}")
    return {"engine": engine, "launches": counts["LAUNCHES"], "reduce_launches": counts["REDUCE_LAUNCHES"],
            "save": save, "peak": peak,
            "expected_per_sweep": {"LAUNCHES": n_buckets, "REDUCE_LAUNCHES": split_buckets},
            "steady_sweep_s": block_s[-1] / cfg.run.sweeps_per_block}


def phase_merge_export(torch, np, engine, test, seq_rmse: float, baseline: float, tmp: Path,
                       card: str, MERGE_DEGRADATION_MAX) -> None:
    """The merged artifact: served from the card bit for bit as in-process, and its RMSE against the sequential one's."""
    from repro_torch.serve import PosteriorPredictor

    art = str(tmp / "merge_artifact")
    t0 = time.perf_counter()
    engine.export(art)
    t1 = time.perf_counter()
    served = PosteriorPredictor.load(art, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ours = engine.predictor()
    meta = served.meta
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, meta.num_users, 32), rng.integers(0, meta.num_movies, 32)
    for a, b in zip(served.predict(rows, cols, return_std=True), ours.predict(rows, cols, return_std=True)):
        if a.tobytes() != b.tobytes():
            raise AssertionError("the merged artifact's predict differs from engine.predictor()'s")
    users = [int(u) for u in rng.integers(0, meta.num_users, 4)]
    for u in users:
        for a, b in zip(served.top_k(u, 10), ours.top_k(u, 10)):
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"the merged artifact's top_k({u}, 10) differs from engine.predictor()'s")
    merged = heldout_rmse(np, served, test)
    bound = MERGE_DEGRADATION_MAX[MERGE_PARTITIONS]
    print(json.dumps({
        "phase": "merge_export", "card": card, "export_ms": 1e3 * (t1 - t0), "load_ms": 1e3 * (t2 - t1),
        "num_mean_samples": meta.num_mean_samples, "num_kept_samples": meta.num_kept_samples,
        "heldout_ratings": int(len(test.vals)), "rmse_merged_artifact": merged,
        "rmse_sequential_artifact": seq_rmse, "rmse_column_mean_baseline": baseline,
        "degradation": merged - seq_rmse, "degradation_max": bound,
    }), flush=True)
    if not (math.isfinite(merged) and merged - seq_rmse <= bound):
        raise AssertionError(f"merged artifact RMSE {merged} degrades {merged - seq_rmse} over the "
                             f"sequential artifact's {seq_rmse}; bound {bound}")


def phase_merge_buckets(torch, gram_kernel, engine) -> dict:
    """Each chain's heaviest-movie bucket and largest-P users bucket against the plain version, timed."""
    b = engine.backend
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    for c, (data, state) in enumerate(zip(b.chain_data, engine.state)):
        for name, side, X in (("movies", data.movies, state.U), ("users", data.users, state.V)):
            bk = max(side.buckets, key=lambda x: x.P)
            got = gram_kernel.bpmf_gram(X, bk.nbr, bk.val, bk.nnz)
            want = gram_kernel.bpmf_gram_plain(X, bk.nbr, bk.val, bk.nnz)
            torch.cuda.synchronize()
            err, ratio = gram_error(torch, got, want, bk.val, bk.P)
            max_err = max(max_err, err)
            del got, want
            nnz = int(bk.nnz.sum())
            print(json.dumps({
                "phase": "merge_bucket", "chain": c, "side": name, "Ns": X.shape[0], "P": bk.P, "B": bk.B,
                "nnz": nnz, "W": gram_kernel.piece_width(bk.B, bk.P, sms), "max_abs_err": err,
                "err_over_allowance": ratio,
                "kernel_ms": time_ms(torch, lambda: gram_kernel.bpmf_gram(X, bk.nbr, bk.val, bk.nnz), 5),
                "kernel_device_ms": device_ms(torch, lambda: gram_kernel.bpmf_gram(X, bk.nbr, bk.val, bk.nnz)),
                "plain_ms": time_ms(torch, lambda: gram_kernel.bpmf_gram_plain(X, bk.nbr, bk.val, bk.nnz), 2),
                "bmm_contraction_only_ms": bmm_ms(torch, X, bk.nbr, bk.val, bk.nnz, 5),
                "bound_ms": bound_ms(*gram_work(nnz, bk.B, X.shape[0], X.shape[1])),
            }), flush=True)
            torch.cuda.empty_cache()
    return {"max_abs_err": max_err}


def phase_yardsticks(gram: dict, fused: dict) -> dict:
    """Each kernel against ``torch.bmm`` (contraction only) where it is held to it, and the balance.

    Measured and printed, not gates: the heaviest-movie bucket, every
    bucket with at least 1 M real ratings, every movies-side ring layout
    (single calls on both sides); and each movies bucket's device time per
    real rating over the P = 512 movies bucket's, with the same ratio of
    single-call times beside it (a bucket of a few items takes well under
    0.1 ms on the device, so the host's latency per call weighs on it).
    """
    buckets = gram["buckets"]
    heaviest = max((b for b in buckets if b["side"] == "movies"), key=lambda b: b["P"])
    held = [b for b in buckets if b is heaviest or b["nnz"] >= 1_000_000]
    movies = [b for b in buckets if b["side"] == "movies"]
    ref = next(b for b in movies if b["P"] == 512)["ms_per_million_ratings"]
    ref_dev = next(b for b in movies if b["P"] == 512)["device_ms_per_million_ratings"]
    layouts = [lay for lay in fused["layouts"] if lay["side"] == "movies"]
    out = {
        "phase": "yardsticks",
        "buckets_kernel_over_bmm": {f"{b['side']} P={b['P']}": b["kernel_ms"] / b["bmm_contraction_only_ms"]
                                    for b in held},
        "movies_layouts_kernel_over_bmm_max": max(lay["ms"] / lay["bmm_ms"] for lay in layouts),
        "movies_buckets_device_ms_per_rating_over_P512": {
            b["P"]: b["device_ms_per_million_ratings"] / ref_dev for b in movies},
        "movies_buckets_single_call_ms_per_rating_over_P512": {
            b["P"]: b["ms_per_million_ratings"] / ref for b in movies},
    }
    out["no_slower_than_bmm"] = (max(out["buckets_kernel_over_bmm"].values()) <= 1.0
                                 and out["movies_layouts_kernel_over_bmm_max"] <= 1.0)
    out["balanced_within_3x"] = max(out["movies_buckets_device_ms_per_rating_over_P512"].values()) <= 3.0
    print(json.dumps(out), flush=True)
    return out


def phase_small_task(np, gram_kernel, BPMFConfig, BPMFEngine, load_dataset, subset_merge,
                     train_test_split) -> None:
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

    # posterior_merge's statistical gates (tests/test_posterior_quality.py) on the card
    _, test = train_test_split(coo, cfg.run.test_fraction, cfg.run.seed)
    seq = heldout_rmse(np, engine.predictor(), test)
    baseline = subset_merge.column_mean_rmse(coo, cfg.run.test_fraction, cfg.run.seed)
    line = {"phase": "small_task_merge", "rmse_sequential_artifact": seq, "rmse_column_mean_baseline": baseline}
    failed = []
    for P in (2, 4):
        merged = heldout_rmse(np, BPMFEngine(cfg.replace(name="posterior_merge", num_partitions=P)).fit(coo)
                              .predictor(), test)
        lo, hi = subset_merge.MERGE_RMSE_BAND[P]
        bound = subset_merge.MERGE_DEGRADATION_MAX[P]
        line[f"P{P}"] = {"rmse_merged_artifact": merged, "band": [lo, hi], "degradation": merged - seq,
                         "degradation_max": bound}
        if not (lo < merged < hi and merged < 0.95 * baseline and merged - seq <= bound):
            failed.append(P)
    print(json.dumps(line), flush=True)
    if failed:
        raise AssertionError(f"posterior_merge at P = {failed} failed its small-task gates: {line}")


def expected_launches(torch, gram_kernel, data, device: str = "cuda") -> dict:
    """The Gram counters one ring sweep moves, from its step plans (the fused layouts and per-bucket decisions).

    On the card a fused plan launches once if it has a live row (and its
    second pass if a row is split); a per-bucket plan launches once per
    bucket with rows (and a second pass where its piece width splits the
    bucket). On the CPU each call runs the plain version instead.
    """
    out = dict.fromkeys(COUNTERS, 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count if device == "cuda" else 1
    for side, t, i, plan in data.step_plans():
        if device != "cuda":
            out["FUSED_PLAIN_CALLS" if plan.fused else "PLAIN_CALLS"] += 1 if plan.fused else len(plan.buckets)
        elif plan.fused:
            out["FUSED_LAUNCHES"] += plan.layout.num_rows > 0
            out["FUSED_REDUCE_LAUNCHES"] += plan.layout.order.pieces.num_split_rows > 0
        else:
            for b, dec in zip(getattr(data, side).steps[t][i], plan.buckets):
                out["LAUNCHES"] += b.B > 0
                out["REDUCE_LAUNCHES"] += b.B > 0 and -(-b.P // (dec.piece or gram_kernel.piece_width(b.B, b.P, sms))) > 1
    return out


def plan_table(data) -> list:
    """``[side, step, global shard, impl, pc, piece]`` of every ring step plan: what a process decided."""
    offset = data.users.shard_offset
    return [[side, t, offset + i, p.decision.impl, p.decision.pc, p.decision.piece]
            for side, t, i, p in data.step_plans()]


MP_PROCESSES = 2  # the gang of multiproc_ring: two processes sharing the one card over gloo
MP_TIMEOUT_S = 600
MP_CHUNK_ROWS = 1_000_000
ELASTIC_ARGS = ["--backend", "ring", "--num-shards", "4", "--users", "96", "--movies", "64",
                "--nnz", "1500", "--K", "8", "--sweeps", "6", "--burn-in", "2", "--sweeps-per-block", "1"]


def child_env(**extra) -> dict:
    """The environment of a child process: this checkout's sources first, no inherited job."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID")}
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.update(extra)
    return env


def files_equal(a: Path, b: Path) -> dict:
    """Whether two directory trees hold the same files with the same bytes (by relative path)."""
    fa = {p.relative_to(a): p.read_bytes() for p in sorted(a.rglob("*")) if p.is_file()}
    fb = {p.relative_to(b): p.read_bytes() for p in sorted(b.rglob("*")) if p.is_file()}
    return {"files": len(fa), "same_names": sorted(fa) == sorted(fb),
            "same_bytes": sorted(fa) == sorted(fb) and all(fa[k] == fb[k] for k in fa)}


def mp_worker(tmp: Path, rank: int, world: int, port: int, device: str, what: str = "all") -> int:
    """One process of the multiproc_ring gang: the ML20M ring (S = 4), its variants and the merge (P = 4).

    First every rank builds the kernel library into one fresh directory at
    the same moment (the build's atomic rename must cover it). Then it
    streams the ratings the main process wrote (``ChunkedRatings`` over the
    files), builds only its own shards, runs every mode from the seed's
    start, and writes what the main process compares (every rank gathers
    the whole factors). Prints one JSON line per phase, the ring's with the
    rank's step plans. ``what="ring"`` runs the ring alone, on the library
    already built and the autotune cache its environment names
    (``autotune_ring``).
    """
    import numpy as np
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.hostdevices import init_multiprocess, shutdown

    init_multiprocess(f"127.0.0.1:{port}", world, rank, device=device, timeout_s=MP_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.bpmf import BPMFConfig, BPMFEngine
    from repro_torch.core import distributed as dist
    from repro_torch.data.sparse import ChunkedRatings, RatingsCOO
    from repro_torch.kernels import bpmf_gram as gram_kernel
    from repro_torch.kernels import build

    if device == "cuda" and what == "all":
        build._BUILD = tmp / "concurrent_build"
        torch.distributed.barrier()
        built = build.load_library("bpmf_gram")
        print(json.dumps({"phase": "multiproc_build", "rank": rank, "nvcc_seconds": built.seconds,
                          "library": built.path.name}), flush=True)

    dims = json.loads((tmp / "ml20m.json").read_text())
    cols = {k: np.load(tmp / f"ml20m_{k}.npy", mmap_mode="r") for k in ("rows", "cols", "vals")}

    def chunks():
        for lo in range(0, dims["nnz"], MP_CHUNK_ROWS):
            hi = min(lo + MP_CHUNK_ROWS, dims["nnz"])
            yield RatingsCOO(*(np.asarray(cols[k][lo:hi]) for k in ("rows", "cols", "vals")),
                             dims["num_users"], dims["num_movies"])

    stream = ChunkedRatings(chunks, dims["num_users"], dims["num_movies"], dims["nnz"], MP_CHUNK_ROWS)
    out = {}

    def reset():
        for name in COUNTERS:
            setattr(gram_kernel, name, 0)
        torch.cuda.synchronize()

    def counts():
        return {name: getattr(gram_kernel, name) for name in COUNTERS}

    # the ring, S = 4: two shards on each rank, saving at sweep 2 as the single run does
    ckpt = tmp / ("mp_ring" if what == "all" else f"mp_ring_{what}")  # multiproc_resume reads mp_ring
    cfg = ml20m_config(BPMFConfig, str(ckpt)).replace(name="ring", num_shards=RING_SHARDS)
    engine = BPMFEngine(cfg, device=device)
    t0 = time.perf_counter()
    engine.prepare(stream)
    build_s = time.perf_counter() - t0
    b = engine.backend
    per_sweep = expected_launches(torch, gram_kernel, b.data, device)
    torch.cuda.reset_peak_memory_stats()
    reset()
    ring = b.ring
    ring.host_bytes, ring.host_seconds = 0, 0.0
    block_s, staged, save_ms = [], [], None
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()
            block_s.append(now - t_prev)
            staged.append((ring.host_bytes, ring.host_seconds))
            if m.sweep == CHECKPOINT_AT:
                engine.save()  # a collective, written before it returns
                save_ms = 1e3 * (time.perf_counter() - now)
                now = time.perf_counter()
            ring.host_bytes, ring.host_seconds = 0, 0.0
            t_prev = now
    ring_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    U, V = engine.factors()
    out.update(ring_hist=history_rows(engine.history), ring_U=U, ring_V=V)
    spb = cfg.run.sweeps_per_block
    print(json.dumps({
        "phase": "multiproc_ring", "rank": rank, "processes": world, "mode": "ring",
        "backend": torch.distributed.get_backend(), "device": str(ring.home),
        "local_shards": list(ring.local_shards), "local_nnz": b.plan.local_nnz, "total_nnz": b.plan.total_nnz,
        "build_seconds": build_s, **{f"{k}_seconds": v for k, v in b.prepare_seconds.items()},
        "seconds_per_eager_sweep_by_block": [x / spb for x in block_s],
        "host_staged_bytes_per_sweep_by_block": [x / spb for x, _ in staged],
        "host_staged_ms_per_sweep_by_block": [1e3 * y / spb for _, y in staged],
        "save_ms": save_ms, "counts": ring_counts, "expected_per_sweep": per_sweep,
        "max_memory_allocated_bytes": peak, "plans": plan_table(b.data),
    }), flush=True)
    # on a card the kernels launch; a CPU rehearsal of this worker runs their plain versions
    if ring_counts != {k: v * engine.num_sweeps_done for k, v in per_sweep.items()}:
        raise AssertionError(f"rank {rank}: ring kernel launches {ring_counts}, want {per_sweep} per sweep")
    if not 0 < b.plan.local_nnz < b.plan.total_nnz:
        raise AssertionError(f"rank {rank} holds {b.plan.local_nnz} of {b.plan.total_nnz} training ratings")
    out["ring_fused_launches"] = ring_counts["FUSED_LAUNCHES" if device == "cuda" else "FUSED_PLAIN_CALLS"]
    if what == "ring":
        np.savez(tmp / f"mp_{what}_rank{rank}.npz", **out)
        shutdown()
        return 0

    # ring_async (depth 2) and allgather, 2 sweeps each from the same start
    for mode, depth in (("ring_async", 2), ("allgather", 1)):
        mcfg = dataclasses.replace(b.core_cfg, comm_mode=mode, pipeline_depth=depth)
        ring.host_bytes, ring.host_seconds = 0, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, _, rows = dist.dist_gibbs_sweep_block(
            engine._k_run, b.init_state(engine._k_init), b.init_pred(), b.init_accum(), b.data, mcfg, ring, 2)
        rows = rows.cpu().numpy()
        secs = (time.perf_counter() - t0) / 2
        U, V = b.factors(st)
        out.update({f"{mode}_rows": rows, f"{mode}_U": U, f"{mode}_V": V})
        print(json.dumps({"phase": "multiproc_ring", "rank": rank, "mode": mode, "pipeline_depth": depth,
                          "seconds_per_eager_sweep": secs, "host_staged_bytes_per_sweep": ring.host_bytes / 2,
                          "host_staged_ms_per_sweep": 1e3 * ring.host_seconds / 2}), flush=True)
        del st
    del engine, b, ring
    torch.cuda.empty_cache()

    # posterior_merge, P = 4: chains 0 and 2 on rank 0, 1 and 3 on rank 1
    mcfg = ml20m_config(BPMFConfig, str(tmp / "mp_merge")).replace(
        name="posterior_merge", num_partitions=MERGE_PARTITIONS, partition_strategy="lpt", merge_method="precision")
    engine = BPMFEngine(mcfg, device=device)
    t0 = time.perf_counter()
    engine.prepare(stream)
    build_s = time.perf_counter() - t0
    mb = engine.backend
    buckets = sum(len(mb.chain_data[c].users.buckets) + len(mb.chain_data[c].movies.buckets)
                  for c in mb._local_chains)
    torch.cuda.reset_peak_memory_stats()
    reset()
    block_s = []
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % mcfg.run.sweeps_per_block == 0:
            now = time.perf_counter()
            block_s.append(now - t_prev)
            t_prev = now
    merge_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    engine.export(str(tmp / "mp_merge_artifact"))  # rank 0 writes; a barrier follows
    out["merge_hist"] = history_rows(engine.history)
    print(json.dumps({
        "phase": "multiproc_merge", "rank": rank, "local_chains": mb._local_chains, "build_seconds": build_s,
        "seconds_per_eager_sweep_by_block": [x / mcfg.run.sweeps_per_block for x in block_s],
        "counts": merge_counts, "expected_launches": buckets * engine.num_sweeps_done,
        "max_memory_allocated_bytes": peak,
    }), flush=True)
    gram, plain = ("LAUNCHES", "PLAIN_CALLS") if device == "cuda" else ("PLAIN_CALLS", "LAUNCHES")
    if merge_counts[gram] != buckets * engine.num_sweeps_done or merge_counts[plain] \
            or merge_counts["FUSED_LAUNCHES"]:
        raise AssertionError(f"rank {rank}: merge kernel launches {merge_counts}, want {buckets} per sweep")
    out["merge_launches"] = merge_counts[gram]
    np.savez(tmp / f"mp_{what}_rank{rank}.npz", **out)
    shutdown()
    return 0


def run_gang(np, tmp: Path, card: str, device: str = "cuda", what: str = "all", **env) -> tuple[list, list, float]:
    """Run ``chip_smoke.py --mp-worker`` as ``MP_PROCESSES`` processes over the ratings files in ``tmp``.

    Returns each rank's saved arrays, every JSON line the ranks printed
    (echoed with the card) and the gang's wall seconds; raises if a rank
    fails. ``env`` is added to the children's environment.
    """
    import subprocess

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mp-worker", str(tmp),
                               str(r), str(MP_PROCESSES), str(port), device, what],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=child_env(**env))
             for r in range(MP_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for out in outs for line in out.splitlines() if line.startswith("{")]
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    if any(p.returncode for p in procs):
        dump = "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs))
        raise AssertionError(f"the {what} gang failed {[p.returncode for p in procs]}:\n{dump}")
    return [dict(np.load(tmp / f"mp_{what}_rank{r}.npz")) for r in range(MP_PROCESSES)], lines, wall


def gang_plans(lines: list) -> list:
    """Every rank's ring plans from the gang's ``multiproc_ring`` lines, sorted by (side, step, shard)."""
    return sorted(row for line in lines if line.get("mode") == "ring" and "plans" in line for row in line["plans"])


def phase_multiproc(torch, np, ml: dict, ring: dict, tmp: Path, card: str, device: str = "cuda") -> dict:
    """``multiproc_ring``: the gang of two processes on this card, held to the single process's ring bit for bit.

    The ranks' step plans together must be the one process's.
    """
    coo = ml["coo"]
    for k in ("rows", "cols", "vals"):
        np.save(tmp / f"ml20m_{k}.npy", getattr(coo, k))
    (tmp / "ml20m.json").write_text(json.dumps(
        {"num_users": coo.num_users, "num_movies": coo.num_movies, "nnz": coo.nnz}))
    ranks, lines, wall = run_gang(np, tmp, card, device)
    ref = ring["reference"]

    def same(a, b) -> bool:
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    identical = {}
    for r, got in enumerate(ranks):
        identical[f"rank{r}"] = {
            "ring_metrics": same(got["ring_hist"], ref["hist"]),
            "ring_U": same(got["ring_U"], ref["factors"][0]), "ring_V": same(got["ring_V"], ref["factors"][1]),
            **{f"{mode}_{k}": same(got[f"{mode}_{k}"], want)
               for mode in ("ring_async", "allgather")
               for k, want in (("rows", ref[mode]["rows"]), ("U", ref[mode]["factors"][0]),
                               ("V", ref[mode]["factors"][1]))},
        }
    same_plans = gang_plans(lines) == sorted(ring["plans"])
    print(json.dumps({"phase": "multiproc_ring", "card": card, "processes": MP_PROCESSES,
                      "gang_wall_seconds": wall, "bit_identical_to_one_process": identical,
                      "plans_equal_one_process": same_plans}), flush=True)
    if not all(v for per_rank in identical.values() for v in per_rank.values()):
        raise AssertionError(f"the 2-process ring differs from the 1-process ring: {identical}")
    if not same_plans:
        raise AssertionError("the ranks' ring step plans differ from the one process's")
    return {"ranks": ranks, "tmp": tmp, "lines": lines, "wall": wall,
            "ring_launches": [int(x["ring_fused_launches"]) for x in ranks],
            "merge_launches": [int(x["merge_launches"]) for x in ranks]}


def phase_multiproc_resume(torch, np, gram_kernel, engine, ring: dict, mp: dict, card: str) -> None:
    """``multiproc_resume``: this single process restores the gang's sweep-2 checkpoint; sweeps 3-4 bit for bit."""
    ckpt = mp["tmp"] / "mp_ring"
    step_dir = ckpt / f"step_{CHECKPOINT_AT:08d}"
    shard_files = sorted(f.name for f in step_dir.iterdir() if ".shard-" in f.name)
    engine.cfg = engine.cfg.replace(checkpoint_dir=str(ckpt))
    engine._ckpt = None  # the manager of the gang's directory
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = engine.restore(step=CHECKPOINT_AT)
    t1 = time.perf_counter()
    for _ in engine.sample():
        pass
    t2 = time.perf_counter()
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    U, V = engine.factors()
    ref = ring["reference"]
    identical = {"metrics": history_rows(engine.history).tobytes() == ref["hist"].tobytes(),
                 "U": U.tobytes() == ref["factors"][0].tobytes(), "V": V.tobytes() == ref["factors"][1].tobytes()}
    print(json.dumps({"phase": "multiproc_resume", "card": card, "step": step, "written_by_processes": MP_PROCESSES,
                      "shard_files": shard_files, "restore_ms": 1e3 * (t1 - t0), "resumed_seconds": t2 - t1,
                      "counts": counts, "bit_identical": identical}), flush=True)
    if not shard_files or not all(identical.values()):
        raise AssertionError(f"multiproc_resume: the resumed sweeps differ from the uninterrupted run: {identical}")
    launched, plain = ("FUSED_LAUNCHES", "FUSED_PLAIN_CALLS") if engine.device.type == "cuda" else (
        "FUSED_PLAIN_CALLS", "FUSED_LAUNCHES")
    if not counts[launched] or counts["PLAIN_CALLS"] or counts[plain]:
        raise AssertionError(f"multiproc_resume: kernel launches {counts}")


def phase_multiproc_merge(np, engine, mp: dict, artifact: Path, card: str) -> None:
    """The gang's ``posterior_merge`` (P = 4, two chains per rank) against this process's: metrics and artifact bit for bit."""
    want = history_rows(engine.history)
    identical = {f"rank{r}_metrics": got["merge_hist"].tobytes() == want.tobytes()
                 for r, got in enumerate(mp["ranks"])}
    art = files_equal(mp["tmp"] / "mp_merge_artifact", artifact)
    identical["artifact"] = art["same_bytes"]
    print(json.dumps({"phase": "multiproc_merge", "card": card, "artifact_files": art["files"],
                      "bit_identical_to_one_process": identical}), flush=True)
    if not all(identical.values()):
        raise AssertionError(f"the 2-process merge differs from the 1-process merge: {identical}")


def phase_elastic(tmp: Path, card: str, device: str = "cuda") -> None:
    """``elastic``: the launcher with the last of 2 ranks killed at sweep 3 restarts at 1 process, same samples."""
    import subprocess

    def launch(own: list[str], fwd: list[str]) -> tuple[str, float]:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.multiproc", *own, "--", "--device", device,
                            *ELASTIC_ARGS, *fwd],
                           capture_output=True, text=True, env=child_env(), timeout=MP_TIMEOUT_S)
        if r.returncode:
            raise AssertionError(f"elastic: launcher exit {r.returncode}:\n{r.stdout[-4000:]}\n{r.stderr[-2000:]}")
        return r.stdout, time.perf_counter() - t0

    ref, ref_s = launch(["--num-processes", "1"], ["--export-artifact", str(tmp / "ref")])
    out, el_s = launch(["--num-processes", "2", "--elastic", "--max-restarts", "2", "--timeout", "300"],
                       ["--checkpoint-dir", str(tmp / "ck"), "--checkpoint-every", "2", "--inject-failure", "3",
                        "--export-artifact", str(tmp / "art")])
    summary = dict(kv.split("=") for kv in out.strip().splitlines()[-1].split()[2:])
    art = files_equal(tmp / "art", tmp / "ref")
    checks = {"killed_rank_1_at_sweep_3": "injected failure at sweep 3 on process 1" in out,
              "restarted_at_1_process": "elastic restart: 1 processes" in out,
              "resumed_at_sweep_2": "resumed from checkpoint at sweep 2" in out,
              "artifact_bit_identical": art["same_bytes"]}
    print(json.dumps({"phase": "elastic", "card": card, "restarts": int(summary["restarts"]),
                      "seconds_lost": float(summary["lost_seconds"]), "uninterrupted_seconds": ref_s,
                      "elastic_seconds": el_s, "artifact_files": art["files"], "checks": checks}), flush=True)
    if not all(checks.values()) or int(summary["restarts"]) != 1:
        raise AssertionError(f"elastic: {checks}, {summary}\n{out[-4000:]}")


def phase_sharded_topk(torch, np, engine, card: str, device: str = "cuda") -> None:
    """``sharded_topk``: the ML20M posterior's V in 4 item shards on this card against the replicated scan."""
    from repro_torch.serve import PosteriorPredictor
    from repro_torch.serve.predictor import serve_devices

    meta, arrays = engine._artifact_payload()
    p = PosteriorPredictor(meta, arrays, device, topk_mode="sharded", item_devices=serve_devices(4, device))
    per = -(-meta.num_movies // 4)
    users = np.random.default_rng(7).integers(0, meta.num_users, 1000)
    got = p.top_k(users, 10, sharded=True)
    want = p.top_k(users, 10, sharded=False)
    identical = {"ids": got[0].tobytes() == want[0].tobytes(), "scores": got[1].tobytes() == want[1].tobytes()}
    sharded_ms = 1e3 * statistics.median(timed(lambda: p.top_k(users, 10, sharded=True)) for _ in range(5))
    replicated_ms = 1e3 * statistics.median(timed(lambda: p.top_k(users, 10, sharded=False)) for _ in range(5))
    print(json.dumps({"phase": "sharded_topk", "card": card, "users": len(users), "k": 10,
                      "items": meta.num_movies, "item_shards": len(p.item_devices),
                      "shard_rows": [max(0, min(per, meta.num_movies - i * per)) for i in range(4)],
                      "sharded_ms": sharded_ms, "replicated_ms": replicated_ms, "bit_identical": identical}),
          flush=True)
    if not all(identical.values()):
        raise AssertionError(f"sharded top-k differs from the replicated scan: {identical}")


AUTOTUNE_ITERS = 10  # timed replays of each candidate of an ML20M ring step
# benchmarks_torch's drivers: name -> (module, keyword arguments of its run())
BENCHMARKS = {
    "fig2_item_update": ("fig2_item_update", {}),
    "sweep_throughput": ("sweep_throughput", {}),
    "rmse_convergence": ("rmse_convergence", {}),
    "fig3_multicore": ("fig3_multicore", {}),
    "fig4_scaling": ("fig4_scaling", {"processes": (1, MP_PROCESSES), "timeout": 240}),
    "fig5_overlap": ("fig5_overlap", {}),
    "fig_merge_comm": ("fig_merge_comm", {}),
    "serve_latency": ("serve_latency", {}),
    "serve_load": ("serve_latency", {"load": True}),
}
EXAMPLES = ("quickstart", "distributed_bpmf", "bpmf_chembl")


def bench_headline(name: str, payload: dict) -> dict:
    """The numbers a driver's ``bench_drivers`` line shows."""
    if name == "fig2_item_update":
        return {"cost_model": payload["cost_model"],
                "winners": {k: [v["winner"], v["pc"], v["piece"], v["timings_us"]]
                            for k, v in payload["kernel_sweep"].items()}}
    if name == "sweep_throughput":
        return {**{k: payload[k] for k in ("parity_ok", "block_transfer_drop_ok", "save_return_latency")},
                "sweeps_per_sec": {n: {k: e[k]["sweeps_per_sec"] for k in e} for n, e in payload["backends"].items()}}
    if name == "rmse_convergence":
        return {k: payload[k] for k in ("final_rmse", "max_trajectory_gap", "parity_ok")}
    if name == "fig3_multicore":
        r = payload["results"]
        return {"speedup_bucketed_vs_maxpad": r["speedup_bucketed_vs_maxpad"],
                "eager_speedup_bucketed_vs_maxpad": r["eager_speedup_bucketed_vs_maxpad"],
                "ms_per_halfsweep": {m: r[m]["seconds_per_halfsweep"] * 1e3 for m in r if isinstance(r[m], dict)}}
    if name == "fig4_scaling":
        ps = payload["process_sweep"]
        rb = ps["ring_bytes_per_sweep"]
        return {"model_matches": rb["model_matches"], "measured_bytes": rb["measured"],
                "modelled_bytes": rb["modelled"],
                "layouts": [{k: r[k] for k in ("processes", "sweeps_per_s", "cross_process_bytes_per_sweep",
                                               "cross_process_rotation_bytes_per_sweep",
                                               "modelled_cross_process_bytes_per_sweep")} for r in ps["layouts"]],
                "updates_per_s": {m: [r["updates_per_s"] for r in rows] for m, rows in payload["modes"].items()}}
    if name == "fig5_overlap":
        return {k: payload[k] for k in ("ring_async_bitwise", "parity_ok", "speedup_vs_allgather",
                                        "eager_speedup_vs_allgather", "cards")}
    if name == "fig_merge_comm":
        return {**{k: payload[k] for k in ("beats_baseline", "within_band", "zero_comm_ok")},
                "collective_ops": {n: e["collective_ops"] for n, e in payload["backends"].items()}}
    if name == "serve_latency":
        return {"p50_ms": {b: e["p50_ms"] for b, e in payload["batches"].items()},
                "top_k_p99_ms": payload["top_k"]["p99_ms"]}
    return {"top_k_p99_ms": {m: payload["top_k"][m]["p99_ms"] for m in ("replicated", "sharded")},
            "load": {c: {"p99_ms": e["p99_ms"], "errors": e["errors"], "offered_qps": e["offered_qps"]}
                     for c, e in payload["load"].items()}}


def sequential_keys(autotune, engine) -> list:
    """``(bucket key, planned decision)`` of every bucket of the sequential ML20M data."""
    data, K = engine.backend.data, engine.backend.core_cfg.K
    return [(autotune.bucket_key(b.B, b.P, Ns, K), dec)
            for side, Ns in ((data.users, data.num_movies), (data.movies, data.num_users))
            for b, dec in zip(side.buckets, side.gram, strict=True)]


def phase_autotune_cold(autotune, seq_keys: list, ring_engine, card: str) -> list:
    """``autotune_cold``: on the run's empty cache, the heuristic is the dispatch without measurements, key by key.

    Every sequential bucket key gives the per-bucket kernel with the piece
    rule and every (side, step, shard) key of the 4-shard ring the fused
    kernel at ``pc = 128``, and the engines planned exactly that. Returns
    the ring's distinct ``(key, bucket shapes)``, which ``autotune_ring``
    measures.
    """
    b = ring_engine.backend
    data, K = b.data, b.core_cfg.K
    cache = autotune.get_cache()
    today_step, today_bucket = autotune.Decision("pallas_fused", pc=128), autotune.Decision("pallas")
    differ = [k.encode() for k, dec in seq_keys if not autotune.heuristic(k) == dec == today_bucket]
    planned = 0
    for name, t, i, plan in data.step_plans():
        side, opp = (data.users, data.movies) if name == "users" else (data.movies, data.users)
        key = autotune.step_key([(x.B, x.P) for x in side.steps[t][i]], opp.cap, K, side.cap)
        planned += 1
        if not (autotune.heuristic(key) == plan.decision == today_step and plan.layout.nbr.shape[1] == 128):
            differ.append(key.encode())
    keys = autotune.workload_step_keys(data, K)
    distinct = {key.encode(): (key, shapes) for key, shapes in keys}
    print(json.dumps({"phase": "autotune_cold", "card": card, "cache": cache.path,
                      "cache_entries": len(cache.entries()), "sequential_bucket_keys": len(seq_keys),
                      "ring_step_keys": len(keys), "ring_steps_planned": planned,
                      "distinct_ring_step_keys": len(distinct), "differ_from_today": differ}), flush=True)
    if cache.entries() or differ or planned != len(keys):
        raise AssertionError(f"the cold cache does not give today's dispatch: {differ}")
    return list(distinct.values())


def planned_ring(torch, gram_kernel, autotune, BPMFEngine, ml: dict, cache, label: str, card: str) -> dict:
    """A fresh ML20M ring (S = 4) planned from ``cache``: 4 sweeps, captured, held to its plans.

    The counters are reset just before the sweeps and read just after and
    must be what the plans launch (:func:`expected_launches`, for the 4
    replays and the capture's warm-up sweep); the RMSE within 1e-3 of the
    sequential's. Prints one ``label`` line.
    """
    from collections import Counter

    from repro_torch.core import sweep_graph

    autotune.set_cache(cache)
    try:
        cfg = ml["cfg"].replace(name="ring", num_shards=RING_SHARDS, checkpoint_dir=None)
        engine = BPMFEngine(cfg)
        engine.prepare(ml["coo"])
    finally:
        autotune.set_cache(None)
    b = engine.backend
    plans = plan_table(b.data)
    by_decision = dict(Counter(impl + (f"_pc{pc}" if pc else "") + (f"_piece{piece}" if piece else "")
                               for _, _, _, impl, pc, piece in plans))
    per_sweep = expected_launches(torch, gram_kernel, b.data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)
    block_s = []
    t_prev = time.perf_counter()
    for m in engine.sample():
        if m.sweep % cfg.run.sweeps_per_block == 0:
            now = time.perf_counter()
            block_s.append(now - t_prev)
            t_prev = now
    counts = {name: getattr(gram_kernel, name) for name in COUNTERS}
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * (engine.num_sweeps_done + sweep_graph.WARMUP_SWEEPS) for k, v in per_sweep.items()}
    rmse = [m.rmse_sample for m in engine.history]
    gap = [abs(a - c) for a, c in zip(rmse, ml["rmse_sample"])]
    spb = cfg.run.sweeps_per_block
    print(json.dumps({
        "phase": label, "card": card, "host_seconds": b.prepare_seconds, "steps_by_decision": by_decision,
        "counts": counts, "expected_counts": want, "launches_per_replay": b.graph.launches_per_replay,
        "seconds_per_sweep_by_block": [x / spb for x in block_s], "max_memory_allocated_bytes": peak,
        "rmse_sample": rmse, "rmse_gap_to_sequential": gap,
    }), flush=True)
    if counts != want:
        raise AssertionError(f"{label}: Gram launches {counts} are not its plans' {want}")
    if not all(math.isfinite(v) for v in rmse) or max(gap) > 1e-3:
        raise AssertionError(f"{label}: RMSE {rmse} is not within 1e-3 of the sequential {ml['rmse_sample']}")
    return {"engine": engine, "plans": plans, "steps_by_decision": by_decision, "counts": counts,
            "steady_sweep_s": block_s[-1] / spb, "peak": peak}


def phase_autotune_ring(torch, np, gram_kernel, autotune, ops, BPMFEngine, dist, ml: dict, ring_cold: dict,
                        fused_cold: dict, keys: list, tmp: Path, card: str) -> dict:
    """``autotune_ring``: measure every distinct ML20M ring step key, then run a fresh ring on that cache.

    ``measure_step`` times each candidate (every one first held against the
    plain version) into a fresh cache; a fresh 4-shard ring engine plans
    from it and runs 4 sweeps, captured, with the counters reset just before
    and read just after and held to its plans; its RMSE within 1e-3 of the
    sequential's; ``graph_sweeps`` holds its captured sweeps to the eager
    loop bit for bit; every (side, step, shard) is timed as a replayed
    graph with the cold plan and the warmed one in turns; and the 2-process
    gang on the same cache must plan the same and equal this run bit for bit.
    Then ``autotune_ring_per_bucket``: a ring on a cache that records, for
    every key, the per-bucket kernel at the piece width measured fastest,
    held to its plans' launches, to the sequential RMSE and, bit for bit,
    to its own eager sweeps.
    """
    from repro_torch.core import sweep_graph

    warm_dir = tmp / "autotune_warm"
    cache = autotune.AutotuneCache(str(warm_dir / autotune.CACHE_FILE))
    t_measure = time.perf_counter()
    for key, shapes in keys:
        t0 = time.perf_counter()
        best, timings = autotune.measure_step(shapes, key.Ns, key.K, cap=key.cap, iters=AUTOTUNE_ITERS,
                                              cache=cache, device="cuda")
        left_out = sorted(set(autotune.candidates("cuda")) - set(timings))
        print(json.dumps({"phase": "autotune_measure", "card": card, "key": key.encode(), "buckets": shapes,
                          "timings_us": timings, "winner": dataclasses.asdict(best), "left_out": left_out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if left_out:
            raise AssertionError(f"{key.encode()}: candidates {left_out} missed the plain version's band")
    measure_s = time.perf_counter() - t_measure

    run = planned_ring(torch, gram_kernel, autotune, BPMFEngine, ml, cache, "autotune_ring", card)
    engine, plans = run["engine"], run["plans"]
    b, cfg = engine.backend, engine.cfg
    cold_by_side = {side: sum(x["device_ms"] for x in fused_cold["layouts"] if x["side"] == side)
                    for side in ("users", "movies")}
    print(json.dumps({"phase": "autotune_ring_against_cold", "card": card, "measured_keys": len(keys),
                      "measure_seconds": measure_s, "cache_entries": len(cache.entries()),
                      "seconds_per_sweep": {"warmed": run["steady_sweep_s"], "cold": ring_cold["steady_sweep_s"]},
                      "max_memory_allocated_bytes": {"warmed": run["peak"], "cold": ring_cold["peak"]},
                      "cold_fused_device_ms_by_side": cold_by_side}), flush=True)
    reference = {"hist": history_rows(engine.history), "factors": engine.factors()}
    phase_graph_sweeps(torch, engine, run, f"ring S={RING_SHARDS} warmed", card, dist=dist)

    # every (side, step, shard): the cold plan (fused, pc = 128) and the warmed one, replayed in turns
    state, S, K = engine.state, b.num_shards, cfg.model.K
    gram = {kind: {"users": 0.0, "movies": 0.0} for kind in ("cold", "warm")}
    for side_name, t, i, plan in b.data.step_plans():
        side = getattr(b.data, side_name)
        X = (state.V if side_name == "users" else state.U)[(i - t) % S]
        buckets = side.steps[t][i]
        plans_of = {"cold": ops.StepPlan.for_decision(autotune.Decision("pallas_fused", pc=ops.FUSED_PC), buckets),
                    "warm": plan}
        G = torch.zeros(side.cap, K, K, device="cuda")
        g = torch.zeros(side.cap, K, device="cuda")
        us = autotune.time_us({kind: (lambda p=p: ops.bpmf_gram_step(G, g, X, buckets, alpha=ALPHA, plan=p))
                               for kind, p in plans_of.items()}, torch.device("cuda"), iters=20)
        for kind in us:
            gram[kind][side_name] += us[kind] / 1e3
        del plans_of, G, g
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "autotune_gram_per_sweep", "card": card, "replayed_ms_by_side": gram,
                      "replayed_ms": {kind: sum(v.values()) for kind, v in gram.items()},
                      "cold_fused_device_ms_by_side": cold_by_side}), flush=True)

    # two processes on the same warmed cache: the same plans, the same bits
    ranks, lines, wall = run_gang(np, tmp, card, what="ring", REPRO_TORCH_AUTOTUNE_DIR=str(warm_dir))

    def same(a, c) -> bool:
        return a.dtype == c.dtype and a.shape == c.shape and a.tobytes() == c.tobytes()

    identical = {f"rank{r}": {"ring_metrics": same(got["ring_hist"], reference["hist"]),
                              "ring_U": same(got["ring_U"], reference["factors"][0]),
                              "ring_V": same(got["ring_V"], reference["factors"][1])}
                 for r, got in enumerate(ranks)}
    same_plans = gang_plans(lines) == sorted(plans)
    print(json.dumps({"phase": "autotune_multiproc", "card": card, "processes": MP_PROCESSES,
                      "gang_wall_seconds": wall, "bit_identical_to_one_process": identical,
                      "plans_equal_one_process": same_plans}), flush=True)
    if not same_plans or not all(v for per_rank in identical.values() for v in per_rank.values()):
        raise AssertionError(f"the warmed 2-process ring differs from one process: {identical}, plans {same_plans}")
    del engine, b, state, run["engine"]
    torch.cuda.empty_cache()

    # every step on the per-bucket kernel, at the piece width each key measured fastest: recorded, not measured
    forced = autotune.AutotuneCache(str(tmp / "autotune_per_bucket" / autotune.CACHE_FILE))
    for key, _ in keys:
        timings = cache.entries()[key.encode()]["timings_us"]
        piece = min((label for label in timings if label.startswith("pallas_piece")), key=timings.get)
        forced.record(key, autotune.candidates("cuda")[piece])
    per_bucket = planned_ring(torch, gram_kernel, autotune, BPMFEngine, ml, forced, "autotune_ring_per_bucket", card)
    forced_engine = per_bucket.pop("engine")
    pb = forced_engine.backend
    start = (pb.init_state(forced_engine._k_init), pb.init_pred(), pb.init_accum())
    *eager, rows = pb.sweep_block(forced_engine._k_run, *start, forced_engine.num_sweeps_done, _eager=True)
    captured = (forced_engine._state, forced_engine._pred, forced_engine._accum)
    same = [r[:3] for r in rows.cpu().numpy().tolist()] == [list(m) for m in forced_engine.history] and all(
        torch.equal(x, y) for x, y in zip(sweep_graph.tensors(tuple(eager)), sweep_graph.tensors(captured)))
    del forced_engine, pb, start, eager, captured
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "autotune_ring_per_bucket", "card": card, "captured_equals_eager": same}), flush=True)
    if not same:
        raise AssertionError("the per-bucket ring's captured sweeps differ from its eager ones")
    return {"launches": run["counts"], "gram": gram, "steps_by_decision": run["steps_by_decision"],
            "per_bucket_launches": per_bucket["counts"]}


def reset_counters(gram_kernel) -> None:
    for name in COUNTERS:
        setattr(gram_kernel, name, 0)


def phase_bench_drivers(torch, gram_kernel, tmp: Path, card: str) -> dict:
    """``bench_drivers``: each of ``benchmarks_torch``'s drivers once on the card at its smoke size.

    Each writes into ``tmp`` (never the committed files), its JSON must
    pass ``scripts/check_bench_schema_torch.py``, and its Gram launches
    are counted (the counters reset just before it and read just after);
    prints the headline numbers and returns the counts by driver.
    """
    import importlib
    import importlib.util

    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("check_bench_schema_torch",
                                                  ROOT / "scripts" / "check_bench_schema_torch.py")
    schema = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(schema)
    launches = {}
    for name, (module, kwargs) in BENCHMARKS.items():
        bench = importlib.import_module(f"benchmarks_torch.{module}")
        reset_counters(gram_kernel)
        t0 = time.perf_counter()
        payload = bench.run(smoke=True, out_path=str(tmp / f"{name}.json"), device="cuda", **kwargs)
        launches[name] = {n: getattr(gram_kernel, n) for n in COUNTERS}
        line = {"phase": "bench_drivers", "benchmark": name, "card": card, "seconds": time.perf_counter() - t0,
                "schema_violations": schema.check(name, payload, committed=False), "launches": launches[name],
                **bench_headline(name, payload)}
        print(json.dumps(line), flush=True)
        if line["schema_violations"]:
            raise AssertionError(f"{name}: {line['schema_violations']}")
        # fig2's measure_step holds every candidate to the plain version; no other driver calls it
        if name != "fig2_item_update" and (launches[name]["PLAIN_CALLS"] or launches[name]["FUSED_PLAIN_CALLS"]):
            raise AssertionError(f"{name}: the plain Gram version ran on the card: {launches[name]}")
    return launches


def phase_examples(gram_kernel, tmp: Path, card: str) -> dict:
    """``examples``: each ``examples_torch`` script at its own size on the card; its self-checks must pass."""
    import contextlib
    import importlib.util
    import io

    launches = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        argv = ["--device", "cuda"] + (["--checkpoint-dir", str(tmp / name)] if name == "bpmf_chembl" else [])
        reset_counters(gram_kernel)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            module.main(argv)
        seconds = time.perf_counter() - t0
        launches[name] = {n: getattr(gram_kernel, n) for n in COUNTERS}
        lines = out.getvalue().splitlines()
        print(json.dumps({"phase": "examples", "example": name, "card": card, "seconds": seconds,
                          "launches": launches[name], "last_lines": lines[-3:]}), flush=True)
        if not lines or not lines[-1].startswith("ok"):
            raise AssertionError(f"{name} did not end with ok: {lines[-5:]}")
        if not (launches[name]["LAUNCHES"] or launches[name]["FUSED_LAUNCHES"]):
            raise AssertionError(f"{name} launched no Gram kernel: {launches[name]}")
    return launches


LM_ARCHS = ("gemma-2b", "yi-6b", "chameleon-34b", "nemotron-4-340b", "hubert-xlarge")  # the ported family
LM_PARITY_TOL = 1e-4  # card against the port's CPU run, f32 activations: logits, loss, grad norm
GEMMA_PARAMS = 2_506_172_416  # the reference's build_model(get_config("gemma-2b")).num_params()
LM_SEQ = 4096  # train_4k's sequence; its global batch of 256 is cut to 1
LM_STEPS = 8
LM_LR = 1e-4  # constant: the reference's 3e-3 schedule is for the reduced configs
DECODE_PROMPT = 4096
DECODE_TOKENS = 32
TEACHER_TOKENS = 16
DECODE_BAND = 5e-2  # bf16: teacher-forced decode within 5e-2 of the largest forward logit
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16


def lm_max_err(torch, got, want, vocab: int) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|)) over the real vocabulary (the padded tail is masked)."""
    got, want = got[..., :vocab].float().cpu(), want[..., :vocab].float().cpu()
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def phase_lm_reduced_parity(torch, card: str) -> None:
    """``lm_reduced_parity``: each reduced attention-family config, f32 activations, on the card against the CPU.

    The same params (drawn once on the CPU, copied to the card) and batch:
    forward logits through the dense path and through the flash path (small
    chunks), then one train step's loss and grad norm, each within
    ``LM_PARITY_TOL`` (relative to max(1, |value|)).
    """
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.train import step_generator, synthetic_lm_batch
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW, tree_map
    from repro_torch.training.train import TrainState, make_train_step

    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced().replace(activation_dtype="float32")
        line = {"phase": "lm_reduced_parity", "arch": cfg.name, "card": card}
        batch = synthetic_lm_batch(step_generator(0, 0), cfg, 2, 64, "cpu")
        params = build_model(cfg).init(prng.key(0), "cpu")
        on_card = lambda tree: tree_map(lambda t: t.to("cuda"), tree)
        for path, c in (("dense", cfg), ("flash", cfg.replace(attn_q_chunk=16, attn_kv_chunk=32))):
            model = build_model(c)
            with torch.no_grad():
                want, _ = model.forward(params, batch["inputs"])
                got, _ = model.forward(on_card(params), batch["inputs"].cuda())
            line[f"{path}_logits_max_abs_err"], line[f"{path}_logits_rel_err"] = lm_max_err(torch, got, want,
                                                                                           cfg.vocab_size)
        model = build_model(cfg)
        metrics = {}
        for dev in ("cpu", "cuda"):
            opt = AdamW(learning_rate=1e-3)
            p = tree_map(lambda t: t.clone().to(dev), params)
            state = TrainState(params=p, opt=opt.init(p), step=torch.zeros((), dtype=torch.int32, device=dev))
            _, metrics[dev] = make_train_step(model, opt)(state, {k: v.to(dev) for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            want, got = float(metrics["cpu"][key]), float(metrics["cuda"][key])
            line[key] = [want, got]
            line[f"{key}_rel_err"] = abs(got - want) / max(1.0, abs(want))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        errs = [v for k, v in line.items() if k.endswith("rel_err")]
        if not all(math.isfinite(e) and e <= LM_PARITY_TOL for e in errs):
            raise AssertionError(f"{cfg.name}: card against CPU beyond {LM_PARITY_TOL}: {line}")


def phase_lm_gemma2b_train(torch, card: str) -> tuple:
    """``lm_gemma2b_train``: gemma-2b at full width, f32 params, bf16 activations, ``remat="full"``.

    One sequence of ``LM_SEQ`` tokens (train_4k's, global batch 256 cut to
    1), ``LM_STEPS`` steps on that repeated batch at a constant rate of
    ``LM_LR``: every loss finite and the last below the first. Prints the
    step ms (median of steps 3-8), tokens/s, model FLOPs per token (6 x
    matmul params + 12 x layers x heads x head_dim x seq for attention) and
    their share of the card's dense bf16 peak, and peak memory; then one
    more step under torch.profiler: device kernel ms, launches, the busy
    share against the median step, and the longest kernels. Returns
    (model, params) for the decode phase.
    """
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch.train import step_generator, synthetic_lm_batch
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train import TrainState, make_train_step

    cfg = get_config("gemma-2b")
    model = build_model(cfg)
    if model.num_params() != GEMMA_PARAMS:
        raise AssertionError(f"gemma-2b has {model.num_params()} params, the reference {GEMMA_PARAMS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = AdamW(learning_rate=LM_LR)
    state = TrainState(params=params, opt=opt.init(params), step=torch.zeros((), dtype=torch.int32, device="cuda"))
    batch = synthetic_lm_batch(step_generator(0, 0), cfg, 1, LM_SEQ, "cuda")
    step_fn = make_train_step(model, opt)
    losses, seconds, gnorms = [], [], []
    for _ in range(LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        seconds.append(time.perf_counter() - t0)
        gnorms.append(float(metrics["grad_norm"]))
    step_s = statistics.median(seconds[2:])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # one more step, traced
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    traced = {"device_kernel_ms": sum(r[0] for r in rows), "kernel_launches": sum(r[1] for r in rows),
              "busy_share": sum(r[0] for r in rows) / (step_s * 1e3),
              "top_kernels_ms_count": [[round(ms, 3), n, name[:90]] for ms, n, name in rows[:12]]}
    flops_token = 6 * model.matmul_params() + 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * LM_SEQ
    line = {"phase": "lm_gemma2b_train", "card": card, "num_params": model.num_params(),
            "matmul_params": model.matmul_params(), "seq": LM_SEQ, "batch": 1,
            "reduced": {"global_batch": [256, 1]}, "remat": cfg.remat, "param_dtype": cfg.param_dtype,
            "activation_dtype": cfg.activation_dtype,
            "flash_blocks": [-(-LM_SEQ // cfg.attn_q_chunk), -(-LM_SEQ // cfg.attn_kv_chunk)],
            "init_s": init_s, "losses": losses, "grad_norms": gnorms, "step_seconds": seconds,
            "step_ms": step_s * 1e3, "tokens_per_s": LM_SEQ / step_s, "model_flops_per_token": flops_token,
            "bf16_peak_share": flops_token * LM_SEQ / step_s / PEAK_BF16_FLOPS,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "profiled_step": traced}
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(x) for x in losses + gnorms) or not losses[-1] < losses[0]:
        raise AssertionError(f"gemma-2b: loss not finite and falling over {LM_STEPS} steps: {losses}")
    del state, opt, metrics
    torch.cuda.empty_cache()
    return model, params


def phase_lm_gemma2b_decode(torch, model, params, card: str) -> None:
    """``lm_gemma2b_decode``: teacher-forced decode against ``forward``, then prefill and greedy decode timed.

    ``forward`` over ``DECODE_PROMPT + TEACHER_TOKENS`` tokens against a
    prefill of the prompt and ``TEACHER_TOKENS`` one-token decode steps fed
    the same tokens: max |Δ| over the ``TEACHER_TOKENS + 1`` positions at
    most ``DECODE_BAND`` x max |logits| (bf16). Then a prefill of the prompt
    (ms) and ``DECODE_TOKENS`` greedy tokens (ms per token), each ended by a
    synchronize, and the cache's bytes.
    """
    from repro_torch.training.lm_serve import make_decode_step, make_prefill_step
    from repro_torch.utils import tree_size_bytes

    cfg = model.cfg
    P, T = DECODE_PROMPT, TEACHER_TOKENS
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, P + T), generator=gen).to(torch.int32).cuda()
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        hidden, _ = model.hidden(params, tokens)
        want = model.logits(params, hidden[:, P - 1 :])  # positions P-1 .. P+T-1
        del hidden
        logits, cache = prefill(params, tokens[:, :P], model.init_cache(1, P + T, "cuda"))
        got = [logits[:, -1]]
        for t in range(T):
            logits, cache = model.decode(params, tokens[:, P + t : P + t + 1], cache,
                                         torch.tensor([P + t], dtype=torch.int32, device="cuda"))
            got.append(logits[:, -1])
        got = torch.stack(got, dim=1)
        err = float((got - want).abs().max())
        ratio = err / float(want.abs().max())
        del got, want, cache

        times = {}
        for rep in range(2):  # the first pass warms up; the second is timed
            cache = model.init_cache(1, P + DECODE_TOKENS, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, tokens[:, :P], cache)
            torch.cuda.synchronize()
            times["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            out = [tok]
            t0 = time.perf_counter()
            for t in range(DECODE_TOKENS - 1):
                tok, cache = decode(params, tok, cache, torch.tensor(P + t, dtype=torch.int32, device="cuda"))
                out.append(tok)
            torch.cuda.synchronize()
            times["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / (DECODE_TOKENS - 1)
    generated = torch.cat(out, dim=1)
    line = {"phase": "lm_gemma2b_decode", "card": card, "prompt": P, "teacher_tokens": T,
            "teacher_max_abs_err": err, "teacher_err_over_max_logit": ratio, "band": DECODE_BAND,
            **times, "generated_tokens": int(generated.shape[1]),
            "cache_bytes": tree_size_bytes(cache), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(line), flush=True)
    if not math.isfinite(ratio) or ratio > DECODE_BAND:
        raise AssertionError(f"gemma-2b: teacher-forced decode off forward by {ratio} of the largest logit")
    if generated.shape != (1, DECODE_TOKENS) or not bool(((generated >= 0) & (generated < cfg.vocab_size)).all()):
        raise AssertionError(f"gemma-2b: greedy decode gave {generated.shape} tokens out of range")


def run_lm_phases(torch, gram_kernel, card: str) -> dict:
    """The LM phases, with the Gram counters reset just before and read just after (the LM path launches none)."""
    if gram_kernel is not None:
        reset_counters(gram_kernel)
    t0 = time.perf_counter()
    phase_lm_reduced_parity(torch, card)
    model, params = phase_lm_gemma2b_train(torch, card)
    phase_lm_gemma2b_decode(torch, model, params, card)
    del params
    torch.cuda.empty_cache()
    launches = {n: getattr(gram_kernel, n) for n in COUNTERS} if gram_kernel is not None else {}
    print(json.dumps({"phase": "lm_wall_seconds", "card": card, "seconds": time.perf_counter() - t0,
                      "gram_launches": launches}), flush=True)
    if any(launches.values()):
        raise AssertionError(f"the LM phases launched a Gram kernel: {launches}")
    return launches


def timed(fn) -> float:
    """Host seconds of one call (the call returns host arrays, so the device has finished)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run_merge_phases(torch, np, gram_kernel, BPMFEngine, subset_merge, ml: dict, heldout, seq_rmse: float,
                     mp: dict, card: str) -> dict:
    """The ML20M ``posterior_merge`` phases, then the gang's merge held to this one bit for bit."""
    t_merge = time.perf_counter()
    baseline = subset_merge.column_mean_rmse(ml["coo"], ml["cfg"].run.test_fraction, ml["cfg"].run.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-merge-") as tmp_name:
        merge = phase_merge(torch, gram_kernel, BPMFEngine, ml, Path(tmp_name))
        phase_graph_sweeps(torch, merge["engine"], merge, f"posterior_merge P={MERGE_PARTITIONS}", card)
        phase_checkpoint(torch, np, gram_kernel, merge["engine"], merge, "merge_checkpoint", card)
        phase_merge_export(torch, np, merge["engine"], heldout, seq_rmse, baseline, Path(tmp_name), card,
                           subset_merge.MERGE_DEGRADATION_MAX)
        phase_multiproc_merge(np, merge["engine"], mp, Path(tmp_name) / "merge_artifact", card)
    phase_merge_buckets(torch, gram_kernel, merge["engine"])
    merge["seconds"] = time.perf_counter() - t_merge
    return merge


def main() -> int:
    if len(sys.argv) in (7, 8) and sys.argv[1] == "--mp-worker":  # one process of multiproc_ring's gang
        return mp_worker(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), *sys.argv[6:])
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "bpmf_gram.cu").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--lm-only"]:  # the LM phases alone, with no result line
        sys.path.insert(0, str(SRC))
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(f"card: {card}", flush=True)
        run_lm_phases(torch, None, card)
        return 0
    # a fresh, empty autotune cache for the whole run (the child processes inherit it)
    cold_cache = Path(tempfile.mkdtemp(prefix="chip_smoke-autotune-"))
    os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = str(cold_cache)
    try:
        return run_all(np, torch)
    finally:
        shutil.rmtree(cold_cache, ignore_errors=True)


def run_all(np, torch) -> int:
    """Every phase, in order (module docstring); the ``ok`` line last."""
    sys.path.insert(0, str(SRC))
    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
    from repro_torch.core import distributed as dist
    from repro_torch.core import subset_merge, sweep_graph
    from repro_torch.data.sparse import train_test_split
    from repro_torch.core.types import Bucket
    from repro_torch.data.synthetic import ML20M_LIKE, synthetic_ratings
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import bpmf_gram as gram_kernel
    from repro_torch.kernels.build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t_all = time.perf_counter()

    built = load_library("bpmf_gram")
    print(json.dumps({"phase": "build", "nvcc_seconds": built.seconds, "library": built.path.name,
                      "ptxas": ptxas_report(built.log)}), flush=True)

    phase_kernel_shapes(torch, gram_kernel)
    phase_fused_shapes(torch, np, gram_kernel, ops, Bucket)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp_name:
        tmp = Path(tmp_name)
        ml = phase_ml20m(torch, gram_kernel, (BPMFConfig, BPMFEngine, ML20M_LIKE, synthetic_ratings), tmp)
        phase_graph_sweeps(torch, ml["engine"], ml, "sequential", card)
        phase_checkpoint(torch, np, gram_kernel, ml["engine"], ml, "ml20m_checkpoint", card)
        phase_pipeline(torch, ml["engine"], card)
        phase_fused_one_shard(torch, gram_kernel, ops, ml["engine"])
        phase_requests(torch, np, ml["engine"])
        phase_serve(torch, np, gram_kernel, ml["engine"], tmp, card)
        phase_sharded_topk(torch, np, ml["engine"], card)
        # the held-out set and the sequential artifact's RMSE on it, at sweep 4
        _, heldout = train_test_split(ml["coo"], ml["cfg"].run.test_fraction, ml["cfg"].run.seed)
        seq_rmse = heldout_rmse(np, ml["engine"].predictor(), heldout)
        phase_profile(torch, ml["engine"], ml["steady_sweep_s"])
        seq_keys = sequential_keys(autotune, ml["engine"])
        del ml["engine"]
        torch.cuda.empty_cache()
        ring = phase_ring(torch, gram_kernel, BPMFEngine, dist, ml, tmp)
        ring_keys = phase_autotune_cold(autotune, seq_keys, ring["engine"], card)
        phase_graph_sweeps(torch, ring["engine"], ring, f"ring S={RING_SHARDS}", card, dist=dist)
        phase_checkpoint(torch, np, gram_kernel, ring["engine"], ring, "ring_checkpoint", card)
    phase_profile(torch, ring["engine"], ring["steady_sweep_s"], "profile_one_ring_sweep")
    fused = phase_ring_layouts(torch, gram_kernel, ring["engine"])
    mp_root = Path(tempfile.mkdtemp(prefix="chip_smoke-mp-"))
    try:
        mp = phase_multiproc(torch, np, ml, ring, mp_root, card)
        phase_multiproc_resume(torch, np, gram_kernel, ring["engine"], ring, mp, card)
        del ring["engine"]
        torch.cuda.empty_cache()
        merge = run_merge_phases(torch, np, gram_kernel, BPMFEngine, subset_merge, ml, heldout, seq_rmse, mp, card)
        phase_elastic(mp_root / "elastic", card)
        del merge["engine"]
        torch.cuda.empty_cache()
        t_tuned = time.perf_counter()
        tuned = phase_autotune_ring(torch, np, gram_kernel, autotune, ops, BPMFEngine, dist, ml, ring, fused,
                                    ring_keys, mp_root, card)
        tuned_s = time.perf_counter() - t_tuned
    finally:
        shutil.rmtree(mp_root, ignore_errors=True)
    del ml["coo"]
    torch.cuda.empty_cache()
    t_small = time.perf_counter()
    phase_small_task(np, gram_kernel, BPMFConfig, BPMFEngine, load_dataset, subset_merge, train_test_split)
    print(json.dumps({"phase": "merge_wall_seconds", "ml20m_merge_phases": merge["seconds"],
                      "small_task_with_merges": time.perf_counter() - t_small}), flush=True)

    t_bench = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-bench-") as bench_tmp:
        bench = phase_bench_drivers(torch, gram_kernel, Path(bench_tmp), card)
        t_examples = time.perf_counter()
        examples = phase_examples(gram_kernel, Path(bench_tmp), card)
    print(json.dumps({"phase": "autotune_wall_seconds", "autotune_ring": tuned_s,
                      "bench_drivers": t_examples - t_bench,
                      "examples": time.perf_counter() - t_examples}), flush=True)
    lm_launches = run_lm_phases(torch, gram_kernel, card)

    phase_yardsticks(ml["gram"], fused)
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
        "library_ms": gram["bmm_contraction_only_ms"],
        "device_ms": gram["kernel_device_ms"],
        "reduce_launches": ml["reduce_launches"],
        "merge_launches": merge["launches"],
        "merge_reduce_launches": merge["reduce_launches"],
        "multiproc_merge_launches_per_rank": mp["merge_launches"],
        "autotune_ring_launches": tuned["launches"]["LAUNCHES"],
        "autotune_ring_per_bucket_launches": tuned["per_bucket_launches"]["LAUNCHES"],
        "bench_driver_launches": {n: c["LAUNCHES"] for n, c in bench.items()},
        "example_launches": {n: c["LAUNCHES"] for n, c in examples.items()},
        "lm_phase_launches": lm_launches["LAUNCHES"],
        "note": f"launches: the 4 replays of the captured sweep and the capture's eager warm-up sweep; "
                f"ms, plain_ms, bound_ms and library_ms cover the {gram['launches']} launches of one "
                "ML20M sweep (and their second passes); ms times single calls, device_ms runs of "
                "back-to-back calls; no single PyTorch call computes the masked gather + Gram, so "
                "library_ms is torch.bmm on each bucket's pre-gathered block, contraction only "
                "(the gather not charged)",
    }, {
        "name": "bpmf_gram_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bpmf_gram.cu",
        "replaces": "src/repro/kernels/bpmf_gram.py:245",
        "launches": ring["launches"],
        "max_abs_err": fused["max_abs_err"],
        "ms": fused["kernel_ms"],
        "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"],
        "bound_by": fused["bound_by"],
        "library_ms": fused["bmm_contraction_only_ms"],
        "device_ms": fused["kernel_device_ms"],
        "reduce_launches": ring["reduce_launches"],
        "multiproc_ring_launches_per_rank": mp["ring_launches"],
        "autotune_ring_launches": tuned["launches"]["FUSED_LAUNCHES"],
        "autotune_ring_steps_by_decision": tuned["steps_by_decision"],
        "bench_driver_launches": {n: c["FUSED_LAUNCHES"] for n, c in bench.items()},
        "example_launches": {n: c["FUSED_LAUNCHES"] for n, c in examples.items()},
        "lm_phase_launches": lm_launches["FUSED_LAUNCHES"],
        "note": f"launches: the 4 replays of the captured sweep and the capture's eager warm-up sweep; "
                f"ms, plain_ms, bound_ms and library_ms cover the {fused['launches']} launches of one "
                f"ML20M sweep of the {RING_SHARDS}-shard ring (and their second passes), from zero sums; "
                "ms times single calls, device_ms runs of back-to-back calls; "
                "no single PyTorch call computes the gather + Gram + per-item accumulation, so "
                "library_ms is torch.bmm on each layout's pre-gathered chunks, contraction only",
    }]}
    print(f"total seconds: {time.perf_counter() - t_all:.1f}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
