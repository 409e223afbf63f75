"""Window ``gibbs``: the engine's Gibbs sweeps, in blocks, as a fit runs them.

Set-up makes the ratings from the seed (:mod:`perfbench.datagen`), hands
them to ``BPMFEngine.prepare`` (split, centring, bucketing or the ring's
partition, upload), and draws the first ``checked_sweeps`` sweeps through
``BPMFEngine.sample()``: on the card the first block captures the sweep as a
CUDA graph and every block replays it, these included. What those sweeps
produced is copied to the host; then the window runs whole blocks through
the same iterator until ``--seconds`` have passed. A sweep counts when its
block's metrics have been read back; ``sweep_ms`` is the window's wall
time over its sweeps. A traced run profiles ``trace_blocks`` blocks
instead, with the engine's block dispatch and metrics read as host spans.

The comparison follows the chain from the seed, as a training check
follows the first steps: the reference (:mod:`perfbench.reference.bpmf`)
rebuilds the split and centring from the ratings and draws the same
``checked_sweeps`` sweeps in float64, and the program's factors,
hyper-parameters and per-sweep test RMSEs after them are held to it.

Traffic parameters: ``backend``, ``num_shards``, ``sweeps_per_block``,
``pipeline_blocks``, ``checked_sweeps`` (a whole number of blocks),
``burn_in``, ``test_fraction``, ``keep_factor_samples``, ``trace_blocks``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import bench, datagen
from perfbench import trace as tr
from perfbench.reference import bpmf as ref

# the engine's schedule never ends inside a run
NUM_SWEEPS = 1 << 30


def engine_config(cell: bench.Cell, seed: int):
    from repro_torch.bpmf import BPMFConfig

    m, t = cell.config["model"], cell.traffic
    dtype = getattr(torch, m["dtype"])
    return BPMFConfig().replace(
        K=m["K"], alpha=m["alpha"], beta0=m["beta0"], sample_dtype=dtype, compute_dtype=dtype,
        num_sweeps=NUM_SWEEPS, burn_in=t["burn_in"], seed=seed,
        sweeps_per_block=t["sweeps_per_block"], pipeline_blocks=t["pipeline_blocks"],
        test_fraction=t["test_fraction"], keep_factor_samples=t["keep_factor_samples"],
        name=t["backend"], num_shards=t["num_shards"],
    )


def start(ctx: bench.Context):
    """Set-up up to the window: ``(ratings, engine, sweep iterator, the checked sweeps' outputs)``."""
    from repro_torch.bpmf import BPMFEngine
    from repro_torch.data.sparse import RatingsCOO

    spec = ctx.cell.config["data"]
    ratings = datagen.ratings(spec, ctx.seed)
    engine = BPMFEngine(engine_config(ctx.cell, ctx.seed), device=ctx.device)
    engine.prepare(RatingsCOO(*ratings, spec["num_users"], spec["num_movies"]))
    sweeps = iter(engine.sample())
    n = ctx.cell.traffic["checked_sweeps"]
    for _ in range(n):
        next(sweeps)
    U, V = engine.factors()
    state = engine.state
    out = {"U": U, "V": V}
    for side in ("U", "V"):
        hyper = getattr(state, f"hyper_{side}")
        out[f"mu_{side}"] = hyper.mu.detach().cpu().numpy()
        out[f"Lam_{side}"] = hyper.Lam.detach().cpu().numpy()
    out["rmse"] = np.asarray([(m.rmse_sample, m.rmse_avg) for m in engine.history[:n]], np.float64)
    out["sweep"] = np.asarray([m.sweep for m in engine.history[:n]], np.float64)
    return ratings, engine, sweeps, out


def reference(ctx: bench.Context, ratings, prec: ref.Precision = ref.REFERENCE) -> dict:
    """The reference's first ``checked_sweeps`` sweeps from the seed, on the run's device."""
    spec, model, t = ctx.cell.config["data"], ctx.cell.config["model"], ctx.cell.traffic
    data = ref.build(*ratings, spec["num_users"], spec["num_movies"], t["test_fraction"], ctx.seed, ctx.device)
    return ref.run(ctx.seed, data, model["K"], model["alpha"], model["beta0"], t["burn_in"],
                   t["checked_sweeps"], prec)


def _gap(prog, want) -> float:
    """The largest entrywise gap, over the reference's largest entry."""
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    prog = prog.detach().cpu().numpy() if torch.is_tensor(prog) else np.asarray(prog)
    scale = float(np.max(np.abs(want)))
    return float(np.max(np.abs(prog.astype(np.float64) - want.astype(np.float64)))) / max(scale, 1e-30)


def compare(prog: dict, want: dict) -> dict:
    """The numbers held to their limits, program (or control) against the reference."""
    index = np.arange(1, len(want["rmse"]) + 1)
    return {
        "factor_gap": max(_gap(prog["U"], want["U"]), _gap(prog["V"], want["V"])),
        "hyper_gap": max(_gap(prog[k], want[k]) for k in ("mu_U", "Lam_U", "mu_V", "Lam_V")),
        "rmse_gap": float(np.max(np.abs(prog["rmse"] - want["rmse"]) / want["rmse"])),
        # the control has no sweep counter of its own
        "sweep_index_errors": float(np.sum(prog.get("sweep", index) != index)),
    }


def _spanned(fn, label: str):
    def call(*args, **kwargs):
        with tr.span(label):
            return fn(*args, **kwargs)
    return call


def run(ctx: bench.Context) -> bench.Run:
    t = ctx.cell.traffic
    block = t["sweeps_per_block"]
    ratings, engine, sweeps, prog = start(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    def blocks(n: int) -> int:
        for _ in range(n * block):
            next(sweeps)
        return n * block

    done, trace = 0, None
    if ctx.trace:
        for name, label in (("_dispatch", "block dispatch"), ("_drain_one", "metrics read")):
            setattr(engine, name, _spanned(getattr(engine, name), label))
        with tr.traced(ctx.device) as held:
            t_w = time.perf_counter()
            done = blocks(t["trace_blocks"])
            window_s = time.perf_counter() - t_w
        trace = held[0]
    else:
        t_w = time.perf_counter()
        while True:
            done += blocks(1)
            window_s = time.perf_counter() - t_w
            if window_s >= ctx.seconds:
                break
    window = engine.history[-done:]
    failed = sum(1 for m in window if not (np.isfinite(m.rmse_sample) and np.isfinite(m.rmse_avg)))
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    spec, K = ctx.cell.config["data"], ctx.cell.config["model"]["K"]
    shapes = {"num_users": spec["num_users"], "num_movies": spec["num_movies"], "K": K}
    if ctx.trace:
        nnz = len(ratings[0])
        n_test = int(ref.held_out(nnz, t["test_fraction"], ctx.seed).sum())
        shapes.update(n_test=n_test, n_train=nnz - n_test)
    program = {"engine": engine}

    def finish() -> dict:
        # the program's state goes before the reference takes the card
        program.clear()
        nonlocal engine, sweeps
        engine = sweeps = None
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return compare(prog, reference(ctx, ratings))

    return bench.Run(
        kind="gibbs", setup_s=setup_s, window_s=window_s, counts={"sweeps": done},
        attempted=done, failed=failed, peak_bytes=peak, shapes=shapes, program=program,
        trace=trace, device_kind=torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        finish=finish,
    )
