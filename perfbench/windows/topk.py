"""Window ``topk``: a recommender's batch job, every user's top-k list from a posterior artifact.

Set-up draws a posterior at the configuration's shapes from the seed on the
run's device (``torch.Generator``: the posterior-mean factors and
``kept_samples`` per-sweep samples, normal with ``factor_std``), writes it
as a serving artifact into a temporary directory under ``TMPDIR``, loads it
with ``PosteriorPredictor.load`` and removes the directory. The users, in
one seeded permutation, go to ``PosteriorPredictor.top_k`` ``batch_users``
at a time in a closed loop, pass after pass, until ``--seconds`` have
passed; a user counts when its list has come back to the host. Set-up
warms up both batch shapes of a pass (the full batch and the remainder).
A traced run profiles ``trace_calls`` calls instead.

The comparison draws ``check_calls`` of the window's calls from the seed,
and the last one, and holds each list to the float64 scores of the same
factors (:mod:`perfbench.reference.topk`).

Traffic parameters: ``batch_users``, ``k``, ``factor_std``,
``mean_rating``, ``rating_range``, ``kept_samples``, ``mean_samples``,
``tie_margin``, ``check_calls``, ``trace_calls``.
"""
from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from perfbench import bench
from perfbench import trace as tr
from perfbench.reference import topk as ref


def posterior(ctx: bench.Context) -> dict[str, torch.Tensor]:
    """The artifact's arrays, drawn from the seed on the run's device."""
    spec, t = ctx.cell.config["data"], ctx.cell.traffic
    K, keep = ctx.cell.config["model"]["K"], t["kept_samples"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    shapes = {"U_mean": (spec["num_users"], K), "V_mean": (spec["num_movies"], K),
              "U_samples": (keep, spec["num_users"], K), "V_samples": (keep, spec["num_movies"], K)}
    return {name: t["factor_std"] * torch.randn(shape, generator=gen, device=ctx.device)
            for name, shape in shapes.items()}


def start(ctx: bench.Context):
    """Set-up up to the window: ``(predictor, batches, the posterior-mean factors on the host)``."""
    from repro_torch.serve.artifact import ArtifactMeta, save_artifact
    from repro_torch.serve.predictor import PosteriorPredictor

    spec, t = ctx.cell.config["data"], ctx.cell.traffic
    arrays = {name: x.cpu().numpy() for name, x in posterior(ctx).items()}
    lo, hi = t["rating_range"]
    meta = ArtifactMeta(
        num_users=spec["num_users"], num_movies=spec["num_movies"], K=ctx.cell.config["model"]["K"],
        mean_rating=t["mean_rating"], min_rating=lo, max_rating=hi, num_mean_samples=t["mean_samples"],
        num_kept_samples=t["kept_samples"], backend="sequential", num_sweeps_done=t["mean_samples"],
        seed=ctx.seed,
    )
    with tempfile.TemporaryDirectory(prefix="perfbench-artifact-") as d:
        save_artifact(d, meta, arrays)
        predictor = PosteriorPredictor.load(d, device=ctx.device)
    perm = np.random.default_rng(ctx.seed).permutation(spec["num_users"])
    B = t["batch_users"]
    batches = [perm[i:i + B] for i in range(0, len(perm), B)]
    for batch in {len(b): b for b in batches}.values():
        predictor.top_k(batch, t["k"])
    return predictor, batches, (arrays["U_mean"], arrays["V_mean"])


def compare(ctx: bench.Context, results, batches, factors, ranked=None) -> dict:
    """The numbers of :func:`perfbench.reference.topk.check`, worst over the checked calls.

    ``results`` holds ``(batch index, ids, scores)`` per call; ``ranked``
    replaces the program's lists with another ranking (the control's).
    """
    t = ctx.cell.traffic
    lo, hi = t["rating_range"]
    U = torch.from_numpy(factors[0]).to(ctx.device)
    V = torch.from_numpy(factors[1]).to(ctx.device)
    rng = np.random.default_rng(ctx.seed)
    picked = set(rng.choice(len(results), size=min(t["check_calls"], len(results)), replace=False).tolist())
    picked.add(len(results) - 1)
    worst: dict[str, float] = {}
    for i in sorted(picked):
        b, ids, vals = results[i]
        users = torch.from_numpy(np.asarray(batches[b], np.int64)).to(ctx.device)
        if ranked is not None:
            ids, vals = ranked(U[users], V)
        got = ref.check(torch.as_tensor(ids).to(ctx.device), torch.as_tensor(vals).to(ctx.device),
                        U[users], V, t["mean_rating"], lo, hi, t["tie_margin"])
        worst = {name: max(value, worst.get(name, -np.inf)) for name, value in got.items()}
    return worst


def run(ctx: bench.Context) -> bench.Run:
    t = ctx.cell.traffic
    predictor, batches, factors = start(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t0

    results, users = [], 0

    def call() -> None:
        nonlocal users
        b = len(results) % len(batches)
        ids, vals = predictor.top_k(batches[b], t["k"])
        results.append((b, ids, vals))
        users += len(batches[b])

    trace = None
    if ctx.trace:
        with tr.traced(ctx.device) as held:
            t_w = time.perf_counter()
            for _ in range(t["trace_calls"]):
                with tr.span("top-k call"):
                    call()
            window_s = time.perf_counter() - t_w
        trace = held[0]
    else:
        t_w = time.perf_counter()
        while True:
            call()
            window_s = time.perf_counter() - t_w
            if window_s >= ctx.seconds:
                break
    failed = sum(1 for b, ids, _ in results if np.shape(ids) != (len(batches[b]), t["k"]))
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    spec = ctx.cell.config["data"]
    shapes = {"num_users": spec["num_users"], "num_movies": spec["num_movies"], "K": ctx.cell.config["model"]["K"]}
    program = {"predictor": predictor}

    def finish() -> dict:
        nonlocal predictor
        program.clear()
        predictor = None
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return compare(ctx, results, batches, factors)

    return bench.Run(
        kind="topk", setup_s=setup_s, window_s=window_s, counts={"users": users, "calls": len(results)},
        attempted=users, failed=failed, peak_bytes=peak, shapes=shapes, program=program, trace=trace,
        device_kind=torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        finish=finish,
    )
