"""Single-device BPMF Gibbs sweep (paper Algorithm 1).

Order per sweep (exactly Algorithm 1):
  1. sample movie hyper-parameters from V
  2. resample every movie from (U, R)
  3. sample user hyper-parameters from U
  4. resample every user from (new V, R)
  5. predict test points, update RMSE

A sweep issues device work only: the sweep index and the sample counts
are device counters, the burn-in gate is the device predicate
``sweep > burn_in``, and each sweep's metrics stay on the device. The
eager block here is a Python loop (the JAX package's ``lax.scan``); on a
GPU the backends capture one sweep as a CUDA graph and replay it
(:mod:`repro_torch.core.sweep_graph`), the counterpart of ``jax.jit``. A
block returns one ``[block, 4]`` tensor of metric rows for a single read
by the caller: ``(rmse_sample, rmse_avg, sweep, bad)``, where ``bad`` is
1.0 for a sweep whose hyper-parameter draw is not finite
(:func:`repro_torch.core.hyper.hyper_ok`) and 0.0 otherwise.

Each sweep marks its phases for the phase clock (:mod:`repro_torch.trace`):
``hyper``, then per bucket ``gram``, ``solve``, ``noise``, ``solve``
(:mod:`repro_torch.core.posterior`), for each side, then ``predict`` and
``accum``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.core import posterior, prng
from repro_torch.core.hyper import hyper_ok, sample_hyper
from repro_torch.core.prediction import (
    PredictionState,
    update_posterior_accum,
    update_predictions,
)
from repro_torch.core.types import (
    BPMFConfig,
    BPMFData,
    BPMFState,
    HyperParams,
    NormalWishartPrior,
    PosteriorAccum,
    counter,
)


class SweepMetrics(NamedTuple):
    rmse_sample: float
    rmse_avg: float
    sweep: float


def metrics_row(r_sample: torch.Tensor, r_avg: torch.Tensor, sweep: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """One sweep's ``[4]`` float32 row ``(rmse_sample, rmse_avg, sweep, bad)``, on the device."""
    return torch.stack([r_sample, r_avg, sweep.to(torch.float32), (~ok).to(torch.float32)])


def init_rows(key: torch.Tensor, ids: torch.Tensor, K: int) -> torch.Tensor:
    """Per-item prior-predictive rows ``0.1 * N(0, I_K)``, keyed by item id."""
    return 0.1 * prng.normal(prng.fold_in(key, ids), (K,))


def init_state(key: torch.Tensor, num_users: int, num_movies: int, cfg: BPMFConfig) -> BPMFState:
    """Draw U, V from the prior predictive (standard normal scaled)."""
    ku, kv = prng.split(key)
    dev = key.device
    dt = cfg.sample_dtype
    return BPMFState(
        U=init_rows(ku, torch.arange(num_users, device=dev), cfg.K).to(dt),
        V=init_rows(kv, torch.arange(num_movies, device=dev), cfg.K).to(dt),
        hyper_U=HyperParams.init(cfg.K, dt, dev),
        hyper_V=HyperParams.init(cfg.K, dt, dev),
        sweep=counter(0, dev),
    )


def sweep_keys(key: torch.Tensor, sweep: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Deterministic per-sweep keys: (hyper_V, movies, hyper_U, users), from the device counter."""
    k = prng.fold_in(key, sweep)
    return tuple(prng.fold_in(k, i) for i in range(4))


def _sweep_body(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    data: BPMFData,
    cfg: BPMFConfig,
    prior: NormalWishartPrior | None = None,
) -> tuple[BPMFState, PredictionState, torch.Tensor]:
    """One Gibbs sweep; returns the metrics row (:func:`metrics_row`) on the device.

    ``prior`` is ``cfg.prior(device)``, built here when not given (the
    backends build it once).
    """
    trace.phase("hyper")
    prior = cfg.prior(key.device) if prior is None else prior
    k_hv, k_v, k_hu, k_u = sweep_keys(key, state.sweep)

    # movies given users
    hyper_V = sample_hyper(k_hv, state.V, prior)
    V = posterior.update_side(
        k_v, state.V, state.U, data.movies, hyper_V, cfg.alpha,
        cfg.compute_dtype, cfg.gram_impl,
    )
    # users given (updated) movies
    trace.phase("hyper")
    hyper_U = sample_hyper(k_hu, state.U, prior)
    U = posterior.update_side(
        k_u, state.U, V, data.users, hyper_U, cfg.alpha,
        cfg.compute_dtype, cfg.gram_impl,
    )

    trace.phase("predict")
    sweep = state.sweep + 1
    new_state = BPMFState(U=U, V=V, hyper_U=hyper_U, hyper_V=hyper_V, sweep=sweep)
    pred_state, r_sample, r_avg = update_predictions(
        pred_state, U, V, data, burned_in=sweep > cfg.burn_in
    )
    row = metrics_row(r_sample, r_avg, sweep, hyper_ok(hyper_U, hyper_V))
    return new_state, pred_state, row


def sweep_step(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    accum: PosteriorAccum,
    data: BPMFData,
    cfg: BPMFConfig,
    prior: NormalWishartPrior | None = None,
) -> tuple[BPMFState, PredictionState, PosteriorAccum, torch.Tensor]:
    """One sweep of a block: :func:`_sweep_body`, then the posterior accumulator (in place).

    The unit that the sequential backend captures as a CUDA graph.
    """
    with trace.sweep():
        state, pred_state, row = _sweep_body(key, state, pred_state, data, cfg, prior)
        trace.phase("accum")
        accum = update_posterior_accum(accum, state.U, state.V, state.sweep > cfg.burn_in)
    return state, pred_state, accum, row


def gibbs_sweep(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    data: BPMFData,
    cfg: BPMFConfig,
) -> tuple[BPMFState, PredictionState, SweepMetrics]:
    """One Gibbs sweep and its metrics on the host (the JAX package's per-sweep entry point).

    The sweep of :func:`gibbs_sweep_block` without the posterior
    accumulator: the same state, predictions and metrics, bit for bit.
    """
    with trace.sweep():
        state, pred_state, row = _sweep_body(key, state, pred_state, data, cfg)
    return state, pred_state, SweepMetrics(*map(float, row[:3].cpu().numpy()))


def gibbs_sweep_block(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    accum: PosteriorAccum,
    data: BPMFData,
    cfg: BPMFConfig,
    block_size: int,
    prior: NormalWishartPrior | None = None,
) -> tuple[BPMFState, PredictionState, PosteriorAccum, torch.Tensor]:
    """``block_size`` Gibbs sweeps, issued one op at a time, with no read back to the host.

    Per-sweep randomness is keyed by the device counter ``state.sweep``, so
    any partition of a run into blocks draws the same samples. ``accum`` is
    updated in place. This is the CPU path, and on a GPU the comparison
    for the captured block (:mod:`repro_torch.core.sweep_graph`).

    Returns:
        ``(state, pred_state, accum, metrics)`` with ``metrics`` a
        ``[block_size, 4]`` float32 device tensor of per-sweep rows
        (:func:`metrics_row`).
    """
    prior = cfg.prior(key.device) if prior is None else prior
    rows = []
    for _ in range(block_size):
        state, pred_state, accum, row = sweep_step(key, state, pred_state, accum, data, cfg, prior)
        rows.append(row)
    return state, pred_state, accum, torch.stack(rows)


def run(
    key: torch.Tensor,
    data: BPMFData,
    cfg: BPMFConfig,
    callback=None,
) -> tuple[BPMFState, PredictionState, list[SweepMetrics]]:
    """Deprecated entry point; prefer ``repro_torch.bpmf.BPMFEngine``.

    ``cfg.num_sweeps`` sweeps on ``data`` (already on its device) through
    :func:`repro_torch.bpmf.backends.run_sequential_prepared`, the JAX
    package's legacy loop; ``callback(state, metrics)`` after each.
    """
    from repro_torch.bpmf.backends import run_sequential_prepared

    return run_sequential_prepared(key, data, cfg, callback)
