"""Single-device BPMF Gibbs sweep (paper Algorithm 1).

Order per sweep (exactly Algorithm 1):
  1. sample movie hyper-parameters from V
  2. resample every movie from (U, R)
  3. sample user hyper-parameters from U
  4. resample every user from (new V, R)
  5. predict test points, update RMSE

A block of sweeps is a Python loop (the JAX package's ``lax.scan``); each
sweep's RMSEs stay on the device, and the block returns them as one
``[block, 3]`` tensor for a single read by the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import posterior, prng
from repro_torch.core.hyper import sample_hyper
from repro_torch.core.prediction import (
    PredictionState,
    update_posterior_accum,
    update_predictions,
)
from repro_torch.core.types import BPMFConfig, BPMFData, BPMFState, HyperParams, PosteriorAccum


class SweepMetrics(NamedTuple):
    rmse_sample: float
    rmse_avg: float
    sweep: float


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
        sweep=0,
    )


def sweep_keys(key: torch.Tensor, sweep: int) -> tuple[torch.Tensor, ...]:
    """Deterministic per-sweep keys: (hyper_V, movies, hyper_U, users)."""
    k = prng.fold_in(key, sweep)
    return tuple(prng.fold_in(k, i) for i in range(4))


def _sweep_body(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    data: BPMFData,
    cfg: BPMFConfig,
) -> tuple[BPMFState, PredictionState, torch.Tensor]:
    """One Gibbs sweep; returns the metrics row ``[rmse_sample, rmse_avg, sweep]`` on the device."""
    prior = cfg.prior(key.device)
    k_hv, k_v, k_hu, k_u = sweep_keys(key, state.sweep)

    # movies given users
    hyper_V = sample_hyper(k_hv, state.V, prior)
    V = posterior.update_side(
        k_v, state.V, state.U, data.movies, hyper_V, cfg.alpha,
        cfg.compute_dtype, cfg.gram_impl,
    )
    # users given (updated) movies
    hyper_U = sample_hyper(k_hu, state.U, prior)
    U = posterior.update_side(
        k_u, state.U, V, data.users, hyper_U, cfg.alpha,
        cfg.compute_dtype, cfg.gram_impl,
    )

    sweep = state.sweep + 1
    new_state = BPMFState(U=U, V=V, hyper_U=hyper_U, hyper_V=hyper_V, sweep=sweep)
    pred_state, r_sample, r_avg = update_predictions(
        pred_state, U, V, data, burned_in=sweep > cfg.burn_in
    )
    row = torch.stack([r_sample, r_avg, torch.tensor(float(sweep), device=r_sample.device)])
    return new_state, pred_state, row


def gibbs_sweep_block(
    key: torch.Tensor,
    state: BPMFState,
    pred_state: PredictionState,
    accum: PosteriorAccum,
    data: BPMFData,
    cfg: BPMFConfig,
    block_size: int,
) -> tuple[BPMFState, PredictionState, PosteriorAccum, torch.Tensor]:
    """``block_size`` Gibbs sweeps with no read back to the host.

    Per-sweep randomness is keyed by ``state.sweep``, so any partition of a
    run into blocks draws the same samples. ``accum`` is updated in place.

    Returns:
        ``(state, pred_state, accum, metrics)`` with ``metrics`` a
        ``[block_size, 3]`` float32 device tensor of per-sweep
        ``(rmse_sample, rmse_avg, sweep)`` rows.
    """
    rows = []
    for _ in range(block_size):
        state, pred_state, row = _sweep_body(key, state, pred_state, data, cfg)
        accum = update_posterior_accum(accum, state.U, state.V, state.sweep > cfg.burn_in)
        rows.append(row)
    return state, pred_state, accum, torch.stack(rows)
