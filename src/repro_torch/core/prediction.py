"""Test-point prediction and RMSE tracking (paper Algorithm 1, last loop)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import BPMFData, PosteriorAccum, TestSet, _Movable


@dataclasses.dataclass(frozen=True)
class PredictionState(_Movable):
    """Running posterior-mean predictions over post-burn-in samples."""

    sum_pred: torch.Tensor  # [T] accumulated clipped predictions
    num_samples: int

    @staticmethod
    def init(num_test: int, device="cpu") -> "PredictionState":
        return PredictionState(
            sum_pred=torch.zeros(num_test, dtype=torch.float32, device=device), num_samples=0
        )


def predict(U: torch.Tensor, V: torch.Tensor, test: TestSet, mean_rating: torch.Tensor,
            min_rating: float, max_rating: float) -> torch.Tensor:
    """Point predictions for the test triples from one posterior sample."""
    preds = (U[test.rows.long()] * V[test.cols.long()]).sum(dim=-1) + mean_rating
    return preds.clamp(min_rating, max_rating)


def rmse(preds: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((preds - vals) ** 2))


def update_predictions(
    pred_state: PredictionState,
    U: torch.Tensor,
    V: torch.Tensor,
    data: BPMFData,
    burned_in: bool,
) -> tuple[PredictionState, torch.Tensor, torch.Tensor]:
    """Accumulate posterior mean after burn-in; return (state, rmse_sample, rmse_avg).

    The RMSEs stay on the device (0-dim tensors); nothing is read back here.
    """
    preds = predict(U, V, data.test, data.mean_rating, data.min_rating, data.max_rating)
    return accumulate_predictions(pred_state, preds, data.test.vals, burned_in)


def accumulate_predictions(
    pred_state: PredictionState, preds: torch.Tensor, vals: torch.Tensor, burned_in: bool
) -> tuple[PredictionState, torch.Tensor, torch.Tensor]:
    """Fold one sample's test predictions into the running mean; (state, rmse_sample, rmse_avg)."""
    r_sample = rmse(preds, vals)
    if not burned_in:
        # before burn-in the average is empty; report the sample RMSE instead
        r_avg = r_sample if pred_state.num_samples == 0 else rmse(
            pred_state.sum_pred / pred_state.num_samples, vals
        )
        return pred_state, r_sample, r_avg
    new_state = PredictionState(
        sum_pred=pred_state.sum_pred + preds, num_samples=pred_state.num_samples + 1
    )
    r_avg = rmse(new_state.sum_pred / float(new_state.num_samples), vals)
    return new_state, r_sample, r_avg


def update_posterior_accum(
    accum: PosteriorAccum, U: torch.Tensor, V: torch.Tensor, burned_in: bool
) -> PosteriorAccum:
    """Fold one sample into the posterior summary, in place on its tensors.

    Past burn-in the sums grow by the float32 sample and the sample goes to
    window slot ``count % keep``; before it nothing changes. Updating in
    place keeps one copy of the ``[keep, M, K]`` window instead of two.
    """
    if not burned_in:
        return accum
    Uf = U.to(torch.float32)
    Vf = V.to(torch.float32)
    accum.U_sum.add_(Uf)
    accum.V_sum.add_(Vf)
    keep = accum.keep
    if keep > 0:
        accum.U_window[accum.count % keep].copy_(Uf)
        accum.V_window[accum.count % keep].copy_(Vf)
    return dataclasses.replace(
        accum, count=accum.count + 1, filled=min(accum.filled + 1, keep)
    )
