"""Test-point prediction and RMSE tracking (paper Algorithm 1, last loop)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import BPMFData, PosteriorAccum, TestSet, _Movable, counter


@dataclasses.dataclass(frozen=True)
class PredictionState(_Movable):
    """Running posterior-mean predictions over post-burn-in samples."""

    sum_pred: torch.Tensor  # [T] accumulated clipped predictions
    num_samples: torch.Tensor  # 0-dim int32

    @staticmethod
    def init(num_test: int, device="cpu") -> "PredictionState":
        return PredictionState(
            sum_pred=torch.zeros(num_test, dtype=torch.float32, device=device),
            num_samples=counter(0, device),
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
    burned_in: torch.Tensor,
) -> tuple[PredictionState, torch.Tensor, torch.Tensor]:
    """Accumulate posterior mean after burn-in; return (state, rmse_sample, rmse_avg).

    ``burned_in`` is a 0-dim bool tensor on the device; the RMSEs stay
    there too (0-dim tensors). Nothing is read back here.
    """
    preds = predict(U, V, data.test, data.mean_rating, data.min_rating, data.max_rating)
    return accumulate_predictions(pred_state, preds, data.test.vals, burned_in)


def accumulate_predictions(
    pred_state: PredictionState, preds: torch.Tensor, vals: torch.Tensor, burned_in: torch.Tensor
) -> tuple[PredictionState, torch.Tensor, torch.Tensor]:
    """Fold one sample's test predictions into the running mean; (state, rmse_sample, rmse_avg).

    The reference's masked update (``repro.core.prediction``): the sample
    adds ``preds * inc`` with ``inc = burned_in`` as int32, which is the
    sample itself past burn-in and exact zeros before it.
    """
    r_sample = rmse(preds, vals)
    inc = burned_in.to(torch.int32)
    new_state = PredictionState(
        sum_pred=pred_state.sum_pred + preds * inc, num_samples=pred_state.num_samples + inc
    )
    n = new_state.num_samples.clamp_min(1).to(torch.float32)
    # before burn-in the average is empty; report the sample RMSE instead
    r_avg = torch.where(new_state.num_samples > 0, rmse(new_state.sum_pred / n, vals), r_sample)
    return new_state, r_sample, r_avg


def update_posterior_accum(
    accum: PosteriorAccum, U: torch.Tensor, V: torch.Tensor, burned_in: torch.Tensor
) -> PosteriorAccum:
    """Fold one sample into the posterior summary, in place on its tensors.

    ``burned_in`` is a 0-dim bool tensor on the device, the reference's
    traced predicate: the sums add ``x * 1.0`` past burn-in and ``x * 0.0``
    before it, and window slot ``count % keep`` takes the sample past
    burn-in (before it, slot 0 is rewritten with its own value). Updating
    in place keeps one copy of the ``[keep, M, K]`` window instead of two.
    """
    inc = burned_in.to(torch.int32)
    gate = inc.to(torch.float32)
    Uf = U.to(torch.float32)
    Vf = V.to(torch.float32)
    accum.U_sum.add_(Uf * gate)
    accum.V_sum.add_(Vf * gate)
    keep = accum.keep
    if keep > 0:  # keep == 0 keeps no window at all
        pos = torch.where(burned_in, accum.count % keep, 0).reshape(1).long()
        for window, x in ((accum.U_window, Uf), (accum.V_window, Vf)):
            row = torch.where(burned_in, x, window.index_select(0, pos)[0])
            window.index_copy_(0, pos, row[None])
    return dataclasses.replace(
        accum, count=accum.count + inc, filled=(accum.filled + inc).clamp_max(keep)
    )
