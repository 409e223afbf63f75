"""Plain catalog ranking, the reference of a batch top-k.

A user's score for an item is ``u . v + mean``, clipped to the rating range;
a top-k list holds the k best items, best first, ties to the lower item id.
Scores clipped at either end of the range tie exactly, and often do in a
large catalog, so the order among them is part of the answer.

:func:`check` judges a program's lists against the float64 scores:

* ``topk_score_gap``: the most by which the item at some position scores
  below the reference's item of that position;
* ``topk_value_gap``: the most by which a returned score differs from the
  reference's score of the returned item;
* ``topk_order_errors``: ids out of range or repeated in a list, and items
  of a tie group out of place: of the items whose unclipped score lies at
  least ``margin`` beyond an end of the range (so that both sides clip
  them), a list must hold the lowest ids, in increasing order. Items
  nearer the ends than ``margin`` may clip on one side and not the other;
  the score gap holds those.
"""
from __future__ import annotations

import torch

from perfbench.reference.bpmf import Precision


def scores(U: torch.Tensor, V: torch.Tensor, mean: float, prec: Precision) -> torch.Tensor:
    """Unclipped ``[B, N]`` scores of the users ``U`` against the catalog ``V``."""
    return prec.mm(U, V.T) + mean


def rank(U: torch.Tensor, V: torch.Tensor, mean: float, lo: float, hi: float, k: int,
         prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids, scores)`` of each user's top ``k``: the control, when ``prec`` is below the program's."""
    vals, ids = torch.sort(scores(U, V, mean, prec).clamp(lo, hi), dim=1, descending=True, stable=True)
    return ids[:, :k], vals[:, :k]


def check(ids: torch.Tensor, vals: torch.Tensor, U: torch.Tensor, V: torch.Tensor, mean: float,
          lo: float, hi: float, margin: float) -> dict:
    """The numbers of the module docstring for one batch of lists (float64 reference)."""
    prec = Precision(torch.float64)
    raw = scores(U.to(torch.float64), V.to(torch.float64), mean, prec)
    clipped = raw.clamp(lo, hi)
    N = clipped.shape[1]
    k = ids.shape[1]
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < N)
    safe = torch.where(valid, ids, 0)
    got = clipped.gather(1, safe)
    best = torch.sort(clipped, dim=1, descending=True, stable=True)[0][:, :k]
    errors = int((~valid).sum())
    ordered = torch.sort(safe, dim=1)[0]
    errors += int(((ordered[:, 1:] == ordered[:, :-1]) & valid[:, 1:]).sum())
    for group in (raw >= hi + margin, raw <= lo - margin):
        rank_in_group = torch.cumsum(group.to(torch.int64), dim=1).gather(1, safe)
        listed = group.gather(1, safe) & valid
        position = torch.cumsum(listed.to(torch.int64), dim=1)
        errors += int((listed & (rank_in_group != position)).sum())
    return {
        "topk_score_gap": float((best - got).max()),
        "topk_value_gap": float((vals.to(torch.float64) - got).abs().max()),
        "topk_order_errors": float(errors),
    }
