"""``PosteriorPredictor`` — posterior-mean serving on one device.

Answers rating queries from an engine's posterior summary without touching
the sampler:

* :meth:`PosteriorPredictor.predict` — batched ``(user, movie)`` point
  predictions from the posterior-mean factors, optionally with the
  predictive std over the retained per-sweep samples;
* :meth:`PosteriorPredictor.top_k` — per-user catalog scoring + top-k.

The factors are small next to query traffic, so they sit whole on one
device. Ties in ``top_k`` are ordered by (score descending, item id
ascending), the rule ``repro.serve.sharded_topk.merge_topk`` documents;
``torch.topk`` promises no order among ties, so the scores go through a
stable descending sort instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.artifact import ArtifactMeta


class PosteriorPredictor:
    """Answer rating queries from a BPMF posterior summary."""

    def __init__(self, meta: ArtifactMeta, arrays: dict[str, np.ndarray], device: torch.device | str):
        """Place the posterior summary on ``device``.

        Args:
            meta: Shapes, clip range and mean rating.
            arrays: ``U_mean``/``V_mean``/``U_samples``/``V_samples`` host
                arrays in the shapes ``meta`` promises.
            device: Where the factors live and queries are scored.
        """
        self.meta = meta
        self.device = torch.device(device)

        def put(name: str) -> torch.Tensor:
            return torch.from_numpy(np.asarray(arrays[name], np.float32)).to(self.device)

        self._U, self._V = put("U_mean"), put("V_mean")
        self._Us, self._Vs = put("U_samples"), put("V_samples")
        self._mean = torch.tensor(meta.mean_rating, dtype=torch.float32, device=self.device)

    @classmethod
    def from_engine(cls, engine) -> "PosteriorPredictor":
        """A predictor over a live engine's current posterior summary, on its device."""
        meta, arrays = engine._artifact_payload()
        return cls(meta, arrays, engine.device)

    @property
    def num_kept_samples(self) -> int:
        """Retained per-sweep factor samples (0 disables predictive std)."""
        return int(self._Us.shape[0])

    def _queries(self, ids, limit: int, what: str) -> torch.Tensor:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= limit):
            raise ValueError(
                f"{what} ids must be in [0, {limit}), got range [{ids.min()}, {ids.max()}]"
            )
        return torch.from_numpy(ids).to(self.device)

    def predict(self, rows, cols, return_std: bool = False):
        """Batched point predictions for ``(user, movie)`` pairs.

        Returns:
            ``[B]`` float32 predictions clipped to the training range, or
            ``(preds, std)`` when ``return_std``.

        Raises:
            ValueError: Mismatched batch shapes, out-of-range ids, or
                ``return_std`` with no retained samples.
        """
        r = self._queries(rows, self.meta.num_users, "user")
        c = self._queries(cols, self.meta.num_movies, "movie")
        if r.shape != c.shape:
            raise ValueError(f"rows/cols batch mismatch: {tuple(r.shape)} vs {tuple(c.shape)}")
        if return_std and self.num_kept_samples == 0:
            raise ValueError(
                "predictive std needs retained factor samples; this posterior has "
                "num_kept_samples=0 (RunConfig.keep_factor_samples)"
            )
        lo, hi = self.meta.min_rating, self.meta.max_rating
        preds = ((self._U[r] * self._V[c]).sum(-1) + self._mean).clamp(lo, hi)
        if not return_std:
            return preds.cpu().numpy()
        per_sample = torch.einsum("sbk,sbk->sb", self._Us[:, r], self._Vs[:, c]) + self._mean
        std = per_sample.clamp(lo, hi).std(dim=0, correction=0)
        return preds.cpu().numpy(), std.cpu().numpy()

    def top_k(self, user, k: int):
        """Highest-scoring movies for one user (or a batch of users).

        Returns:
            ``(ids, scores)`` — ``[k]`` arrays for a scalar ``user``, ``[B, k]``
            for a batch. Scores are clipped predicted ratings; ties go to the
            lower item id.

        Raises:
            ValueError: Out-of-range user ids or ``k < 1``.
        """
        if k < 1:
            raise ValueError(f"top_k needs k >= 1, got {k}")
        k = min(int(k), self.meta.num_movies)
        scalar = np.ndim(user) == 0
        users = self._queries(np.atleast_1d(np.asarray(user)), self.meta.num_users, "user")
        lo, hi = self.meta.min_rating, self.meta.max_rating
        scores = (self._U[users] @ self._V.T + self._mean).clamp(lo, hi)
        vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
        ids = ids[:, :k].to(torch.int32).cpu().numpy()
        vals = vals[:, :k].cpu().numpy()
        return (ids[0], vals[0]) if scalar else (ids, vals)
