"""Item-sharded catalog top-k: a top-k per item shard, then an exact host merge.

The replicated ``top_k`` scores the whole catalog on one device. This
module splits ``V`` along the item axis into S contiguous shards, each on
its serve device (shard i on card ``i % n``; with one card every shard
shares it), as the JAX package shards ``V`` over its ``("serve",)`` mesh:

1. each shard scores its ``ceil(M/S)`` item rows against the user batch
   with the predictor's fixed-order scoring, and keeps its own top
   ``k' = min(k, rows)`` (ties to the lower item id);
2. the ``[S, B, k']`` candidates go to the host, where :func:`merge_topk`
   picks the global top-k: scores descending, ties to the lower item id.

A shard holds at most ``k'`` of the global top-k and offers ``k'``
candidates, so the merge is exact. A shard with fewer than ``k'`` rows
pads its candidates with ``-inf`` scores and the id ``M``, which never
surface: at most ``M`` candidates are real and ``k <= M``. Because every
score is the same elementwise sum whatever the shard's size, the sharded
ids, scores and order are the replicated path's bit for bit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch


class ItemShard(NamedTuple):
    """One item shard: its first item id and its rows transposed, ``[K, rows]``, on its device."""

    offset: int
    Vt: torch.Tensor


def shard_items(V: torch.Tensor, devices: Sequence[torch.device]) -> list[ItemShard]:
    """Split ``V [M, K]`` along the item axis into ``len(devices)`` shards of ``ceil(M/S)`` rows.

    The last shards may be shorter, or empty when ``S > M``. Shard i is
    placed on ``devices[i]``, transposed so that each of its K rows is
    contiguous for the scan.
    """
    S = len(devices)
    M = V.shape[0]
    per = -(-M // S) if M else 0
    return [ItemShard(min(i * per, M), V[min(i * per, M):min((i + 1) * per, M)].T.contiguous().to(dev))
            for i, dev in enumerate(devices)]


def build_local_topk(
    shards: Sequence[ItemShard], num_items: int,
    score: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> Callable[..., tuple[np.ndarray, np.ndarray]]:
    """The per-shard scan: scores and a local top-k on each shard's device.

    Args:
        shards: :func:`shard_items` output.
        num_items: The catalog size ``M`` (the id of the padding candidates).
        score: ``score(u [B, K], Vt [K, m]) -> [B, m]`` dot products (the
            predictor's fixed-order ``_catalog_scores``).

    Returns:
        ``fn(u, mean, k, lo, hi) -> (ids, vals)``: host ``[S, B, k']``
        global item ids (int32) and clipped scores (float32) of each
        shard's top ``k' = min(k, largest shard)``, for users ``u [B, K]``.
    """
    widest = max(s.Vt.shape[1] for s in shards)

    def local_topk(u: torch.Tensor, mean: torch.Tensor, k: int, lo: float, hi: float):
        kl = min(k, widest)
        B = u.shape[0]
        ids = np.full((len(shards), B, kl), num_items, np.int32)
        vals = np.full((len(shards), B, kl), -np.inf, np.float32)
        for i, shard in enumerate(shards):
            dev = shard.Vt.device
            scores = (score(u.to(dev), shard.Vt) + mean.to(dev)).clamp(lo, hi)
            top_vals, top_ids = torch.sort(scores, dim=-1, descending=True, stable=True)
            m = min(kl, scores.shape[1])
            ids[i, :, :m] = (top_ids[:, :m] + shard.offset).to(torch.int32).cpu().numpy()
            vals[i, :, :m] = top_vals[:, :m].cpu().numpy()
        return ids, vals

    return local_topk


def merge_topk(cand_ids: np.ndarray, cand_vals: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side exact merge of per-shard top-k candidates.

    Args:
        cand_ids: ``[S, B, k']`` global item ids from the shards.
        cand_vals: ``[S, B, k']`` matching scores.
        k: Global top-k size (``<=`` the ``S * k'`` candidates).

    Returns:
        ``(ids [B, k], vals [B, k])``: scores descending, ties toward the
        lower item id (``jax.lax.top_k``'s order).
    """
    S, B, kl = cand_ids.shape
    ids = np.ascontiguousarray(np.transpose(cand_ids, (1, 0, 2))).reshape(B, S * kl)
    vals = np.ascontiguousarray(np.transpose(cand_vals, (1, 0, 2))).reshape(B, S * kl)
    # primary key: score descending; secondary: item id ascending
    order = np.lexsort((ids, -vals), axis=1)[:, :k]
    rows = np.arange(B)[:, None]
    return ids[rows, order].astype(np.int32), vals[rows, order]
