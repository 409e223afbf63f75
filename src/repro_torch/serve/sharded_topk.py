"""The exact host merge of per-shard top-k candidates, and its tie rule.

Only :func:`merge_topk` is ported: the predictor orders ``top_k`` by its
rule (score descending, item id ascending), and the tests hold the order
to it. Scanning an item-sharded catalog on several cards waits for
multi-process serving (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np


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
