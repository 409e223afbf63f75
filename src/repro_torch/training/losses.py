"""Losses: LM cross-entropy (+ z-loss), chunked over the vocabulary head.

The counterpart of ``repro.training.losses``. Logits arrive fp32 (the head
widens them); the softmax cross-entropy uses the max-subtracted logsumexp,
so bf16 activations upstream cannot overflow it.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig

_SUMS = ("xent", "z", "correct", "tokens")


def _loss_sums(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> dict:
    """Masked sums (not means) so chunks combine exactly."""
    lse = torch.logsumexp(logits, dim=-1)  # [B, L]
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    m = mask.float()
    return {
        "xent": torch.sum((lse - picked) * m),
        "z": torch.sum(torch.square(lse) * m),
        "correct": torch.sum((logits.argmax(-1) == labels.long()) * m),
        "tokens": torch.sum(m),
    }


def _finalize(sums: dict, z_weight: float) -> tuple[torch.Tensor, dict]:
    denom = torch.clamp_min(sums["tokens"], 1.0)
    ce = sums["xent"] / denom
    z = sums["z"] / denom
    loss = ce + z_weight * z
    return loss, {"ce": ce, "z_loss": z, "accuracy": sums["correct"] / denom, "tokens": sums["tokens"]}


def lm_loss(
    logits: torch.Tensor,  # [B, L, V] fp32
    labels: torch.Tensor,  # [B, L] int32
    mask: torch.Tensor,  # [B, L] {0,1}: 1 = contributes to the loss
    z_weight: float = 1e-4,
) -> tuple[torch.Tensor, dict]:
    """Mean masked token cross-entropy + z-loss. Returns (loss, metrics)."""
    return _finalize(_loss_sums(logits, labels, mask), z_weight)


def chunked_lm_loss(
    head_fn: Callable[[torch.Tensor], torch.Tensor],  # hidden [B, Lc, D] -> logits [B, Lc, V] (fp32)
    hidden: torch.Tensor,  # [B, L, D] final-norm'd backbone output
    labels: torch.Tensor,
    mask: torch.Tensor,
    chunk: int = 512,
    z_weight: float = 1e-4,
) -> tuple[torch.Tensor, dict]:
    """Cross-entropy with the vocabulary head applied per sequence chunk.

    The full [B, L, V] logits tensor is never materialized: one [B, chunk,
    V] block is live at a time, and under autograd each block is a
    checkpoint whose logits the backward pass recomputes (one extra head
    matmul), as the reference's checkpointed scan body. With L <= chunk, or
    L not a multiple of chunk, the head runs once over the whole sequence.
    """
    L = hidden.shape[1]
    if L <= chunk or L % chunk != 0:
        return lm_loss(head_fn(hidden), labels, mask, z_weight)

    def block(h: torch.Tensor, lab: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, ...]:
        s = _loss_sums(head_fn(h), lab, m)
        return tuple(s[k] for k in _SUMS)

    totals = None
    for i in range(0, L, chunk):
        args = (hidden[:, i : i + chunk], labels[:, i : i + chunk], mask[:, i : i + chunk])
        if torch.is_grad_enabled():
            sums = checkpoint(block, *args, use_reentrant=False)
        else:
            sums = block(*args)
        totals = sums if totals is None else tuple(a + b for a, b in zip(totals, sums))
    return _finalize(dict(zip(_SUMS, totals)), z_weight)


def total_loss(
    cfg: ModelConfig,
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    moe_metrics: dict,
    z_weight: float = 1e-4,
) -> tuple[torch.Tensor, dict]:
    """Task loss + MoE auxiliaries over materialized logits (the small-vocab / test path).

    The train step uses the chunked head. The encoder (hubert) masked-
    prediction objective is the same cross-entropy restricted to corrupted
    positions; the data pipeline supplies that mask.
    """
    loss, metrics = lm_loss(logits, labels, mask, z_weight)
    if cfg.num_experts:
        loss = loss + cfg.router_aux_weight * moe_metrics["aux_loss"] + 1e-3 * moe_metrics["router_z"]
        metrics = {**metrics, **moe_metrics}
    metrics["loss"] = loss
    return loss, metrics
