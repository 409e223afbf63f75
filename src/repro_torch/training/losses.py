"""Losses: LM cross-entropy (+ z-loss), chunked over the vocabulary head.

The counterpart of ``repro.training.losses``. Logits arrive fp32 (the head
widens them); the softmax cross-entropy uses the max-subtracted logsumexp,
so bf16 activations upstream cannot overflow it.

Over a mesh (``ctx``, the loss boundary's context) the logits are this
rank's block of the vocabulary (``vocab_axes``): the logsumexp's max and
sum, the label's logit and the argmax reduce over those axes, and the
masked sums over this rank's rows are summed over the loss batch's axes,
so every rank holds the whole batch's loss.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.collectives import all_reduce, all_reduce_max, gather_raw
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import NO_SHARDING, ShardingCtx

_SUMS = ("xent", "z", "correct", "tokens")


def _loss_sums(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               ctx: ShardingCtx = NO_SHARDING, vocab_axes: tuple[str, ...] = ()) -> dict:
    """Masked sums (not means) so chunks combine exactly; over ``vocab_axes`` the logits are a block."""
    labels = labels.long()
    if vocab_axes:
        group = ctx.group(vocab_axes)
        n = logits.shape[-1]
        offset = ctx.index(vocab_axes) * n
        shift = all_reduce_max(logits.amax(dim=-1), group)
        lse = shift + torch.log(all_reduce(torch.exp(logits - shift[..., None]).sum(dim=-1), group))
        local = labels - offset
        inside = (local >= 0) & (local < n)
        picked = all_reduce(logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0] * inside, group)
        # the first maximum of the whole row, as argmax gives it: the first block holding the row's max
        idx = logits.argmax(-1)
        best = gather_raw(logits.detach().gather(-1, idx[..., None])[None, ..., 0], 0, group)
        where = gather_raw((idx + offset)[None], 0, group)
        argmax = where.gather(0, best.argmax(0)[None])[0]
    else:
        lse = torch.logsumexp(logits, dim=-1)  # [B, L]
        picked = logits.gather(-1, labels[..., None])[..., 0]
        argmax = logits.argmax(-1)
    m = mask.float()
    return {
        "xent": torch.sum((lse - picked) * m),
        "z": torch.sum(torch.square(lse) * m),
        "correct": torch.sum((argmax == labels) * m),
        "tokens": torch.sum(m),
    }


def _finalize(sums: dict, z_weight: float, ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, dict]:
    if ctx.batch_axes:  # one sum of the four over the loss batch's shards
        total = all_reduce(torch.stack([sums[k].float() for k in _SUMS]), ctx.group(ctx.batch_axes))
        sums = dict(zip(_SUMS, total.unbind(0)))
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
    ctx: ShardingCtx = NO_SHARDING,
    vocab_axes: tuple[str, ...] = (),
) -> tuple[torch.Tensor, dict]:
    """Cross-entropy with the vocabulary head applied per sequence chunk.

    The full [B, L, V] logits tensor is never materialized: one [B, chunk,
    V] block is live at a time, and under autograd each block is a
    checkpoint whose logits the backward pass recomputes (one extra head
    matmul), as the reference's checkpointed scan body. With L <= chunk, or
    L not a multiple of chunk, the head runs once over the whole sequence.
    Over a mesh ``ctx`` is the loss boundary's context (``labels`` and
    ``mask`` its rows) and ``vocab_axes`` split the logits' vocabulary.
    """
    L = hidden.shape[1]
    if L <= chunk or L % chunk != 0:
        return _finalize(_loss_sums(head_fn(hidden), labels, mask, ctx, vocab_axes), z_weight, ctx)

    def block(h: torch.Tensor, lab: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, ...]:
        s = _loss_sums(head_fn(h), lab, m, ctx, vocab_axes)
        return tuple(s[k] for k in _SUMS)

    totals = None
    for i in range(0, L, chunk):
        args = (hidden[:, i : i + chunk], labels[:, i : i + chunk], mask[:, i : i + chunk])
        if torch.is_grad_enabled():
            sums = checkpoint(block, *args, use_reentrant=False)
        else:
            sums = block(*args)
        totals = sums if totals is None else tuple(a + b for a, b in zip(totals, sums))
    return _finalize(dict(zip(_SUMS, totals)), z_weight, ctx)


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
