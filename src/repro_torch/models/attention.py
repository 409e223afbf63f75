"""Attention: GQA / MQA (kv=1) / SWA with dense and rolling KV caches, and MLA.

The counterpart of ``repro.models.attention``:

  * GQA with arbitrary q-per-kv grouping (yi, nemotron, chameleon, hubert
    with kv == heads), MQA as GQA with ``num_kv_heads == 1`` (gemma);
  * qk-norm (chameleon's query/key norm);
  * sliding-window attention with a rolling KV cache of ``window`` slots;
  * a dense path that materializes the ``[Lq, S]`` logits, and a flash-style
    two-level schedule (Q blocks outer, a running ``(m, l, acc)`` over KV
    blocks inner) for longer sequences, as the reference's ``_attend_flash``.

  * MLA (minicpm3): queries, keys and values rebuilt from a low-rank
    latent; the cache (:class:`MLACache`) holds only ``ckv`` (kv_lora) and
    the one shared RoPE key ``kpe`` (rope_dim) per token, un-normalised
    (``kv_norm`` is applied on read). Three paths, as the reference's:
    dense, *materialized* (K/V rebuilt once, then the flash schedule with
    ``dh = dn + dr`` and ``dv``; for Lq above the Q chunk) and *absorbed*
    (``w_uk`` folded into the query, attention in the latent space; decode
    against a long cache). The absorbed path is MQA in the latent space:
    one KV head whose key is ``[ckv_n | kpe]`` and whose value is
    ``ckv_n``, through the same flash schedule. The reference adds two
    float32 score products there; one product over the concatenated width
    sums the same terms in another order, inside float32 rounding.

Attention is computed in plain PyTorch matmuls, as the reference computes it
in einsums; no library attention kernel is called. The score and value
products take activation-dtype inputs and accumulate and return float32,
as the reference's ``preferred_element_type=f32``: bfloat16 products are
exact in float32, so on the CPU the inputs are widened and multiplied in
float32, and on the card the same product runs as a bfloat16 batched
matmul with a float32 output (``_NarrowBmmF32`` gives both their backward
pass). KV heads are never repeated: the G query
heads of one KV head share its keys through the batched product's shape
(``[B*KV, G*Lq, dh] @ [B*KV, dh, S]``), head ``h`` reading KV head
``h // G`` as the reference's ``jnp.repeat``.

Two behaviours are kept as the reference has them: a row whose keys are
all masked comes out uniform over its keys from the dense path (a finite
``NEG_INF``) and 0 from the flash path (the ``denom > 0`` guard).

Over a mesh (``ctx``) each rank computes the query heads its share of
``w_q`` gives it (``q_heads`` over ``model``), with the KV heads they read
(when ``kv_heads`` does not split, every rank computes all KV heads and
keeps those of its query heads), and ``w_o``'s partial sums are summed
over the heads' axes. With ``cfg.flash_q_parallel`` the flash schedule's
Q blocks are split over ``qblocks`` instead, every rank computing its
blocks for all heads, as the reference's sequence-parallel prefill. A cache
split along the sequence (``cache_seq``, ``SERVE_RULES``) holds this rank's
slots of every head: the new keys are written where they belong, and every
query head attends to this rank's slots, the per-shard softmax sums merged
over the sequence's axes (a max, then one sum of ``(l, o)``), the
flash-decoding form the reference's comment describes. MLA caches do the
same in the absorbed (latent) form.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.collectives import all_gather, all_reduce, all_reduce_max
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, apply_rope, rms_norm
from repro_torch.models.module import NO_SHARDING, PartitionSpec, ShardingCtx, desc, fan_in_desc

__all__ = [
    "NEG_INF",
    "KVCache",
    "MLACache",
    "init_kv_cache",
    "init_mla_cache",
    "desc_attention",
    "attention_mask",
    "rolling_slot_positions",
    "apply_attention",
    "apply_mla",
]

# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCache:
    """Dense or rolling KV cache.

    ``k``/``v``: [B, W, KV, hd]. For full attention W = max_len and slot i
    holds position i. For sliding-window attention W = window and slot i
    holds the latest position p < next_pos with p % W == i. A stack of
    caches (one per layer) has a leading layer dim on every field.
    """

    k: torch.Tensor
    v: torch.Tensor
    next_pos: torch.Tensor  # [] int32: tokens cached so far (same for the batch)
    rolling: bool = False

    @property
    def window(self) -> int:
        """Number of slots W."""
        return self.k.shape[1]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
                  device: str | torch.device = "cpu") -> KVCache:
    """A zero cache of ``min(window, max_len)`` slots (``max_len`` without a window)."""
    dt = dtype or cfg.dtype("act")
    window = cfg.sliding_window if cfg.sliding_window is not None else max_len
    shape = (batch, min(window, max_len), cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        next_pos=torch.zeros((), dtype=torch.int32, device=device),
        rolling=cfg.sliding_window is not None,
    )


@dataclasses.dataclass(frozen=True)
class MLACache:
    """Latent cache: per token only kv_lora + rope_dim values.

    ``ckv``: [B, S, kv_lora] (before ``kv_norm``), ``kpe``: [B, S, rope_dim]
    (after RoPE); slot i holds position i. A stack of caches has a leading
    layer dim on every field.
    """

    ckv: torch.Tensor
    kpe: torch.Tensor
    next_pos: torch.Tensor  # [] int32: tokens cached so far


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
                   device: str | torch.device = "cpu") -> MLACache:
    """A zero latent cache of ``max_len`` slots."""
    dt = dtype or cfg.dtype("act")
    return MLACache(
        ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
        kpe=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dt, device=device),
        next_pos=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def desc_attention(cfg: ModelConfig) -> dict:
    """Q, K, V, O projections (and the qk-norm scales) of one GQA layer, or the MLA layer's
    down/up projections, latent norms and output."""
    pd = cfg.dtype("param")
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        out = {
            "w_dkv": fan_in_desc((D, r_kv), ("embed", "latent"), D, pd),
            "w_kpe": fan_in_desc((D, dr), ("embed", "head_dim"), D, pd),
            "kv_norm": desc((r_kv,), ("latent",), init="ones", dtype=pd),
            "w_uk": fan_in_desc((r_kv, H, dn), ("latent", "q_heads", "head_dim"), r_kv, pd),
            "w_uv": fan_in_desc((r_kv, H, dv), ("latent", "q_heads", "head_dim"), r_kv, pd),
            "w_o": fan_in_desc((H, dv, D), ("q_heads", "head_dim", "embed"), H * dv, pd),
        }
        if r_q > 0:
            out["w_dq"] = fan_in_desc((D, r_q), ("embed", "latent"), D, pd)
            out["q_norm"] = desc((r_q,), ("latent",), init="ones", dtype=pd)
            out["w_uq"] = fan_in_desc((r_q, H, dn + dr), ("latent", "q_heads", "head_dim"), r_q, pd)
        else:
            out["w_q"] = fan_in_desc((D, H, dn + dr), ("embed", "q_heads", "head_dim"), D, pd)
        return out
    out = {
        "w_q": fan_in_desc((D, H, hd), ("embed", "q_heads", "head_dim"), D, pd),
        "w_k": fan_in_desc((D, KV, hd), ("embed", "kv_heads", "head_dim"), D, pd),
        "w_v": fan_in_desc((D, KV, hd), ("embed", "kv_heads", "head_dim"), D, pd),
        "w_o": fan_in_desc((H, hd, D), ("q_heads", "head_dim", "embed"), H * hd, pd),
    }
    if cfg.qk_norm:
        out["q_norm"] = desc((hd,), ("head_dim",), init="ones", dtype=pd)
        out["k_norm"] = desc((hd,), ("head_dim",), init="ones", dtype=pd)
    return out


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------


def attention_mask(
    q_pos: torch.Tensor,  # [Lq] int32 absolute positions of queries
    kv_pos: torch.Tensor,  # [S] int32 absolute positions of keys (-1 = invalid slot)
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Bool [Lq, S] (it broadcasts as such); True = attend."""
    m = kv_pos[None, :] >= 0  # [1, S] when neither causal nor windowed, as the reference's
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & (kv_pos[None, :] > q_pos[:, None] - window)
    return m


def rolling_slot_positions(next_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Absolute position held by each rolling-cache slot (-1 if empty).

    Slot i holds the largest p < next_pos with p % W == i.
    """
    i = torch.arange(window, dtype=torch.int32, device=next_pos.device)
    np_ = next_pos.to(torch.int32)
    cycles = torch.div(np_ - 1 - i, window, rounding_mode="floor")  # negative when slot unwritten
    pos = i + cycles * window
    return torch.where((np_ > 0) & (pos >= 0), pos, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _narrow_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of two bf16/fp16 operands, summed and returned in float32.

    A ``meta`` tensor (the dry run) takes the card's route.
    """
    if a.device.type in ("cuda", "meta"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())  # the narrow products are exact in float32


class _NarrowBmmF32(torch.autograd.Function):
    """:func:`_narrow_bmm` with its gradients.

    ``torch.bmm``'s float32-output overload has no derivative, so the
    backward pass is written here: the float32 cotangent is rounded to the
    operands' dtype and each gradient is again a narrow product summed in
    float32, then rounded to its operand's dtype. The same on both devices.
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _narrow_bmm(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return _narrow_bmm(g, b.mT).to(a.dtype), _narrow_bmm(a.mT, g).to(b.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with float32 accumulation and output: ``preferred_element_type=f32``."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    return _NarrowBmmF32.apply(a, b)


def _group_q(q: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, Lq, H, dh] -> [B*KV, G*Lq, dh]: the G query heads of each KV head, rows in (g, l) order."""
    B, Lq, H, dh = q.shape
    G = H // kv
    return q.reshape(B, Lq, kv, G, dh).permute(0, 2, 3, 1, 4).reshape(B * kv, G * Lq, dh)


def _ungroup(x: torch.Tensor, B: int, kv: int, Lq: int) -> torch.Tensor:
    """[B*KV, G*Lq, d] -> [B, H, Lq, d] (head h = kv_head * G + g)."""
    G = x.shape[1] // Lq
    return x.reshape(B, kv * G, Lq, x.shape[-1])


def _attend_dense(
    q: torch.Tensor,  # [B, Lq, H, dh]
    k: torch.Tensor,  # [B, S, KV, dh]
    v: torch.Tensor,  # [B, S, KV, dv]
    mask: torch.Tensor,  # [Lq, S] bool
    scale: float,
) -> torch.Tensor:
    """Grouped dot-product attention, fp32 softmax. Returns [B, Lq, H, dv].

    Materializes the [Lq, S] logits: the oracle / short-sequence path."""
    B, Lq, H, _ = q.shape
    KV = k.shape[2]
    kt = k.permute(0, 2, 3, 1).reshape(B * KV, k.shape[3], k.shape[1])  # [B*KV, dh, S]
    logits = _ungroup(_bmm_f32(_group_q(q, KV), kt), B, KV, Lq) * scale  # [B, H, Lq, S]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    vg = v.permute(0, 2, 1, 3).reshape(B * KV, v.shape[1], v.shape[3])  # [B*KV, S, dv]
    out = _ungroup(_bmm_f32(probs.reshape(B * KV, -1, probs.shape[-1]), vg), B, KV, Lq)
    return out.transpose(1, 2).to(q.dtype)


def _pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    pad = to - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _flash_q_block(
    qg: torch.Tensor,  # [B*KV, G*Qc, dh] one grouped Q block
    qp: torch.Tensor,  # [Qc]
    kt: torch.Tensor,  # [B*KV, dh, S_p]
    vg: torch.Tensor,  # [B*KV, S_p, dv]
    kv_pos: torch.Tensor,  # [S_p], -1 on padding
    B: int,
    KV: int,
    Kc: int,
    causal: bool,
    window: Optional[int],
    scale: float,
) -> torch.Tensor:
    """One Q block against every KV block: the running (max, denom, acc) recurrence. [B, H, Qc, dv]."""
    Qc = qp.shape[0]
    H = KV * (qg.shape[1] // Qc)
    dv = vg.shape[-1]
    ad = qg.dtype
    m = torch.full((B, H, Qc), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, H, Qc), dtype=torch.float32, device=qg.device)
    o = torch.zeros((B, H, Qc, dv), dtype=torch.float32, device=qg.device)
    for j in range(0, kt.shape[-1], Kc):
        s = _ungroup(_bmm_f32(qg, kt[..., j : j + Kc]), B, KV, Qc) * scale  # [B, H, Qc, Kc]
        mask = attention_mask(qp, kv_pos[j : j + Kc], causal, window)  # [Qc, Kc]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)  # [B, H, Qc]
        l = l * alpha + p.sum(dim=-1)
        pv = _ungroup(_bmm_f32(p.to(ad).reshape(B * KV, -1, p.shape[-1]), vg[:, j : j + Kc]), B, KV, Qc)
        o = o * alpha[..., None] + pv
        m = m_new
    denom = l[..., None]
    return torch.where(denom > 0, o / torch.clamp_min(denom, 1e-37), 0.0).to(ad)


def _attend_flash(
    q: torch.Tensor,  # [B, Lq, H, dh]
    k: torch.Tensor,  # [B, S, KV, dh]
    v: torch.Tensor,  # [B, S, KV, dv]
    q_pos: torch.Tensor,  # [Lq] int32
    kv_pos: torch.Tensor,  # [S] int32 (-1 = invalid)
    causal: bool,
    window: Optional[int],
    scale: float,
    q_chunk: int,
    kv_chunk: int,
    block_group=None,
) -> torch.Tensor:
    """Flash-style two-level schedule: Q blocks outer, a running (max, denom, acc) over KV blocks inner.

    Never materializes more than one [B, H, Qc, Kc] logits block. Q and KV
    are padded to whole chunks, and padded KV slots get position -1 (masked).
    Under autograd each Q block is a checkpoint: the backward pass recomputes
    its KV loop instead of keeping every logits block, as the reference's
    ``jax.checkpoint`` on its Q-block body. With ``block_group`` (an
    :class:`~repro_torch.models.collectives.AxisGroup`: the sequence-parallel
    prefill) this rank runs only its contiguous share of the Q blocks, and
    the blocks' outputs are gathered over the group.
    """
    B, Lq, H, _ = q.shape
    S, KV = k.shape[1], k.shape[2]
    Qc = min(q_chunk, Lq)
    Kc = min(kv_chunk, S)
    Lq_p = -(-Lq // Qc) * Qc
    S_p = -(-S // Kc) * Kc
    q = _pad_axis(q, 1, Lq_p)
    q_pos_p = _pad_axis(q_pos, 0, Lq_p)
    kt = _pad_axis(k, 1, S_p).permute(0, 2, 3, 1).reshape(B * KV, k.shape[3], S_p)
    vg = _pad_axis(v, 1, S_p).permute(0, 2, 1, 3).reshape(B * KV, S_p, v.shape[3])
    kv_pos_p = torch.where(
        torch.arange(S_p, device=kv_pos.device) < S, _pad_axis(kv_pos, 0, S_p), -1
    ).to(torch.int32)

    starts = list(range(0, Lq_p, Qc))
    if block_group is not None and block_group.size > 1:
        per = len(starts) // block_group.size
        starts = starts[block_group.index * per : (block_group.index + 1) * per]
    outs = []
    for i in starts:
        args = (_group_q(q[:, i : i + Qc], KV), q_pos_p[i : i + Qc], kt, vg, kv_pos_p,
                B, KV, Kc, causal, window, scale)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_flash_q_block, *args, use_reentrant=False))
        else:
            outs.append(_flash_q_block(*args))
    out = torch.cat(outs, dim=2)
    if block_group is not None:
        out = all_gather(out, 2, block_group)
    return out.transpose(1, 2)[:, :Lq]


def _q_block_axes(Lq: int, cfg: ModelConfig, ctx: ShardingCtx) -> tuple[str, ...]:
    """The mesh axes the flash schedule's Q blocks split over (``()``: every rank runs every block)."""
    if not (cfg.flash_q_parallel and ctx.active):
        return ()
    Qc = min(cfg.attn_q_chunk, Lq)
    nq = -(-Lq // Qc)
    return ctx.spec((nq,), ("qblocks",)).axes(0) if nq > 1 else ()


def _heads_spec(axes: tuple[str, ...], rows: tuple[str, ...] | None = None) -> PartitionSpec:
    """The layout of a [B, L, heads, d] tensor whose heads split over ``axes`` (and rows over ``rows``)."""
    return PartitionSpec.of(rows, None, axes)


def _attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
    scale: float,
    ctx: ShardingCtx = NO_SHARDING,
    q_axes: tuple[str, ...] = (),
    kv_axes: tuple[str, ...] = (),
) -> torch.Tensor:
    """Dispatch: dense for short (Lq, S); flash-chunked beyond the thresholds.

    ``q`` holds the query heads split over ``q_axes``, ``k``/``v`` the KV
    heads split over ``kv_axes``; the output holds the query heads of ``q``.
    """
    Lq, S = q.shape[1], k.shape[1]
    if Lq <= cfg.attn_q_chunk and S <= cfg.attn_kv_chunk:
        mask = attention_mask(q_pos, kv_pos, cfg.causal, cfg.sliding_window)
        k, v = _kv_of_heads(k, v, q.shape[2], ctx, q_axes, kv_axes, cfg.num_heads)
        return _attend_dense(q, k, v, mask, scale)
    blocks = _q_block_axes(Lq, cfg, ctx)
    if blocks:  # every head (and every row of an axis the blocks take) on this rank's Q blocks, then back
        rows = tuple(a for a in blocks if a in ctx.batch_axes)
        q = ctx.relayout(q, _heads_spec(q_axes, rows), PartitionSpec())
        k = ctx.relayout(k, _heads_spec(kv_axes, rows), PartitionSpec())
        v = ctx.relayout(v, _heads_spec(kv_axes, rows), PartitionSpec())
        out = _attend_flash(q, k, v, q_pos, kv_pos, cfg.causal, cfg.sliding_window, scale,
                            cfg.attn_q_chunk, cfg.attn_kv_chunk, ctx.group(blocks))
        return ctx.relayout(out, PartitionSpec(), _heads_spec(q_axes, rows))
    k, v = _kv_of_heads(k, v, q.shape[2], ctx, q_axes, kv_axes, cfg.num_heads)
    return _attend_flash(q, k, v, q_pos, kv_pos, cfg.causal, cfg.sliding_window, scale,
                         cfg.attn_q_chunk, cfg.attn_kv_chunk)


def _groups_for_heads(t: torch.Tensor, dim: int, H_l: int, h0: int, g0: int, G: int) -> torch.Tensor:
    """The groups of ``t`` (along ``dim``, the first one global group ``g0``) that query heads
    ``[h0, h0 + H_l)`` read, head h reading group ``h // G``: in equal consecutive groups when they
    fit, else one group per head."""
    first, last = h0 // G - g0, (h0 + H_l - 1) // G - g0
    if h0 % G == 0 and H_l % G == 0 or first == last:
        return t.narrow(dim, first, last + 1 - first)
    idx = torch.tensor([(h0 + i) // G - g0 for i in range(H_l)], device=t.device)
    return t.index_select(dim, idx)


def _kv_of_heads(k: torch.Tensor, v: torch.Tensor, H_l: int, ctx: ShardingCtx, q_axes: tuple[str, ...],
                 kv_axes: tuple[str, ...], H: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The KV heads that this rank's ``H_l`` query heads read (:func:`_groups_for_heads`)."""
    KV_l = k.shape[2]
    h0, kv0 = ctx.index(q_axes) * H_l, ctx.index(kv_axes) * KV_l
    G = H // (KV_l * (ctx.mesh.axis_size(kv_axes) if kv_axes else 1))
    if h0 == kv0 * G and H_l == KV_l * G:
        return k, v
    return _groups_for_heads(k, 2, H_l, h0, kv0, G), _groups_for_heads(v, 2, H_l, h0, kv0, G)


def _attend_seq_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                      kv_pos: torch.Tensor, cfg: ModelConfig, scale: float, group) -> torch.Tensor:
    """Every query head against this rank's cache slots, the softmax merged over ``group``.

    ``q`` [B, Lq, H, dh] holds all heads, ``k``/``v`` [B, S_l, KV, d] this
    rank's slots of every KV head at positions ``kv_pos`` (-1 = empty). The
    shift is the max over every shard; one sum then merges each shard's
    ``(Σp·v, Σp)``. A row with no key on any shard comes out 0, as the
    flash path's.
    """
    B, Lq, H, _ = q.shape
    KV = k.shape[2]
    kt = k.permute(0, 2, 3, 1).reshape(B * KV, k.shape[3], k.shape[1])
    s = _ungroup(_bmm_f32(_group_q(q, KV), kt), B, KV, Lq) * scale  # [B, H, Lq, S_l]
    mask = attention_mask(q_pos, kv_pos, cfg.causal, cfg.sliding_window)
    s = torch.where(mask, s, NEG_INF)
    m = all_reduce_max(s.amax(dim=-1), group)
    p = torch.exp(s - m[..., None]) * mask
    vg = v.permute(0, 2, 1, 3).reshape(B * KV, v.shape[1], v.shape[3])
    pv = _ungroup(_bmm_f32(p.to(q.dtype).reshape(B * KV, -1, p.shape[-1]), vg), B, KV, Lq)  # [B, H, Lq, dv]
    merged = all_reduce(torch.cat([pv, p.sum(dim=-1)[..., None]], dim=-1), group)
    o, l = merged[..., :-1], merged[..., -1:]
    return torch.where(l > 0, o / torch.clamp_min(l, 1e-37), 0.0).transpose(1, 2).to(q.dtype)


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                 window: int | None = None, offset: int = 0) -> tuple[KVCache, torch.Tensor]:
    """Append L tokens at ``positions``; returns (cache', kv_pos of every slot held, -1 if empty).

    Nothing is read back to the host. The full cache writes L consecutive
    slots from ``positions[0]``, with the start clamped into ``[0, W - L]``
    as ``jax.lax.dynamic_update_slice`` clamps it. The rolling cache writes
    slot ``p % W`` for each position p; when L > W only the last W tokens
    are written, which is what the reference's scatter leaves (its later
    writes to a slot win). A cache split along the sequence holds slots
    ``[offset, offset + W_l)`` of the ``window`` = W slots: only the
    tokens whose slot falls there are written.
    """
    W_l, L = cache.window, k.shape[1]
    W = window or W_l
    if cache.rolling:
        if L > W:
            k, v, positions = k[:, -W:], v[:, -W:], positions[-W:]
        slots = (positions % W).long()
    else:
        slots = _full_slots(positions, L, W)
    next_pos = positions[-1] + 1
    kv_pos = rolling_slot_positions(next_pos, W) if cache.rolling else _full_kv_pos(next_pos, W)
    split = W_l != W
    new = KVCache(k=_write_slots(cache.k, slots - offset, k, split), v=_write_slots(cache.v, slots - offset, v, split),
                  next_pos=next_pos, rolling=cache.rolling)
    return new, kv_pos[offset : offset + W_l]


def _write_slots(buf: torch.Tensor, slots: torch.Tensor, x: torch.Tensor, split: bool) -> torch.Tensor:
    """``buf`` [B, W_l, ...] with ``x``'s rows written at ``slots`` along dim 1. In a ``split``
    cache, rows whose slot lies outside ``[0, W_l)`` (held by another rank) go to a spare row
    that is dropped."""
    x = x.to(buf.dtype)
    if not split:
        return buf.index_copy(1, slots, x)
    W_l = buf.shape[1]
    inside = (slots >= 0) & (slots < W_l)
    spare = torch.cat([buf, buf.new_zeros((buf.shape[0], 1, *buf.shape[2:]))], dim=1)
    return spare.index_copy(1, torch.where(inside, slots, W_l), x)[:, :W_l]


def _full_slots(positions: torch.Tensor, L: int, W: int) -> torch.Tensor:
    """The L consecutive slots of a full cache from ``positions[0]``, clamped into ``[0, W - L]``
    as ``jax.lax.dynamic_update_slice`` clamps its start."""
    if L > W:
        raise ValueError(f"{L} tokens do not fit a cache of {W} slots")
    return positions[0].long().clamp(0, W - L) + torch.arange(L, device=positions.device)


def _full_kv_pos(next_pos: torch.Tensor, W: int) -> torch.Tensor:
    """Position of each full-cache slot: i below ``next_pos``, else -1."""
    slot = torch.arange(W, dtype=torch.int32, device=next_pos.device)
    return torch.where(slot < next_pos, slot, -1).to(torch.int32)


def _cache_layout(ctx: ShardingCtx, shape: tuple[int, ...], axes: tuple) -> tuple[int, PartitionSpec]:
    """(this rank's first slot, spec) of a cache field of global ``shape`` (slots along dim 1)."""
    spec = ctx.spec(shape, axes)
    seq = spec.axes(1)
    return (ctx.index(seq) * (shape[1] // ctx.mesh.axis_size(seq)) if seq else 0), spec


def apply_attention(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    positions: torch.Tensor,  # [L] int32 absolute positions
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """GQA/MQA/SWA attention. With ``cache``, appends L tokens then attends
    over the cache (L=1 is the decode step); without, self-attends over x."""
    ad = cfg.dtype("act")
    B, L, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(ad)
    d = desc_attention(cfg)
    wq, wk, wv = (ctx.weight(params[n].to(ad), d[n]) for n in ("w_q", "w_k", "w_v"))
    H_l, KV_l = wq.shape[1], wk.shape[1]
    q = (x @ wq.reshape(D, H_l * hd)).view(B, L, H_l, hd)
    k = (x @ wk.reshape(D, KV_l * hd)).view(B, L, KV_l, hd)
    v = (x @ wv.reshape(D, KV_l * hd)).view(B, L, KV_l, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = hd**-0.5
    qh, kvh = ctx.weight_axes(d["w_q"], 1), ctx.weight_axes(d["w_k"], 1)

    if cache is None:
        out, new_cache = _attend(q, k, v, positions, positions, cfg, scale, ctx, qh, kvh), None
    elif not ctx.active:
        new_cache, kv_pos = _write_cache(cache, k, v, positions)
        out = _attend(q, new_cache.k, new_cache.v, positions, kv_pos, cfg, scale)
    else:
        W = min(cfg.sliding_window, ctx.cache_len) if cache.rolling else ctx.cache_len
        offset, spec = _cache_layout(ctx, (ctx.batch, W, KV, hd), ("batch", "cache_seq", "kv_heads", "kv_head_dim"))
        seq, heads = spec.axes(1), spec.axes(2)
        k = ctx.relayout(k, _heads_spec(kvh), _heads_spec(heads))
        v = ctx.relayout(v, _heads_spec(kvh), _heads_spec(heads))
        new_cache, kv_pos = _write_cache(cache, k, v, positions, W, offset)
        if seq:  # every head against this rank's slots, merged over the sequence's axes
            q_all = ctx.relayout(q, _heads_spec(qh), PartitionSpec())
            out = _attend_seq_split(q_all, new_cache.k, new_cache.v, positions, kv_pos, cfg, scale, ctx.group(seq))
            out = ctx.relayout(out, PartitionSpec(), _heads_spec(qh))
        else:
            out = _attend(q, new_cache.k, new_cache.v, positions, kv_pos, cfg, scale, ctx, qh, heads)
    y = out.reshape(B, L, H_l * hd) @ ctx.weight(params["w_o"].to(ad), d["w_o"]).reshape(H_l * hd, D)
    return ctx.psum(y, ctx.weight_axes(d["w_o"], 0)), new_cache


# ---------------------------------------------------------------------------
# MLA (minicpm3 / deepseek-style latent attention)
# ---------------------------------------------------------------------------


def _mla_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
             ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queries and the new latent entries of x: (q_nope [B,L,H,dn], q_pe [B,L,H,dr], ckv [B,L,r_kv], kpe [B,L,dr]).

    RoPE turns ``q_pe`` and the one shared key head ``kpe``; ``ckv`` is not
    normalised here. Over a mesh H is this rank's query heads.
    """
    ad = cfg.dtype("act")
    B, L, D = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    d = desc_attention(cfg)
    if cfg.q_lora_rank > 0:
        cq = rms_norm(x @ ctx.weight(params["w_dq"].to(ad), d["w_dq"]), params["q_norm"])
        w = ctx.weight(params["w_uq"].to(ad), d["w_uq"])
        q = cq @ w.reshape(cfg.q_lora_rank, -1)
    else:
        w = ctx.weight(params["w_q"].to(ad), d["w_q"])
        q = x @ w.reshape(D, -1)
    q = q.view(B, L, w.shape[1], dn + dr)
    q_nope, q_pe = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = x @ ctx.weight(params["w_dkv"].to(ad), d["w_dkv"])
    kpe = x @ ctx.weight(params["w_kpe"].to(ad), d["w_kpe"])
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, ckv, kpe


def _mla_heads(params: dict, cfg: ModelConfig, ctx: ShardingCtx) -> tuple[str, ...]:
    """The mesh axes the query heads split over at use."""
    return ctx.weight_axes(desc_attention(cfg)["w_uk"], 1)


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_up(params: dict, ckv_n: torch.Tensor, cfg: ModelConfig,
            ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-head keys and values rebuilt from the normalised latent: (k_nope [B,S,H,dn], v [B,S,H,dv])."""
    ad = cfg.dtype("act")
    B, S, r = ckv_n.shape
    d = desc_attention(cfg)
    w_uk, w_uv = (ctx.weight(params[n].to(ad), d[n]) for n in ("w_uk", "w_uv"))
    H = w_uk.shape[1]
    k_nope = (ckv_n @ w_uk.reshape(r, H * cfg.qk_nope_dim)).view(B, S, H, cfg.qk_nope_dim)
    v = (ckv_n @ w_uv.reshape(r, H * cfg.v_head_dim)).view(B, S, H, cfg.v_head_dim)
    return k_nope, v


def _mla_out(params: dict, out: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """[B, L, H, dv] -> [B, L, D] through ``w_o``, summed over the heads' axes."""
    B, L, H, dv = out.shape
    d = desc_attention(cfg)["w_o"]
    y = out.reshape(B, L, H * dv) @ ctx.weight(params["w_o"].to(cfg.dtype("act")), d).reshape(H * dv, -1)
    return ctx.psum(y, ctx.weight_axes(d, 0))


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, d] -> [B*H, S, d]."""
    B, S, H, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, S, d)


def _mla_attend_dense(
    params: dict,
    q_nope: torch.Tensor,  # [B, Lq, H, dn]
    q_pe: torch.Tensor,  # [B, Lq, H, dr]
    ckv: torch.Tensor,  # [B, S, r_kv] (normalised here)
    kpe: torch.Tensor,  # [B, S, dr]
    mask: torch.Tensor,  # [Lq, S]
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
) -> torch.Tensor:
    """K/V rebuilt per head; the nope and rope scores as two float32 products, as the reference's."""
    ad = cfg.dtype("act")
    B, Lq, H, _ = q_nope.shape
    S = ckv.shape[1]
    k_nope, v = _mla_up(params, rms_norm(ckv, params["kv_norm"]), cfg, ctx)
    s_nope = _bmm_f32(_heads_first(q_nope), _heads_first(k_nope).mT).view(B, H, Lq, S)
    s_pe = _bmm_f32(q_pe.permute(0, 2, 1, 3).reshape(B, H * Lq, -1), kpe.mT).view(B, H, Lq, S)
    logits = torch.where(mask, (s_nope + s_pe) * _mla_scale(cfg), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = _bmm_f32(probs.reshape(B * H, Lq, S), _heads_first(v)).view(B, H, Lq, -1)
    return _mla_out(params, out.transpose(1, 2).to(ad), cfg, ctx)


def _mla_absorbed_qkv(params: dict, q_nope: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                      kpe: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The latent-space MQA: (q [B,Lq,H,r+dr] with ``w_uk`` folded in, k [B,S,1,r+dr], v [B,S,1,r])."""
    ad = cfg.dtype("act")
    B, Lq, H, dn = q_nope.shape
    r = ckv.shape[-1]
    ckv_n = rms_norm(ckv, params["kv_norm"])
    w_uk = ctx.weight(params["w_uk"].to(ad), desc_attention(cfg)["w_uk"])  # [r, H, dn]
    q_eff = torch.bmm(q_nope.permute(2, 0, 1, 3).reshape(H, B * Lq, dn), w_uk.permute(1, 2, 0))  # [H, B*Lq, r]
    q = torch.cat([q_eff.view(H, B, Lq, r).permute(1, 2, 0, 3), q_pe], dim=-1)
    return q, torch.cat([ckv_n, kpe], dim=-1)[:, :, None, :], ckv_n[:, :, None, :]


def _mla_latent_out(params: dict, o_latent: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx) -> torch.Tensor:
    """``w_uv`` then ``w_o`` on the latent attention output [B, Lq, H, r]."""
    ad = cfg.dtype("act")
    B, Lq, H, r = o_latent.shape
    w_uv = ctx.weight(params["w_uv"].to(ad), desc_attention(cfg)["w_uv"])  # [r, H, dv]
    out = torch.bmm(o_latent.permute(2, 0, 1, 3).reshape(H, B * Lq, r), w_uv.permute(1, 0, 2))  # [H, B*Lq, dv]
    return _mla_out(params, out.view(H, B, Lq, -1).permute(1, 2, 0, 3), cfg, ctx)


def _mla_attend_flash(
    params: dict,
    q_nope: torch.Tensor,  # [B, Lq, H, dn]
    q_pe: torch.Tensor,  # [B, Lq, H, dr]
    ckv: torch.Tensor,  # [B, S, r_kv]
    kpe: torch.Tensor,  # [B, S, dr]
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
) -> torch.Tensor:
    """Chunked MLA with *matrix absorption*: ``q_eff = q_nope · w_uk`` (rounded to the activation
    dtype, as the reference's einsum), attention in the latent space as MQA over one KV head (key
    ``[ckv_n | kpe]``, value ``ckv_n``) through the flash schedule, then ``w_uv`` applied once to the
    latent output. Nothing per head is rebuilt from the cache: the decode path."""
    q, k, v = _mla_absorbed_qkv(params, q_nope, q_pe, ckv, kpe, cfg, ctx)
    o_latent = _attend_flash(q, k, v, q_pos, kv_pos, cfg.causal, cfg.sliding_window,
                             _mla_scale(cfg), cfg.attn_q_chunk, cfg.attn_kv_chunk)  # [B, Lq, H, r]
    return _mla_latent_out(params, o_latent, cfg, ctx)


def _mla_attend_materialized(
    params: dict,
    q_nope: torch.Tensor,  # [B, Lq, H, dn]
    q_pe: torch.Tensor,  # [B, Lq, H, dr]
    ckv: torch.Tensor,  # [B, S, r_kv]
    kpe: torch.Tensor,  # [B, S, dr]
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
) -> torch.Tensor:
    """Long-Lq (prefill / training) path: rebuild per-head K/V once and run the standard flash
    schedule with ``dh = dn + dr`` (the shared ``kpe`` broadcast to every head) and ``dv``."""
    ad = cfg.dtype("act")
    H = q_nope.shape[2]
    k_nope, v = _mla_up(params, rms_norm(ckv, params["kv_norm"]), cfg, ctx)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(-1, -1, H, -1)], dim=-1)
    heads = _mla_heads(params, cfg, ctx)
    out = _attend(q, k, v, q_pos, kv_pos, cfg, _mla_scale(cfg), ctx, heads, heads)
    return _mla_out(params, out.to(ad), cfg, ctx)


def _mla_attend(
    params: dict,
    q_nope: torch.Tensor,
    q_pe: torch.Tensor,
    ckv: torch.Tensor,
    kpe: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
) -> torch.Tensor:
    """Dispatch: dense for short (Lq, S); materialized when Lq passes the Q chunk; else absorbed flash."""
    Lq, S = q_nope.shape[1], ckv.shape[1]
    if Lq <= cfg.attn_q_chunk and S <= cfg.attn_kv_chunk:
        mask = attention_mask(q_pos, kv_pos, cfg.causal, cfg.sliding_window)
        return _mla_attend_dense(params, q_nope, q_pe, ckv, kpe, mask, cfg, ctx)
    if Lq > cfg.attn_q_chunk:
        return _mla_attend_materialized(params, q_nope, q_pe, ckv, kpe, q_pos, kv_pos, cfg, ctx)
    return _mla_attend_flash(params, q_nope, q_pe, ckv, kpe, q_pos, kv_pos, cfg, ctx)


def apply_mla(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    positions: torch.Tensor,  # [L] int32 absolute positions
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
    cache: Optional[MLACache] = None,
) -> tuple[torch.Tensor, Optional[MLACache]]:
    """MLA attention. With ``cache``, writes the L new latent entries (from ``positions[0]``, the
    start clamped as the full KV cache's) then attends over the cache; without, self-attends over x.
    A cache split along the sequence is read in the absorbed form, every head against this rank's
    slots, the softmax merged over the sequence's axes."""
    x = x.to(cfg.dtype("act"))
    q_nope, q_pe, ckv, kpe = _mla_qkv(params, x, positions, cfg, ctx)
    if cache is None:
        return _mla_attend(params, q_nope, q_pe, ckv, kpe, positions, positions, cfg, ctx), None
    S_l = cache.ckv.shape[1]
    S, offset, seq = S_l, 0, ()
    if ctx.active:
        S = ctx.cache_len
        offset, spec = _cache_layout(ctx, (ctx.batch, S, cfg.kv_lora_rank), ("batch", "cache_seq", "latent"))
        seq = spec.axes(1)
    slots = _full_slots(positions, x.shape[1], S) - offset
    new = MLACache(
        ckv=_write_slots(cache.ckv, slots, ckv, S_l != S),
        kpe=_write_slots(cache.kpe, slots, kpe, S_l != S),
        next_pos=positions[-1] + 1,
    )
    kv_pos = _full_kv_pos(new.next_pos, S)[offset : offset + S_l]
    if not seq:
        return _mla_attend(params, q_nope, q_pe, new.ckv, new.kpe, positions, kv_pos, cfg, ctx), new
    heads = _mla_heads(params, cfg, ctx)
    q, k, v = _mla_absorbed_qkv(params, q_nope, q_pe, new.ckv, new.kpe, cfg, ctx)
    q = ctx.relayout(q, _heads_spec(heads), PartitionSpec())
    o_latent = _attend_seq_split(q, k, v, positions, kv_pos, cfg, _mla_scale(cfg), ctx.group(seq))
    o_latent = ctx.relayout(o_latent, PartitionSpec(), _heads_spec(heads))
    return _mla_latent_out(params, o_latent, cfg, ctx), new
