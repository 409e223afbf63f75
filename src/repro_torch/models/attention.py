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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, apply_rope, rms_norm
from repro_torch.models.module import desc, fan_in_desc

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
    """Batched product of two bf16/fp16 operands, summed and returned in float32."""
    if a.is_cuda:
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
    q_parallel: bool = False,
) -> torch.Tensor:
    """Flash-style two-level schedule: Q blocks outer, a running (max, denom, acc) over KV blocks inner.

    Never materializes more than one [B, H, Qc, Kc] logits block. Q and KV
    are padded to whole chunks, and padded KV slots get position -1 (masked).
    Under autograd each Q block is a checkpoint: the backward pass recomputes
    its KV loop instead of keeping every logits block, as the reference's
    ``jax.checkpoint`` on its Q-block body. ``q_parallel`` (the reference's
    sequence-parallel prefill over a mesh) has no effect on one device.
    """
    del q_parallel
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

    outs = []
    for i in range(0, Lq_p, Qc):
        args = (_group_q(q[:, i : i + Qc], KV), q_pos_p[i : i + Qc], kt, vg, kv_pos_p,
                B, KV, Kc, causal, window, scale)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_flash_q_block, *args, use_reentrant=False))
        else:
            outs.append(_flash_q_block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)[:, :Lq]


def _attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
    scale: float,
) -> torch.Tensor:
    """Dispatch: dense for short (Lq, S); flash-chunked beyond the thresholds."""
    Lq, S = q.shape[1], k.shape[1]
    if Lq <= cfg.attn_q_chunk and S <= cfg.attn_kv_chunk:
        mask = attention_mask(q_pos, kv_pos, cfg.causal, cfg.sliding_window)
        return _attend_dense(q, k, v, mask, scale)
    return _attend_flash(
        q, k, v, q_pos, kv_pos, cfg.causal, cfg.sliding_window, scale,
        cfg.attn_q_chunk, cfg.attn_kv_chunk, cfg.flash_q_parallel,
    )


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> tuple[KVCache, torch.Tensor]:
    """Append L tokens at ``positions``; returns (cache', kv_pos [W] of every slot, -1 if empty).

    Nothing is read back to the host. The full cache writes L consecutive
    slots from ``positions[0]``, with the start clamped into ``[0, W - L]``
    as ``jax.lax.dynamic_update_slice`` clamps it. The rolling cache writes
    slot ``p % W`` for each position p; when L > W only the last W tokens
    are written, which is what the reference's scatter leaves (its later
    writes to a slot win).
    """
    W, L = cache.window, k.shape[1]
    if cache.rolling:
        if L > W:
            k, v, positions = k[:, -W:], v[:, -W:], positions[-W:]
        slots = (positions % W).long()
    else:
        slots = _full_slots(positions, L, W)
    new = KVCache(
        k=cache.k.index_copy(1, slots, k.to(cache.k.dtype)),
        v=cache.v.index_copy(1, slots, v.to(cache.v.dtype)),
        next_pos=positions[-1] + 1,
        rolling=cache.rolling,
    )
    if cache.rolling:
        return new, rolling_slot_positions(new.next_pos, W)
    return new, _full_kv_pos(new.next_pos, W)


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


def apply_attention(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    positions: torch.Tensor,  # [L] int32 absolute positions
    cfg: ModelConfig,
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """GQA/MQA/SWA attention. With ``cache``, appends L tokens then attends
    over the cache (L=1 is the decode step); without, self-attends over x."""
    ad = cfg.dtype("act")
    B, L, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = x.to(ad)
    q = (x @ params["w_q"].to(ad).reshape(D, H * hd)).view(B, L, H, hd)
    k = (x @ params["w_k"].to(ad).reshape(D, KV * hd)).view(B, L, KV, hd)
    v = (x @ params["w_v"].to(ad).reshape(D, KV * hd)).view(B, L, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = hd**-0.5

    if cache is None:
        out, new_cache = _attend(q, k, v, positions, positions, cfg, scale), None
    else:
        new_cache, kv_pos = _write_cache(cache, k, v, positions)
        out = _attend(q, new_cache.k, new_cache.v, positions, kv_pos, cfg, scale)
    y = out.reshape(B, L, H * hd) @ params["w_o"].to(ad).reshape(H * hd, D)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (minicpm3 / deepseek-style latent attention)
# ---------------------------------------------------------------------------


def _mla_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queries and the new latent entries of x: (q_nope [B,L,H,dn], q_pe [B,L,H,dr], ckv [B,L,r_kv], kpe [B,L,dr]).

    RoPE turns ``q_pe`` and the one shared key head ``kpe``; ``ckv`` is not normalised here.
    """
    ad = cfg.dtype("act")
    B, L, D = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank > 0:
        cq = rms_norm(x @ params["w_dq"].to(ad), params["q_norm"])
        q = cq @ params["w_uq"].to(ad).reshape(cfg.q_lora_rank, H * (dn + dr))
    else:
        q = x @ params["w_q"].to(ad).reshape(D, H * (dn + dr))
    q = q.view(B, L, H, dn + dr)
    q_nope, q_pe = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = x @ params["w_dkv"].to(ad)
    kpe = apply_rope((x @ params["w_kpe"].to(ad))[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, ckv, kpe


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_up(params: dict, ckv_n: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-head keys and values rebuilt from the normalised latent: (k_nope [B,S,H,dn], v [B,S,H,dv])."""
    ad = cfg.dtype("act")
    B, S, r = ckv_n.shape
    H = cfg.num_heads
    k_nope = (ckv_n @ params["w_uk"].to(ad).reshape(r, H * cfg.qk_nope_dim)).view(B, S, H, cfg.qk_nope_dim)
    v = (ckv_n @ params["w_uv"].to(ad).reshape(r, H * cfg.v_head_dim)).view(B, S, H, cfg.v_head_dim)
    return k_nope, v


def _mla_out(params: dict, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, L, H, dv] -> [B, L, D] through ``w_o``."""
    B, L, H, dv = out.shape
    return out.reshape(B, L, H * dv) @ params["w_o"].to(cfg.dtype("act")).reshape(H * dv, -1)


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
) -> torch.Tensor:
    """K/V rebuilt per head; the nope and rope scores as two float32 products, as the reference's."""
    ad = cfg.dtype("act")
    B, Lq, H, _ = q_nope.shape
    S = ckv.shape[1]
    k_nope, v = _mla_up(params, rms_norm(ckv, params["kv_norm"]), cfg)
    s_nope = _bmm_f32(_heads_first(q_nope), _heads_first(k_nope).mT).view(B, H, Lq, S)
    s_pe = _bmm_f32(q_pe.permute(0, 2, 1, 3).reshape(B, H * Lq, -1), kpe.mT).view(B, H, Lq, S)
    logits = torch.where(mask, (s_nope + s_pe) * _mla_scale(cfg), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = _bmm_f32(probs.reshape(B * H, Lq, S), _heads_first(v)).view(B, H, Lq, -1)
    return _mla_out(params, out.transpose(1, 2).to(ad), cfg)


def _mla_attend_flash(
    params: dict,
    q_nope: torch.Tensor,  # [B, Lq, H, dn]
    q_pe: torch.Tensor,  # [B, Lq, H, dr]
    ckv: torch.Tensor,  # [B, S, r_kv]
    kpe: torch.Tensor,  # [B, S, dr]
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Chunked MLA with *matrix absorption*: ``q_eff = q_nope · w_uk`` (rounded to the activation
    dtype, as the reference's einsum), attention in the latent space as MQA over one KV head (key
    ``[ckv_n | kpe]``, value ``ckv_n``) through the flash schedule, then ``w_uv`` applied once to the
    latent output. Nothing per head is rebuilt from the cache: the decode path."""
    ad = cfg.dtype("act")
    B, Lq, H, dn = q_nope.shape
    r = ckv.shape[-1]
    ckv_n = rms_norm(ckv, params["kv_norm"])
    w_uk = params["w_uk"].to(ad)  # [r, H, dn]
    q_eff = torch.bmm(q_nope.permute(2, 0, 1, 3).reshape(H, B * Lq, dn), w_uk.permute(1, 2, 0))  # [H, B*Lq, r]
    q = torch.cat([q_eff.view(H, B, Lq, r).permute(1, 2, 0, 3), q_pe], dim=-1)  # [B, Lq, H, r + dr]
    k = torch.cat([ckv_n, kpe], dim=-1)[:, :, None, :]  # [B, S, 1, r + dr]
    o_latent = _attend_flash(q, k, ckv_n[:, :, None, :], q_pos, kv_pos, cfg.causal, cfg.sliding_window,
                             _mla_scale(cfg), cfg.attn_q_chunk, cfg.attn_kv_chunk)  # [B, Lq, H, r]
    w_uv = params["w_uv"].to(ad)  # [r, H, dv]
    out = torch.bmm(o_latent.permute(2, 0, 1, 3).reshape(H, B * Lq, r), w_uv.permute(1, 0, 2))  # [H, B*Lq, dv]
    return _mla_out(params, out.view(H, B, Lq, -1).permute(1, 2, 0, 3), cfg)


def _mla_attend_materialized(
    params: dict,
    q_nope: torch.Tensor,  # [B, Lq, H, dn]
    q_pe: torch.Tensor,  # [B, Lq, H, dr]
    ckv: torch.Tensor,  # [B, S, r_kv]
    kpe: torch.Tensor,  # [B, S, dr]
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Long-Lq (prefill / training) path: rebuild per-head K/V once and run the standard flash
    schedule with ``dh = dn + dr`` (the shared ``kpe`` broadcast to every head) and ``dv``."""
    ad = cfg.dtype("act")
    H = q_nope.shape[2]
    k_nope, v = _mla_up(params, rms_norm(ckv, params["kv_norm"]), cfg)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(-1, -1, H, -1)], dim=-1)
    out = _attend_flash(q, k, v, q_pos, kv_pos, cfg.causal, cfg.sliding_window, _mla_scale(cfg),
                        cfg.attn_q_chunk, cfg.attn_kv_chunk, cfg.flash_q_parallel)
    return _mla_out(params, out.to(ad), cfg)


def _mla_attend(
    params: dict,
    q_nope: torch.Tensor,
    q_pe: torch.Tensor,
    ckv: torch.Tensor,
    kpe: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Dispatch: dense for short (Lq, S); materialized when Lq passes the Q chunk; else absorbed flash."""
    Lq, S = q_nope.shape[1], ckv.shape[1]
    if Lq <= cfg.attn_q_chunk and S <= cfg.attn_kv_chunk:
        mask = attention_mask(q_pos, kv_pos, cfg.causal, cfg.sliding_window)
        return _mla_attend_dense(params, q_nope, q_pe, ckv, kpe, mask, cfg)
    if Lq > cfg.attn_q_chunk:
        return _mla_attend_materialized(params, q_nope, q_pe, ckv, kpe, q_pos, kv_pos, cfg)
    return _mla_attend_flash(params, q_nope, q_pe, ckv, kpe, q_pos, kv_pos, cfg)


def apply_mla(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    positions: torch.Tensor,  # [L] int32 absolute positions
    cfg: ModelConfig,
    cache: Optional[MLACache] = None,
) -> tuple[torch.Tensor, Optional[MLACache]]:
    """MLA attention. With ``cache``, writes the L new latent entries (from ``positions[0]``, the
    start clamped as the full KV cache's) then attends over the cache; without, self-attends over x."""
    x = x.to(cfg.dtype("act"))
    q_nope, q_pe, ckv, kpe = _mla_qkv(params, x, positions, cfg)
    if cache is None:
        return _mla_attend(params, q_nope, q_pe, ckv, kpe, positions, positions, cfg), None
    S = cache.ckv.shape[1]
    slots = _full_slots(positions, x.shape[1], S)
    new = MLACache(
        ckv=cache.ckv.index_copy(1, slots, ckv.to(cache.ckv.dtype)),
        kpe=cache.kpe.index_copy(1, slots, kpe.to(cache.kpe.dtype)),
        next_pos=positions[-1] + 1,
    )
    y = _mla_attend(params, q_nope, q_pe, new.ckv, new.kpe, positions, _full_kv_pos(new.next_pos, S), cfg)
    return y, new
