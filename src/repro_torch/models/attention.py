"""Attention: GQA / MQA (kv=1) / SWA with dense and rolling KV caches.

The counterpart of ``repro.models.attention``, the GQA path:

  * GQA with arbitrary q-per-kv grouping (yi, nemotron, chameleon, hubert
    with kv == heads), MQA as GQA with ``num_kv_heads == 1`` (gemma);
  * qk-norm (chameleon's query/key norm);
  * sliding-window attention with a rolling KV cache of ``window`` slots;
  * a dense path that materializes the ``[Lq, S]`` logits, and a flash-style
    two-level schedule (Q blocks outer, a running ``(m, l, acc)`` over KV
    blocks inner) for longer sequences, as the reference's ``_attend_flash``.

MLA (``apply_mla``, ``MLACache``) is not here yet (ROADMAP Queue 1 item 11c).

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
    "init_kv_cache",
    "desc_attention",
    "attention_mask",
    "rolling_slot_positions",
    "apply_attention",
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


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def desc_attention(cfg: ModelConfig) -> dict:
    """Q, K, V, O projections (and the qk-norm scales) of one GQA layer."""
    if cfg.attention == "mla":
        raise NotImplementedError("MLA attention is ported with ROADMAP Queue 1 item 11c")
    pd = cfg.dtype("param")
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
        if L > W:
            raise ValueError(f"{L} tokens do not fit a cache of {W} slots")
        start = positions[0].long().clamp(0, W - L)
        slots = start + torch.arange(L, device=k.device)
    new = KVCache(
        k=cache.k.index_copy(1, slots, k.to(cache.k.dtype)),
        v=cache.v.index_copy(1, slots, v.to(cache.v.dtype)),
        next_pos=positions[-1] + 1,
        rolling=cache.rolling,
    )
    if cache.rolling:
        return new, rolling_slot_positions(new.next_pos, W)
    slot = torch.arange(W, dtype=torch.int32, device=k.device)
    return new, torch.where(slot < new.next_pos, slot, -1).to(torch.int32)


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
