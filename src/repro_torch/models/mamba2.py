"""Mamba2 / SSD (state-space duality) mixer, chunked.

The counterpart of ``repro.models.mamba2``. The SSD recurrence
``S_t = a_t S_{t-1} + dt_t x_t B_t^T``, ``y_t = C_t S_t + D x_t``
(``a_t = exp(dt_t * A_h)``, a per-head scalar decay) is evaluated chunk-wise
(arXiv:2405.21060 §6): within a chunk of Q tokens a quadratic
"attention-like" form, across chunks a ``[B, H, P, N]`` state.

The reference scans the chunks one at a time (``lax.scan``). Here every
chunk's intra-chunk terms (the decay matrix, ``C Bᵀ``, the chunk's own
contribution to the state) are computed in one batched op each, and only
the small state is carried through the chunks in a Python loop: the same
arithmetic within each chunk, in ~16 launches per chunk fewer. At zamba2's
full width that batches a ``[1, 16, 80, 256, 256]`` float32 decay matrix
(335 MB per layer, recomputed under remat).

Cast points are the reference's: all decay math in float32; ``M = C Bᵀ ∘
L`` and ``dt·x`` cast to the activation dtype and multiplied with a float32
result (``_bmm_f32``, the reference's ``preferred_element_type``); the
inter-chunk term and the state update in float32 throughout. One change:
the decay matrix is masked *before* its ``exp`` (``exp(-inf) = 0``), where
the reference masks after it. The values are the same; the reference's
gradient is NaN once a chunk's decay passes ``e^88`` (``0 * inf`` in the
masked half), which a 256-token chunk reaches at random init.

Decode is the O(1) recurrence step on a ``[B, H, P, N]`` state plus a
depthwise-conv window of the last ``K - 1`` inputs.

Over a mesh (``ctx``) the in-projection's ``[x | B | C]`` output channels
split over ``inner``'s axes: the causal conv (per channel) runs on this
rank's channels (and a decode window of them), and the conv's output is
gathered, since the split after it crosses channel shards. The SSD runs on
this rank's heads (``ssm_heads``, with the B and C groups they read), the
gated norm's mean of squares is summed over the heads' axes, and the
out-projection's partial sums over its ``inner`` axes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _bmm_f32, _groups_for_heads
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import NO_SHARDING, PartitionSpec, ShardingCtx, desc, fan_in_desc


@dataclasses.dataclass(frozen=True)
class SSMState:
    """Per-layer decode state: SSD state + causal-conv window.

    A stack of states (one per layer) has leading layer dims on every field.
    """

    S: torch.Tensor  # [B, H, P, N] fp32
    conv: torch.Tensor  # [B, d_conv - 1, conv_dim] activation dtype
    next_pos: torch.Tensor  # [] int32


def conv_dim(cfg: ModelConfig) -> int:
    """Channels of the causal conv: x, B and C (``d_inner + 2·G·N``)."""
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def desc_mamba2(cfg: ModelConfig) -> dict:
    """One mixer's weights, the in-projection split ``w_z | w_xBC | w_dt`` as the reference's."""
    pd = cfg.dtype("param")
    D, di = cfg.d_model, cfg.d_inner
    H = cfg.ssm_heads
    cd = conv_dim(cfg)
    return {
        "w_z": fan_in_desc((D, di), ("embed", "inner"), D, pd),
        "w_xBC": fan_in_desc((D, cd), ("embed", "inner"), D, pd),
        "w_dt": fan_in_desc((D, H), ("embed", "ssm_heads"), D, pd),
        "conv_w": desc((cfg.ssm_conv, cd), ("conv", "inner"), scale=0.5, dtype=pd),
        "conv_b": desc((cd,), ("inner",), init="zeros", dtype=pd),
        "A_log": desc((H,), ("ssm_heads",), init="normal", scale=0.5, dtype=torch.float32),
        "dt_bias": desc((H,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "D": desc((H,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "norm_scale": desc((di,), ("inner",), init="ones", dtype=pd),
        "out_proj": fan_in_desc((di, D), ("inner", "embed"), di, pd),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, device: str | torch.device = "cpu") -> SSMState:
    """A zero state for ``batch`` sequences."""
    return SSMState(
        S=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)), dtype=cfg.dtype("act"), device=device),
        next_pos=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # [B, L, H, P] (activation dtype)
    dt: torch.Tensor,  # [B, L, H] fp32, post-softplus
    A: torch.Tensor,  # [H] fp32, negative
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, L, H, P], final_state [B, H, P, N]).

    L must be a multiple of ``chunk`` (callers pad). All decay math in fp32.
    B and C stay ``[.., G, N]``: head h reads group ``h // (H / G)`` (the
    reference's ``jnp.repeat``) through the batched products' shapes.
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = chunk
    nc = L // Q
    ad = x.dtype

    # [B, nc, H, Q]: inclusive cumulative log-decay within each chunk
    log_a = (dt * A).reshape(Bsz, nc, Q, H).transpose(2, 3)
    ell = torch.cumsum(log_a, dim=-1)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()  # i >= j
    seg = ell[..., :, None] - ell[..., None, :]  # [B, nc, H, Q(i), Q(j)]
    Lmat = torch.exp(torch.where(tri, seg, float("-inf")))

    Bg = Bm.float().reshape(Bsz, nc, Q, G, N).transpose(2, 3)  # [B, nc, G, Q, N]
    Cg = Cm.float().reshape(Bsz, nc, Q, G, N).transpose(2, 3)
    CB = Cg @ Bg.transpose(-1, -2)  # [B, nc, G, Q, Q]
    M = (CB[:, :, :, None] * Lmat.reshape(Bsz, nc, G, rep, Q, Q)).to(ad)  # [B, nc, G, rep, Q, Q]
    dtx = (dt[..., None] * x.float()).to(ad).reshape(Bsz, nc, Q, H, P).transpose(2, 3)  # [B, nc, H, Q, P]
    y_intra = _bmm_f32(M.reshape(-1, Q, Q), dtx.reshape(-1, Q, P)).view(Bsz, nc, H, Q, P)

    # each chunk's own contribution to the state it hands on: Σ_q B_q w_q x_qᵀ
    ell_last = ell[..., -1]  # [B, nc, H]
    w = torch.exp(ell_last[..., None] - ell) * dt.reshape(Bsz, nc, Q, H).transpose(2, 3)  # [B, nc, H, Q]
    xw = x.float().reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 4, 2) * w[:, :, :, None, :]  # [B, nc, H, P, Q]
    S_chunk = (xw.reshape(Bsz, nc, G, rep * P, Q) @ Bg).view(Bsz, nc, H, P, N)

    # the state entering each chunk, carried in order
    S = initial_state if initial_state is not None else x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
    decay = torch.exp(ell_last)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)  # [B, nc, H, P, N]

    # the entering state decayed to each position: C_q S_inᵀ exp(ell_q)
    y_inter = Cg @ S_in.reshape(Bsz, nc, G, rep * P, N).transpose(-1, -2)  # [B, nc, G, Q, rep*P]
    y_inter = y_inter.view(Bsz, nc, G, Q, rep, P).permute(0, 1, 2, 4, 3, 5).reshape(Bsz, nc, H, Q, P)
    y_inter = y_inter * torch.exp(ell)[..., None]
    y = (y_intra + y_inter).to(ad).transpose(2, 3).reshape(Bsz, L, H, P)
    return y, S


def ssd_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H] fp32 post-softplus
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, G, N]
    Cm: torch.Tensor,  # [B, G, N]
    S: torch.Tensor,  # [B, H, P, N] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. Returns (y [B, H, P], S')."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()  # [B, H, N]
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    a = torch.exp(dt * A)  # [B, H]
    upd = dt[..., None, None] * x.float()[..., None] * Bh[:, :, None, :]
    S_new = a[..., None, None] * S + upd
    y = (S_new @ Ch[..., None])[..., 0]
    return y.to(x.dtype), S_new


# ---------------------------------------------------------------------------
# Naive reference (test oracle)
# ---------------------------------------------------------------------------


def ssd_reference(x, dt, A, Bm, Cm, initial_state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence in fp32: the oracle for the chunked form."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    S = (initial_state.float() if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(L):
        y, S = ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


# ---------------------------------------------------------------------------
# Full mixer block
# ---------------------------------------------------------------------------


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, L, C] with kernel [K, C]; fp32 sums over the K taps, one cast."""
    K = w.shape[0]
    L = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for k in range(K):  # K = 4: unrolled adds, as the reference's
        out = out + pad[:, k : k + L].float() * w[k].float()
    return (out + b.float()).to(xBC.dtype)


def _pad_seq(t: torch.Tensor, to: int) -> torch.Tensor:
    """``t`` zero-padded along dim 1 to length ``to``."""
    pad = [0, 0] * (t.dim() - 2) + [0, to - t.shape[1]]
    return F.pad(t, pad)


def _channels(axes: tuple[str, ...]) -> PartitionSpec:
    """The layout of a [B, L, channels] tensor whose channels split over ``axes``."""
    return PartitionSpec.of(None, None, axes)


def apply_mamba2(
    params: dict,
    x: torch.Tensor,  # [B, L, D]
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
    state: Optional[SSMState] = None,
    return_state: bool = False,
) -> tuple[torch.Tensor, Optional[SSMState]]:
    """Full mixer. Without ``state``: chunked parallel form over L (train /
    prefill; ``return_state=True`` also builds the decode state). With
    ``state`` and L == 1: the O(1) decode step. With ``state`` and L > 1
    (a prefill from a state): the SSD starts from ``state.S`` and the conv
    from zeros (``state.conv`` is not read), as the reference's."""
    ad = cfg.dtype("act")
    Bsz, L, _ = x.shape
    di, H, P, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    d = desc_mamba2(cfg)

    xa = x.to(ad)
    z = xa @ ctx.weight(params["w_z"].to(ad), d["w_z"])  # channels split over z_ax
    xBC = xa @ ctx.weight(params["w_xBC"].to(ad), d["w_xBC"])  # [x | B | C] channels split over c_ax
    dt_raw = xa @ ctx.weight(params["w_dt"].to(ad), d["w_dt"])  # heads split over h_ax
    z_ax, c_ax, h_ax = (ctx.weight_axes(d[n], 1) for n in ("w_z", "w_xBC", "w_dt"))
    conv_w, conv_b = ctx.weight(params["conv_w"], d["conv_w"]), ctx.weight(params["conv_b"], d["conv_b"])
    H_l = dt_raw.shape[-1]
    h0 = ctx.index(h_ax) * H_l
    A = -torch.exp(ctx.weight(params["A_log"], d["A_log"]).float())

    decode = state is not None and L == 1
    if decode:
        window = torch.cat([state.conv, xBC], dim=1)  # [B, K, cd]
        conv_out = ((window.float() * conv_w.float()).sum(dim=1) + conv_b.float()).to(ad)[:, None, :]
        new_conv = window[:, 1:, :]
    else:
        conv_out = _causal_conv(xBC, conv_w, conv_b)
        new_conv = None
        if return_state:
            K = cfg.ssm_conv
            tail = xBC[:, -(K - 1) :, :]
            new_conv = F.pad(tail, (0, 0, (K - 1) - tail.shape[1], 0))  # left-padded when L < K - 1
    xBC = ctx.relayout(F.silu(conv_out), _channels(c_ax), PartitionSpec())  # every channel: the split crosses shards

    x_ssm = xBC[..., :di].reshape(Bsz, L, H, P)[:, :, h0 : h0 + H_l]
    rep = H // G
    Bm = _groups_for_heads(xBC[..., di : di + G * N].reshape(Bsz, L, G, N), 2, H_l, h0, 0, rep)
    Cm = _groups_for_heads(xBC[..., di + G * N :].reshape(Bsz, L, G, N), 2, H_l, h0, 0, rep)
    dt = F.softplus(dt_raw.float() + ctx.weight(params["dt_bias"], d["dt_bias"]))  # [B, L, H_l]

    if decode:
        y, S_new = ssd_step(x_ssm[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], state.S)
        y = y[:, None]
        new_state = SSMState(S=S_new, conv=new_conv, next_pos=state.next_pos + 1)
    else:
        S0 = state.S if state is not None else None
        pad_to = -(-L // cfg.ssm_chunk) * cfg.ssm_chunk
        if pad_to != L:  # padded positions have dt = 0: they leave the state as it is
            y, S_new = ssd_chunked(_pad_seq(x_ssm, pad_to), _pad_seq(dt, pad_to), A, _pad_seq(Bm, pad_to),
                                   _pad_seq(Cm, pad_to), cfg.ssm_chunk, S0)
            y = y[:, :L]
        else:
            y, S_new = ssd_chunked(x_ssm, dt, A, Bm, Cm, cfg.ssm_chunk, S0)
        new_state = None
        if return_state:
            start = (state.next_pos if state is not None
                     else torch.zeros((), dtype=torch.int32, device=x.device))
            new_state = SSMState(S=S_new, conv=new_conv, next_pos=start + L)

    D_skip = ctx.weight(params["D"], d["D"])
    y = y + D_skip.float()[None, None, :, None] * x_ssm.float()
    y = y.reshape(Bsz, L, H_l * P).to(ad)  # channels of this rank's heads: split over h_ax
    gated = y * F.silu(ctx.relayout(z, _channels(z_ax), _channels(h_ax)).float()).to(ad)
    scale = ctx.relayout(ctx.weight(params["norm_scale"], d["norm_scale"]),
                         PartitionSpec.of(ctx.weight_axes(d["norm_scale"], 0)), PartitionSpec.of(h_ax))
    if h_ax:  # the gated norm's mean of squares over every head
        gf = gated.float()
        ms = ctx.psum(gf.square().sum(-1, keepdim=True), h_ax) / di
        y = (gf * torch.rsqrt(ms + 1e-6) * scale.float()).to(ad)
    else:
        y = rms_norm(gated, scale)
    o_ax = ctx.weight_axes(d["out_proj"], 0)
    out = ctx.relayout(y, _channels(h_ax), _channels(o_ax)) @ ctx.weight(params["out_proj"].to(ad), d["out_proj"])
    return ctx.psum(out, o_ax), new_state
