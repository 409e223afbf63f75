"""Shared layer primitives: norms, rotary embeddings, MLP variants, embeddings.

The counterpart of ``repro.models.layers``. Every layer is a pair
(``desc_x(cfg) -> descriptor tree``, ``apply_x(params, ...) -> tensor``).
Norm statistics are taken in float32 and the output keeps the input's
dtype; matmuls run in ``cfg.activation_dtype`` as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import desc, fan_in_desc

# the value the padded vocabulary tail (and a masked attention logit) takes
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def desc_norm(cfg: ModelConfig, dim: int | None = None) -> dict:
    """Scale (and, for LayerNorm, bias) of one norm over ``dim`` (default d_model)."""
    d = dim or cfg.d_model
    out = {"scale": desc((d,), ("act_embed",), init="ones", dtype=cfg.dtype("param"))}
    if cfg.norm == "layernorm":
        out["bias"] = desc((d,), ("act_embed",), init="zeros", dtype=cfg.dtype("param"))
    return out


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm; stats in fp32, output in input dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the last dim with a learned ``scale``; stats in fp32, output in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (fp32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate [..., seq, heads, head_dim] by per-position angles.

    ``positions``: [..., seq] int32. Split-half convention (llama).
    """
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [half]
    angles = positions[..., None].float() * freqs  # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / GeGLU / squared-ReLU / GELU
# ---------------------------------------------------------------------------


def desc_mlp(cfg: ModelConfig, d_model: int | None = None, d_ff: int | None = None) -> dict:
    """Up and down projections, and the gate of a gated MLP (swiglu, geglu)."""
    dm = d_model or cfg.d_model
    df = d_ff or cfg.d_ff
    pd = cfg.dtype("param")
    out = {
        "w_up": fan_in_desc((dm, df), ("embed", "mlp"), dm, pd),
        "w_down": fan_in_desc((df, dm), ("mlp", "embed"), df, pd),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        out["w_gate"] = fan_in_desc((dm, df), ("embed", "mlp"), dm, pd)
    return out


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[..., d_model] -> [..., d_model]; activations in cfg.activation_dtype."""
    ad = cfg.dtype("act")
    x = x.to(ad)
    up = x @ params["w_up"].to(ad)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ params["w_gate"].to(ad)) * up
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ params["w_gate"].to(ad), approximate="tanh") * up
    elif cfg.mlp == "relu2":  # nemotron squared-ReLU
        h = torch.square(F.relu(up))
    elif cfg.mlp == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return h @ params["w_down"].to(ad)


# ---------------------------------------------------------------------------
# Embeddings + output head
# ---------------------------------------------------------------------------


def desc_embed(cfg: ModelConfig) -> dict:
    """The token table [padded_vocab, d_model], or the frames projection stub."""
    pd = cfg.dtype("param")
    if cfg.input_mode == "tokens":
        # padded to vocab_pad_multiple; apply_lm_head masks the padded tail
        return {"tok": desc((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0, dtype=pd)}
    # frames: a projection stub standing in for the modality frontend
    return {"frame_proj": fan_in_desc((cfg.frame_dim, cfg.d_model), ("embed_out", "embed"), cfg.frame_dim, pd)}


def apply_embed(params: dict, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids [B, L] (or frames [B, L, frame_dim]) -> [B, L, d_model] in the activation dtype."""
    ad = cfg.dtype("act")
    if cfg.input_mode == "tokens":
        # gather, then cast: the rows of the cast table, without casting all of it
        return F.embedding(inputs.long(), params["tok"]).to(ad)
    return inputs.to(ad) @ params["frame_proj"].to(ad)


def desc_lm_head(cfg: ModelConfig) -> dict:
    """The output projection [d_model, padded_vocab]; empty when tied to the embedding."""
    if cfg.tie_embeddings:
        return {}
    pd = cfg.dtype("param")
    return {"w": fan_in_desc((cfg.d_model, cfg.padded_vocab), ("embed_out", "vocab"), cfg.d_model, pd)}


def apply_lm_head(params: dict, embed_params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm'd hidden states -> logits [..., padded_vocab] (fp32).

    The product runs in the activation dtype and is then widened, as the
    reference's. Logits are soft-capped when ``cfg.logits_softcap > 0``.
    Padded vocab entries are set to NEG_INF so they carry no softmax mass;
    callers may slice [..., :vocab_size] when handing logits to users.
    """
    ad = cfg.dtype("act")
    w = embed_params["tok"].to(ad).t() if cfg.tie_embeddings else params["w"].to(ad)
    logits = (x.to(ad) @ w).float()
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        keep = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, NEG_INF)
    return logits
