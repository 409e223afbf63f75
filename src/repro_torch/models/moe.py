"""Top-k Mixture-of-Experts with capacity-based dispatch (GShard semantics).

The counterpart of ``repro.models.moe``. Tokens are split into groups (of
``MOE_GROUP`` when the sequence is a multiple of it, else one group per
sequence); within a group each token picks its top-k experts from fp32
router probabilities (renormalised over the k picks, as mixtral does), and
each expert takes at most C picks, C = max(8, ceil8(int(g·k·cf/E))).
Slots go to every token's first pick before any second pick, in token
order within each; a pick past its expert's C slots is dropped, and the
residual connection carries the token through.

The reference dispatches and combines with one-hot einsums, which suit the
TPU's matrix unit. Here the same function is computed by index: the kept
picks are gathered into one ``[E, groups·C, D]`` buffer (slot order and
drops as the reference's), the experts run as batched products over E, and
each token's output is the sum of its kept picks' outputs times their
weights, the weights rounded to the activation dtype first as the
reference's ``combine.astype(ad)``. Every (batch row, group) pair runs at
once, where the reference vmaps rows and scans groups. Ties in the router
probabilities go to the lower expert index, as ``jax.lax.top_k`` gives them
(a stable descending sort).

Over a mesh (``ctx``) the router and the expert bank are gathered for use
by ``ctx.weight`` (``experts`` is replicated under every rule table; the
experts' ``mlp`` dim splits over ``model`` under ``TRAIN_RULES``), routing,
slots, dispatch and combine run on this rank's rows, the output's partial
sums over a split ``mlp`` are summed over its axes, and each metric is
meaned over the batch's shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import NO_SHARDING, ShardingCtx, fan_in_desc

__all__ = ["MOE_GROUP", "desc_moe", "capacity", "apply_moe"]

MOE_GROUP = 2048  # tokens per dispatch group (divides every assigned seq_len)


def desc_moe(cfg: ModelConfig) -> dict:
    """Router [D, E] and the expert bank's stacked up/down (and gate) projections."""
    pd = cfg.dtype("param")
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    out = {
        "router": fan_in_desc((D, E), ("embed", None), D, pd),
        "w_up": fan_in_desc((E, D, F_), ("experts", "embed", "mlp"), D, pd),
        "w_down": fan_in_desc((E, F_, D), ("experts", "mlp", "embed"), F_, pd),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        out["w_gate"] = fan_in_desc((E, D, F_), ("experts", "embed", "mlp"), D, pd)
    return out


def _activation(h_gate: torch.Tensor | None, h_up: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return F.silu(h_gate) * h_up
    if cfg.mlp == "geglu":
        return F.gelu(h_gate, approximate="tanh") * h_up
    if cfg.mlp == "relu2":
        return torch.square(F.relu(h_up))
    return F.gelu(h_up, approximate="tanh")


def capacity(g: int, cfg: ModelConfig) -> int:
    """Slots per expert in a group of g tokens: max(8, int(g·k·cf/E) rounded up to 8)."""
    C = int(g * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-C // 8) * 8)


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """fp32 routing of groups ``xt`` [N, g, D]: (logits, probs [N,g,E], top_p, top_e [N,g,K])."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    return logits, probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in ``dtype``, as one zero fill and one scatter on every device.

    ``F.one_hot`` reads the indices' min and max back to the host on the CPU
    and builds the rows another way on ``meta``; this is what it runs on
    the card, with no host read anywhere.
    """
    return torch.zeros((*idx.shape, n), dtype=dtype, device=idx.device).scatter_(-1, idx.unsqueeze(-1), 1)


def _slots(top_e: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot [N, K, g] of each pick within its expert, keep [N, K, g]): the rank of the pick among
    the group's picks of the same expert, all k = 0 picks before all k = 1, in token order."""
    N, g, K = top_e.shape
    picks = top_e.transpose(1, 2).reshape(N, K * g)  # [N, K*g] in priority order
    onehot = _one_hot(picks, E, torch.int32)  # [N, K*g, E]
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(2, picks[..., None])[..., 0]
    return rank.view(N, K, g), (rank < C).view(N, K, g)


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, dict]:
    """Returns (y [B, L, D], metrics {aux_loss, router_z, drop_fraction}), each metric the mean over
    groups and batch rows. Groups never straddle batch rows; at decode (L = 1) each token is its own
    group with capacity >= k, so nothing is dropped."""
    ad = cfg.dtype("act")
    B, L, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    g = MOE_GROUP if L >= MOE_GROUP and L % MOE_GROUP == 0 else L
    N = B * (L // g)
    C = capacity(g, cfg)
    xt = x.reshape(N, g, D).to(ad)
    d = desc_moe(cfg)

    logits, probs, top_p, top_e = _route(xt, ctx.weight(params["router"].to(ad), d["router"]), cfg)
    rank, keep = _slots(top_e, E, C)
    e_kg = top_e.transpose(1, 2)  # [N, K, g]
    # slot -> token of each group ([N, E*C], g = empty: the zero row); dropped picks go to a spare column
    dest = torch.where(keep, e_kg * C + rank, E * C).reshape(N, K * g)
    token = torch.full((N, E * C + 1), g, dtype=torch.long, device=x.device)
    token.scatter_(1, dest, torch.arange(g, device=x.device).repeat(K).expand(N, -1))
    xt_pad = torch.cat([xt, xt.new_zeros(N, 1, D)], dim=1)  # [N, g + 1, D]
    expert_in = xt_pad.gather(1, token[:, : E * C, None].expand(-1, -1, D))  # [N, E*C, D]
    expert_in = expert_in.view(N, E, C, D).transpose(0, 1).reshape(E, N * C, D)

    h_up = torch.bmm(expert_in, ctx.weight(params["w_up"].to(ad), d["w_up"]))
    h_gate = torch.bmm(expert_in, ctx.weight(params["w_gate"].to(ad), d["w_gate"])) if "w_gate" in params else None
    expert_out = torch.bmm(_activation(h_gate, h_up, cfg), ctx.weight(params["w_down"].to(ad), d["w_down"]))

    # combine: each token's kept picks, weighted in the activation dtype, summed in fp32
    w = (top_p.transpose(1, 2) * keep).to(ad)  # [N, K, g]
    n_idx = torch.arange(N, device=x.device)[:, None, None]
    rows = torch.where(keep, e_kg * (N * C) + n_idx * C + rank, 0).reshape(-1)
    picked = expert_out.reshape(E * N * C, D).index_select(0, rows).view(N, K, g, D)
    y = ctx.psum((picked.float() * w[..., None].float()).sum(dim=1), ctx.weight_axes(d["w_down"], 1)).to(ad)

    me = probs.mean(dim=1)  # [N, E] mean router prob per expert
    ce = _one_hot(top_e[..., 0], E, torch.float32).mean(dim=1)  # [N, E] share of top-1 picks
    kept = keep.sum(dim=(1, 2)).float().to(ad)  # the reference sums its 0/1 dispatch in ad
    metrics = {
        "aux_loss": (E * (me * ce).sum(dim=-1)).mean(),
        "router_z": torch.square(torch.logsumexp(logits, dim=-1)).mean(dim=-1).mean(),
        "drop_fraction": ((1.0 - kept / (g * K)).float().sum() / N).to(ad),  # jnp.mean's sum / n
    }
    return y.view(B, L, D), {k: ctx.batch_mean(v) for k, v in metrics.items()}
