"""Layer stacks: the attention family, the SSM stack and the hybrid stack.

The counterpart of ``repro.models.transformer``. Layer weights are stacked
``[L, ...]`` as in the reference; a stack runs its layers in turn (the
reference's ``lax.scan``), each under the remat policy ``cfg.remat``:

  * ``"full"``: the layer is a ``torch.utils.checkpoint`` region and saves
    only its input; the backward pass recomputes it;
  * ``"block"``: a selective checkpoint that saves the outputs of the
    weight matmuls (``aten.mm``: the products without a batch dim, the
    reference's ``dots_with_no_batch_dims_saveable``) and recomputes the rest;
  * ``"none"``: no recompute.

Families:

  * dense / vlm / moe / encoder (gemma-2b, yi-6b, chameleon-34b,
    nemotron-4-340b, hubert-xlarge, minicpm3-4b, grok-1-314b,
    mixtral-8x22b): pre-norm attention (GQA/MQA/SWA, or MLA for minicpm3)
    + a pre-norm MLP, or MoE for grok and mixtral (its metrics, meaned
    over layers, are the stack's; other layers give zeros). With
    ``cfg.remat_group = g > 1`` (and no cache) each group of g layers is one
    checkpoint region whose layers are checkpointed again inside it, so the
    group's recompute does not keep every layer's activations at once;
  * ssm (mamba2-130m): a pre-norm mamba2 mixer per layer, no MLP;
  * hybrid (zamba2-2.7b): the mamba2 layers in ``A = num_layers /
    shared_attn_every`` segments, with ONE shared attention + MLP block
    (one weight set) applied at the start of every segment, each
    application with its own KV cache. A segment is one checkpoint region
    whose mamba2 layers are checkpointed again, as the reference's.

Decode caches are dataclasses whose fields carry leading layer dims, as the
reference's stacked cache pytrees: one :class:`KVCache` ``[L, ...]`` for the
attention family (an :class:`MLACache` for MLA), one :class:`SSMState`
``[L, ...]`` for the SSM stack, and a :class:`HybridCache` (``ssm``
``[A, k, ...]``, ``attn`` ``[A, ...]``).

Under ``remat="block"`` the expert products are batched (``bmm`` over the
experts), so they are recomputed, not saved, as the reference's
``dots_with_no_batch_dims_saveable`` treats its expert einsums.

Over a mesh (``ctx``) the residual stream is this rank's rows of the batch,
whole along ``d_model`` (the reference's ``("batch", "seq", "act_embed")``
constraints hold by construction), and a recomputed region re-issues its
collectives in the same order on every rank. The reference's
``pin_group`` constrains a remat group's weights to their storage spec so
their gradients stay sharded; here a layer's weights are the stored shards
themselves, and ``ctx.weight``'s backward already reduce-scatters each
gradient to its shard.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models.attention import (
    KVCache,
    MLACache,
    apply_attention,
    apply_mla,
    desc_attention,
    init_kv_cache,
    init_mla_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, desc_mlp, desc_norm
from repro_torch.models.mamba2 import SSMState, apply_mamba2, desc_mamba2, init_ssm_state
from repro_torch.models.moe import apply_moe, desc_moe
from repro_torch.models.module import NO_SHARDING, ShardingCtx, stacked

Tree = Any

METRIC_NAMES = ("aux_loss", "router_z", "drop_fraction")


def zero_metrics(device: torch.device | str = "cpu") -> dict:
    """The MoE metrics of a layer without experts: float32 zeros."""
    return {name: torch.zeros((), dtype=torch.float32, device=device) for name in METRIC_NAMES}


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def desc_layer(cfg: ModelConfig) -> dict:
    """Descriptor tree for ONE layer of the homogeneous stack."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": desc_norm(cfg), "mixer": desc_mamba2(cfg)}
    out = {"ln_attn": desc_norm(cfg), "attn": desc_attention(cfg), "ln_mlp": desc_norm(cfg)}
    if cfg.num_experts:
        out["moe"] = desc_moe(cfg)
    else:
        out["mlp"] = desc_mlp(cfg)
    return out


def desc_shared_block(cfg: ModelConfig) -> dict:
    """zamba2's single shared transformer block (attention + MLP)."""
    return {"ln_attn": desc_norm(cfg), "attn": desc_attention(cfg), "ln_mlp": desc_norm(cfg),
            "mlp": desc_mlp(cfg)}


def desc_stack(cfg: ModelConfig) -> dict:
    """The stacked layers (every leaf of :func:`desc_layer` with a leading ``[num_layers]`` dim),
    and the hybrid's ``"shared"`` block."""
    out = {"layers": stacked(desc_layer(cfg), cfg.num_layers)}
    if cfg.family == "hybrid" and cfg.shared_attn_every > 0:
        out["shared"] = desc_shared_block(cfg)
    return out


# ---------------------------------------------------------------------------
# Layer body and remat
# ---------------------------------------------------------------------------


def _attn_fn(cfg: ModelConfig) -> Callable:
    return apply_mla if cfg.attention == "mla" else apply_attention


def apply_attn_layer(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    cache: Optional[KVCache | MLACache],
) -> tuple[torch.Tensor, Optional[KVCache | MLACache], dict]:
    """Pre-norm attention + MLP/MoE block. Returns (x, cache', moe_metrics)."""
    h = apply_norm(params["ln_attn"], x, cfg)
    a, new_cache = _attn_fn(cfg)(params["attn"], h, positions, cfg, ctx, cache)
    x = x + a
    h = apply_norm(params["ln_mlp"], x, cfg)
    if cfg.num_experts:
        m, metrics = apply_moe(params["moe"], h, cfg, ctx)
    else:
        m, metrics = apply_mlp(params["mlp"], h, cfg, ctx), zero_metrics(x.device)
    return x + m, new_cache, metrics


def apply_ssm_layer(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    state: Optional[SSMState],
    return_state: bool,
) -> tuple[torch.Tensor, Optional[SSMState]]:
    """Pre-norm mamba2 mixer with a residual. Returns (x, state')."""
    h = apply_norm(params["ln"], x, cfg)
    y, new_state = apply_mamba2(params["mixer"], h, cfg, ctx, state, return_state)
    return x + y, new_state


# the products of x with a weight: what "block" remat saves
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat`` (module docstring); plain ``fn`` when autograd is off."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        context_fn = None
    elif cfg.remat == "block":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_weight_products)
    else:
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return run


def _unstack(tree: Tree, n: int) -> list[Tree]:
    """Per-layer views of a stacked tree of dicts and cache dataclasses (``unbind``: one ``stack`` in
    the backward pass, not n copies). ``None`` gives n ``None``s; a static field is repeated."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    if dataclasses.is_dataclass(tree):
        per_field = {f.name: _unstack(getattr(tree, f.name), n) for f in dataclasses.fields(tree)}
        return [dataclasses.replace(tree, **{k: v[i] for k, v in per_field.items()}) for i in range(n)]
    return [tree] * n


def _stack(trees: list[Tree]) -> Tree:
    """The inverse of :func:`_unstack`: a leading dim of ``len(trees)`` on every tensor."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(
            first, **{f.name: _stack([getattr(t, f.name) for t in trees]) for f in dataclasses.fields(first)})
    return first


def _mean_metrics(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


# ---------------------------------------------------------------------------
# Attention-family stack
# ---------------------------------------------------------------------------


def _apply_attn_stack(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    caches: Optional[KVCache | MLACache],
) -> tuple[torch.Tensor, Optional[KVCache | MLACache], dict]:
    L = cfg.num_layers
    layers = _unstack(params["layers"], L)

    def body(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, dict]:
        x, _, metrics = apply_attn_layer(p, x, positions, cfg, ctx, None)
        return x, metrics

    g = cfg.remat_group
    if caches is None and g > 1 and L % g == 0:
        inner = _remat(body, cfg)

        def group_body(x: torch.Tensor, *group: dict) -> tuple[torch.Tensor, dict]:
            mets = []
            for p in group:
                x, m = inner(x, p)
                mets.append(m)
            return x, _mean_metrics(mets)

        group_body = _remat(group_body, cfg)
        mets = []
        for i in range(0, L, g):
            x, m = group_body(x, *layers[i : i + g])
            mets.append(m)
        return x, None, _mean_metrics(mets)

    if caches is None:
        step = _remat(body, cfg)
        mets = []
        for p in layers:
            x, m = step(x, p)
            mets.append(m)
        return x, None, _mean_metrics(mets)

    def cached(p: dict, x: torch.Tensor, cache: Tree) -> tuple[torch.Tensor, Tree, dict]:
        return apply_attn_layer(p, x, positions, cfg, ctx, cache)

    step = _remat(cached, cfg)
    new_caches, mets = [], []
    for p, cache in zip(layers, _unstack(caches, L)):
        x, nc, m = step(p, x, cache)
        new_caches.append(nc)
        mets.append(m)
    return x, _stack(new_caches), _mean_metrics(mets)


# ---------------------------------------------------------------------------
# SSM stack
# ---------------------------------------------------------------------------


def _ssm_layer_step(cfg: ModelConfig, ctx: ShardingCtx, return_state: bool) -> Callable:
    """One mamba2 layer under ``cfg.remat``: (x, params, state) -> (x, state')."""
    return _remat(lambda x, p, st: apply_ssm_layer(p, x, cfg, ctx, st, return_state), cfg)


def _apply_ssm_stack(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    states: Optional[SSMState],  # stacked [L, ...] or None
    return_state: bool,
) -> tuple[torch.Tensor, Optional[SSMState]]:
    L = cfg.num_layers
    step = _ssm_layer_step(cfg, ctx, return_state)
    new_states = []
    for p, st in zip(_unstack(params["layers"], L), _unstack(states, L)):
        x, ns = step(x, p, st)
        new_states.append(ns)
    return x, (_stack(new_states) if new_states[0] is not None else None)


# ---------------------------------------------------------------------------
# Hybrid (zamba2) stack: segments of [shared attn block + k mamba layers]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HybridCache:
    """Decode state for the hybrid stack: per-layer SSM states stacked
    [A, k, ...] + per-application shared-attention KV caches stacked [A, ...]."""

    ssm: SSMState
    attn: KVCache


def _segments(cfg: ModelConfig) -> tuple[int, int]:
    """(A segments, k mamba layers per segment)."""
    k = cfg.shared_attn_every
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} does not divide into segments of {k}")
    return cfg.num_layers // k, k


def _apply_hybrid_stack(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    caches: Optional[HybridCache],
    return_state: bool,
) -> tuple[torch.Tensor, Optional[HybridCache]]:
    A, k = _segments(cfg)
    layers = _unstack(params["layers"], cfg.num_layers)
    shared = params["shared"]

    # nested remat, as the reference's: the checkpointed segment's recompute
    # must not keep every inner layer's activations at once
    inner = _ssm_layer_step(cfg, ctx, return_state)

    def seg_body(x: torch.Tensor, attn_cache: Optional[KVCache], ssm_seg: Optional[SSMState],
                 *p_seg: dict) -> tuple[torch.Tensor, Optional[SSMState], Optional[KVCache]]:
        x, new_attn, _ = apply_attn_layer(shared, x, positions, cfg, ctx, attn_cache)
        new_ssm = []
        for p, st in zip(p_seg, _unstack(ssm_seg, k)):
            x, ns = inner(x, p, st)
            new_ssm.append(ns)
        return x, (_stack(new_ssm) if new_ssm[0] is not None else None), new_attn

    seg_body = _remat(seg_body, cfg)
    ssm_in = _unstack(caches.ssm if caches is not None else None, A)
    attn_in = _unstack(caches.attn if caches is not None else None, A)
    ssm_out, attn_out = [], []
    for a in range(A):
        x, ns, na = seg_body(x, attn_in[a], ssm_in[a], *layers[a * k : (a + 1) * k])
        ssm_out.append(ns)
        attn_out.append(na)
    if ssm_out[0] is None or attn_out[0] is None:
        return x, None
    return x, HybridCache(ssm=_stack(ssm_out), attn=_stack(attn_out))


# ---------------------------------------------------------------------------
# Public stack API
# ---------------------------------------------------------------------------


def apply_stack(
    params: dict,
    x: torch.Tensor,  # [B, L, D] embedded inputs
    positions: torch.Tensor,  # [L] int32
    cfg: ModelConfig,
    ctx: ShardingCtx = NO_SHARDING,
    caches: Optional[Tree] = None,
    return_state: bool = False,
) -> tuple[torch.Tensor, Optional[Tree], dict]:
    """Run the full layer stack. Returns (hidden, caches', metrics).

    ``caches``: None = stateless forward (training / encoder); a stacked
    cache = prefill (L>1) or decode (L=1) step. For the SSM and hybrid
    stacks, ``return_state=True`` without caches builds the decode state
    from the parallel form (the hybrid then returns ``None``: it has no KV
    cache to fill, as the reference's). The attention stack has no such state.
    """
    if cfg.family == "ssm":
        want_state = caches is not None or return_state
        x, new_states = _apply_ssm_stack(params, x, cfg, ctx, caches, want_state)
        return x, new_states, zero_metrics(x.device)
    if cfg.family == "hybrid":
        want_state = caches is not None or return_state
        x, new_caches = _apply_hybrid_stack(params, x, positions, cfg, ctx, caches, want_state)
        return x, new_caches, zero_metrics(x.device)
    return _apply_attn_stack(params, x, positions, cfg, ctx, caches)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: str | torch.device = "cpu") -> Optional[Tree]:
    """Zero-initialized stacked decode caches for the whole stack (``None`` for an encoder)."""
    if cfg.is_encoder:
        return None
    if cfg.family == "ssm":
        return _stack([init_ssm_state(cfg, batch, device)] * cfg.num_layers)
    if cfg.family == "hybrid":
        A, k = _segments(cfg)
        ssm = _stack([_stack([init_ssm_state(cfg, batch, device)] * k)] * A)
        return HybridCache(ssm=ssm, attn=_stack([init_kv_cache(cfg, batch, max_len, device=device)] * A))
    if cfg.attention == "mla":
        return _stack([init_mla_cache(cfg, batch, max_len, device=device)] * cfg.num_layers)
    return _stack([init_kv_cache(cfg, batch, max_len, device=device)] * cfg.num_layers)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> Optional[Tree]:
    """The cache tree of :func:`init_caches` on the ``meta`` device, for the dry run (``None`` for an encoder)."""
    return init_caches(cfg, batch, max_len, "meta")
