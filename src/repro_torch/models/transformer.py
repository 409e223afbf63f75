"""The attention-family layer stack: pre-norm attention + MLP blocks.

The counterpart of ``repro.models.transformer`` for the dense, vlm and
encoder families (gemma-2b, yi-6b, chameleon-34b, nemotron-4-340b,
hubert-xlarge). Layer weights are stacked ``[L, ...]`` as in the reference;
the stack runs its layers in turn (the reference's ``lax.scan``), each
under the remat policy ``cfg.remat``:

  * ``"full"``: the layer is a ``torch.utils.checkpoint`` region and saves
    only its input; the backward pass recomputes it;
  * ``"block"``: a selective checkpoint that saves the outputs of the
    weight matmuls (``aten.mm``: the products without a batch dim, the
    reference's ``dots_with_no_batch_dims_saveable``) and recomputes the rest;
  * ``"none"``: no recompute.

With ``cfg.remat_group = g > 1`` (and no cache) each group of g layers is
one checkpoint region whose layers are checkpointed again inside it, so the
group's recompute does not keep every layer's activations at once. MoE
(ROADMAP Queue 1 item 11b), MLA (item 11c) and the SSM and hybrid stacks
(item 11d) are not here yet: they raise ``NotImplementedError``.

Decode caches are one :class:`KVCache` whose fields carry a leading layer
dim, as the reference's stacked cache pytrees.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models.attention import KVCache, apply_attention, desc_attention, init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, apply_norm, desc_mlp, desc_norm
from repro_torch.models.module import stacked

Tree = Any

METRIC_NAMES = ("aux_loss", "router_z", "drop_fraction")


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why ``cfg`` cannot build a model here yet (the ROADMAP item that ports it), or ``None``."""
    if cfg.family in ("ssm", "hybrid"):
        return f"{cfg.name}: the SSM and hybrid stacks are ported with ROADMAP Queue 1 item 11d"
    if cfg.num_experts:
        return f"{cfg.name}: MoE layers are ported with ROADMAP Queue 1 item 11b"
    if cfg.attention == "mla":
        return f"{cfg.name}: MLA attention is ported with ROADMAP Queue 1 item 11c"
    return None


def _require_ported(cfg: ModelConfig) -> None:
    why = unported(cfg)
    if why is not None:
        raise NotImplementedError(why)


def zero_metrics(device: torch.device | str = "cpu") -> dict:
    """The MoE metrics of a layer without experts: float32 zeros."""
    return {name: torch.zeros((), dtype=torch.float32, device=device) for name in METRIC_NAMES}


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def desc_layer(cfg: ModelConfig) -> dict:
    """Descriptor tree for ONE layer of the homogeneous stack."""
    _require_ported(cfg)
    return {"ln_attn": desc_norm(cfg), "attn": desc_attention(cfg), "ln_mlp": desc_norm(cfg),
            "mlp": desc_mlp(cfg)}


def desc_stack(cfg: ModelConfig) -> dict:
    """The stacked layers: every leaf of :func:`desc_layer` with a leading ``[num_layers]`` dim."""
    return {"layers": stacked(desc_layer(cfg), cfg.num_layers)}


# ---------------------------------------------------------------------------
# Layer body and remat
# ---------------------------------------------------------------------------


def apply_attn_layer(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[KVCache],
) -> tuple[torch.Tensor, Optional[KVCache], dict]:
    """Pre-norm attention + MLP block. Returns (x, cache', moe_metrics)."""
    h = apply_norm(params["ln_attn"], x, cfg)
    a, new_cache = apply_attention(params["attn"], h, positions, cfg, cache)
    x = x + a
    h = apply_norm(params["ln_mlp"], x, cfg)
    x = x + apply_mlp(params["mlp"], h, cfg)
    return x, new_cache, zero_metrics(x.device)


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
    """Per-layer views of a stacked tree (``unbind``: one ``stack`` in the backward pass, not n copies)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    per_key = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per_key[k][i] for k in tree} for i in range(n)]


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
    caches: Optional[KVCache],
) -> tuple[torch.Tensor, Optional[KVCache], dict]:
    L = cfg.num_layers
    layers = _unstack(params["layers"], L)

    def body(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, dict]:
        x, _, metrics = apply_attn_layer(p, x, positions, cfg, None)
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

    def cached(p: dict, x: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache, dict]:
        return apply_attn_layer(p, x, positions, cfg, cache)

    step = _remat(cached, cfg)
    ks, vs, nps = caches.k.unbind(0), caches.v.unbind(0), caches.next_pos.unbind(0)
    new_k, new_v, new_pos, mets = [], [], [], []
    for i, p in enumerate(layers):
        cache = KVCache(k=ks[i], v=vs[i], next_pos=nps[i], rolling=caches.rolling)
        x, nc, m = step(p, x, cache)
        new_k.append(nc.k)
        new_v.append(nc.v)
        new_pos.append(nc.next_pos)
        mets.append(m)
    new_caches = KVCache(k=torch.stack(new_k), v=torch.stack(new_v), next_pos=torch.stack(new_pos),
                         rolling=caches.rolling)
    return x, new_caches, _mean_metrics(mets)


def apply_stack(
    params: dict,
    x: torch.Tensor,  # [B, L, D] embedded inputs
    positions: torch.Tensor,  # [L] int32
    cfg: ModelConfig,
    caches: Optional[KVCache] = None,
    return_state: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache], dict]:
    """Run the full layer stack. Returns (hidden, caches', metrics).

    ``caches``: None = stateless forward (training / encoder); a stacked
    cache = prefill (L>1) or decode (L=1) step. ``return_state`` is the
    reference's flag for SSM prefill; the attention stack has no such state.

    Raises:
        NotImplementedError: ``cfg`` is an MoE, MLA, SSM or hybrid config.
    """
    del return_state
    _require_ported(cfg)
    return _apply_attn_stack(params, x, positions, cfg, caches)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: str | torch.device = "cpu") -> Optional[KVCache]:
    """Zero-initialized stacked decode caches for the whole stack (``None`` for an encoder)."""
    _require_ported(cfg)
    if cfg.is_encoder:
        return None
    one = init_kv_cache(cfg, batch, max_len, device=device)
    rep = lambda t: t.expand(cfg.num_layers, *t.shape).clone()
    return KVCache(k=rep(one.k), v=rep(one.v), next_pos=rep(one.next_pos), rolling=one.rolling)
