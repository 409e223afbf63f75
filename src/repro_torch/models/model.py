"""Config -> model: descriptors, forward passes and caches in one object.

The counterpart of ``repro.models.model``. The same :class:`LMModel` drives
training (``forward``, or ``hidden`` + ``logits`` for the chunked loss) and
inference (``prefill`` / ``decode``). Params and caches are passed
explicitly; the model holds only its config. A cache is the stack's cache
tree: a :class:`KVCache` for the attention family (an :class:`MLACache`
for MLA), an :class:`SSMState` for the SSM stack, a :class:`HybridCache`
for the hybrid. Over a mesh (ROADMAP Queue 1 item 9a) ``specs`` /
``shardings`` place the params and ``cache_specs`` / ``cache_shardings``
the caches by their logical axes (``_kv_axes``, ``_mla_axes``,
``_ssm_axes``, ``_cache_axes``), ``shard_init`` and ``init_cache(...,
ctx=...)`` make this rank's shards, and the forward passes take a
:class:`~repro_torch.models.module.ShardingCtx` and this rank's rows of the
batch (``ctx.rows``); ``logits`` are then this rank's block of the
vocabulary. ``abstract`` and ``abstract_cache`` give the param and cache
trees on the ``meta`` device, with no allocation (this rank's shards with a
``ctx``): what the dry run (item 11e) traces.

``build_model`` builds every config: the attention family (dense, vlm,
encoder, MLA, MoE), the SSM family (mamba2-130m) and the hybrid
(zamba2-2.7b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_embed, apply_lm_head, apply_norm, desc_embed, desc_lm_head, desc_norm
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.module import (
    NO_SHARDING,
    Sharding,
    ShardingCtx,
    ShardingRules,
    abstract_params,
    flatten_descs,
    gather_full,
    init_params,
    local_shape,
    param_shardings,
    param_specs,
    resolve_spec,
    shard_init,
)
from repro_torch.models.transformer import HybridCache
from repro_torch.utils import resolve_device

Tree = Any


@dataclasses.dataclass(frozen=True)
class LMModel:
    """A built architecture. Stateless: params/caches are passed explicitly."""

    cfg: ModelConfig

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def descs(self) -> Tree:
        """The descriptor tree: embed, stack, ln_final, head."""
        cfg = self.cfg
        return {
            "embed": desc_embed(cfg),
            "stack": transformer.desc_stack(cfg),
            "ln_final": desc_norm(cfg),
            "head": desc_lm_head(cfg),
        }

    def init(self, key: torch.Tensor, device: str | torch.device | None = None) -> Tree:
        """Materialized params from ``key`` (a ``repro_torch.core.prng`` key) on ``device``.

        ``None`` means the card: it raises without one (``device="cpu"`` for the CPU).
        """
        return init_params(key, self.descs(), resolve_device(device))

    def abstract(self) -> Tree:
        """The param tree on the ``meta`` device: shapes and dtypes, no storage."""
        return abstract_params(self.descs())

    def specs(self, rules: ShardingRules, mesh: Any) -> Tree:
        """The :class:`~repro_torch.models.module.PartitionSpec` of every param."""
        return param_specs(self.descs(), rules, mesh)

    def shardings(self, rules: ShardingRules, mesh: Any) -> Tree:
        """The :class:`~repro_torch.models.module.Sharding` of every param."""
        return param_shardings(self.descs(), rules, mesh)

    def shard_init(self, key: torch.Tensor, rules: ShardingRules, mesh: Any,
                   device: str | torch.device | None = None) -> Tree:
        """This rank's shard of every param of ``init(key)``, bit for bit (``None``: the card)."""
        return shard_init(key, self.descs(), rules, mesh, resolve_device(device))

    def ctx(self, rules: ShardingRules, mesh: Any) -> ShardingCtx:
        """The :class:`~repro_torch.models.module.ShardingCtx` of this model on ``mesh`` (no mesh: none)."""
        return ShardingCtx(mesh=mesh, rules=rules) if mesh is not None else NO_SHARDING

    def num_params(self) -> int:
        """Total parameter count, from the descriptors (nothing is allocated)."""
        return sum(math.prod(d.shape) for _, d in flatten_descs(self.descs()))

    def active_params(self) -> int:
        """Params touched per token (MoE: top-k of experts)."""
        cfg = self.cfg
        total = self.num_params()
        if not cfg.num_experts:
            return total
        gated = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        expert = gated * cfg.d_model * cfg.d_ff
        inactive = cfg.num_layers * (cfg.num_experts - cfg.num_experts_per_tok) * expert
        return total - inactive

    def matmul_params(self) -> int:
        """Active params that participate in matmuls per token: the N of the
        6·N·D model-FLOPs convention. The input-embedding gather is not a
        matmul, so the table is excluded; with tied embeddings the table *is*
        the head matmul, so it stays counted once."""
        n = self.active_params()
        if self.cfg.input_mode == "tokens" and not self.cfg.tie_embeddings:
            n -= self.cfg.padded_vocab * self.cfg.d_model
        return n

    # ------------------------------------------------------------------
    # Forward passes
    # ------------------------------------------------------------------

    def _embed(self, params: Tree, inputs: torch.Tensor, ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        cfg = self.cfg
        x = apply_embed(params["embed"], inputs, cfg, ctx)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x

    def _head(self, params: Tree, x: torch.Tensor, ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        x = apply_norm(params["ln_final"], x, self.cfg)
        return apply_lm_head(params["head"], params["embed"], x, self.cfg, ctx)

    def hidden(self, params: Tree, inputs: torch.Tensor, positions: Optional[torch.Tensor] = None,
               ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, dict]:
        """Backbone only: final-norm'd hidden states [B, L, D] + metrics.
        The training loss chunks the (huge-vocab) head over this output."""
        if positions is None:
            positions = torch.arange(inputs.shape[1], dtype=torch.int32, device=inputs.device)
        x = self._embed(params, inputs, ctx)
        x, _, metrics = transformer.apply_stack(params["stack"], x, positions, self.cfg, ctx)
        return apply_norm(params["ln_final"], x, self.cfg), metrics

    def logits(self, params: Tree, hidden: torch.Tensor, ctx: ShardingCtx = NO_SHARDING,
               weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """LM head over (already final-norm'd) hidden states (``weight``: the head's, laid out once,
        ``layers.lm_head_weight``)."""
        return apply_lm_head(params["head"], params["embed"], hidden, self.cfg, ctx, weight)

    def forward(self, params: Tree, inputs: torch.Tensor, positions: Optional[torch.Tensor] = None,
                ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, dict]:
        """Stateless training/encoder forward. Returns (logits [B,L,V], metrics)."""
        x, metrics = self.hidden(params, inputs, positions, ctx)
        return self.logits(params, x, ctx), metrics

    def prefill(self, params: Tree, inputs: torch.Tensor, cache: Tree, positions: Optional[torch.Tensor] = None,
                ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, Tree]:
        """Fill the cache with a prompt; returns (last-position logits [B,1,V], cache')."""
        if positions is None:
            positions = torch.arange(inputs.shape[1], dtype=torch.int32, device=inputs.device)
        x = self._embed(params, inputs, ctx)
        x, new_cache, _ = transformer.apply_stack(params["stack"], x, positions, self.cfg, ctx, caches=cache,
                                                  return_state=True)
        return self._head(params, x[:, -1:, :], ctx), new_cache

    def decode(self, params: Tree, tokens: torch.Tensor, cache: Tree, positions: torch.Tensor,
               ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, Tree]:
        """One-token decode step at absolute ``positions`` [1]. Returns (logits [B,1,V], cache')."""
        x = self._embed(params, tokens, ctx)
        x, new_cache, _ = transformer.apply_stack(params["stack"], x, positions, self.cfg, ctx, caches=cache)
        return self._head(params, x, ctx), new_cache

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device: str | torch.device | None = None,
                   ctx: ShardingCtx = NO_SHARDING) -> Optional[Tree]:
        """Zero decode caches for ``batch`` sequences of up to ``max_len`` tokens on ``device`` (``None``:
        the card); over a mesh (``ctx``), this rank's shard of them."""
        if not ctx.active:
            return transformer.init_caches(self.cfg, batch, max_len, resolve_device(device))
        device = resolve_device(device)
        return _map_cache(
            lambda leaf, spec: torch.zeros(local_shape(tuple(leaf.shape), spec, ctx.mesh), dtype=leaf.dtype,
                                           device=device),
            transformer.init_caches(self.cfg, batch, max_len, "meta"),
            self.cache_specs(ctx.rules, ctx.mesh, batch, max_len))

    def abstract_cache(self, batch: int, max_len: int, ctx: ShardingCtx = NO_SHARDING) -> Optional[Tree]:
        """:meth:`init_cache`'s tree on the ``meta`` device (``None`` for an encoder); over a mesh (``ctx``),
        this rank's shard of it."""
        abstract = transformer.abstract_caches(self.cfg, batch, max_len)
        if not ctx.active:
            return abstract
        return _map_cache(
            lambda leaf, spec: torch.empty(local_shape(tuple(leaf.shape), spec, ctx.mesh), dtype=leaf.dtype,
                                           device="meta"),
            abstract, self.cache_specs(ctx.rules, ctx.mesh, batch, max_len))

    def cache_specs(self, rules: ShardingRules, mesh: Any, batch: int, max_len: int) -> Optional[Tree]:
        """The spec tree matching ``init_cache``'s structure (``None`` for an encoder)."""
        abstract = transformer.init_caches(self.cfg, batch, max_len, "meta")
        return _map_cache(lambda leaf, ax: resolve_spec(tuple(leaf.shape), ax, rules, mesh), abstract,
                          _cache_axes(self.cfg))

    def cache_shardings(self, rules: ShardingRules, mesh: Any, batch: int, max_len: int) -> Optional[Tree]:
        """The :class:`~repro_torch.models.module.Sharding` tree of ``init_cache``'s structure."""
        specs = self.cache_specs(rules, mesh, batch, max_len)
        return _map_cache(lambda spec, _: Sharding(mesh, spec), specs, specs)

    def gather_cache(self, cache: Tree, ctx: ShardingCtx, batch: int, max_len: int) -> Optional[Tree]:
        """The whole cache from this rank's shard (a collective; no autograd)."""
        if not ctx.active:
            return cache
        return _map_cache(lambda leaf, spec: gather_full(leaf, spec, ctx.mesh), cache,
                          self.cache_specs(ctx.rules, ctx.mesh, batch, max_len))


def _map_cache(fn, tree: Tree, other: Tree) -> Tree:
    """``fn(leaf, other_leaf)`` over the tensors (or specs) of a cache tree; static fields kept."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_cache(fn, getattr(tree, f.name), getattr(other, f.name))
            for f in dataclasses.fields(tree) if not isinstance(getattr(tree, f.name), bool)})
    return fn(tree, other)


# ---------------------------------------------------------------------------
# Cache logical axes (per family), mirroring transformer.init_caches
# ---------------------------------------------------------------------------


def _kv_axes(lead: tuple, rolling: bool = False) -> KVCache:
    return KVCache(k=(*lead, "batch", "cache_seq", "kv_heads", "kv_head_dim"),
                   v=(*lead, "batch", "cache_seq", "kv_heads", "kv_head_dim"), next_pos=lead, rolling=rolling)


def _mla_axes(lead: tuple) -> MLACache:
    return MLACache(ckv=(*lead, "batch", "cache_seq", "latent"), kpe=(*lead, "batch", "cache_seq", None),
                    next_pos=lead)


def _ssm_axes(lead: tuple) -> SSMState:
    return SSMState(S=(*lead, "batch", "ssm_heads", None, "state"), conv=(*lead, "batch", "conv", "inner"),
                    next_pos=lead)


def _cache_axes(cfg: ModelConfig) -> Tree:
    rolling = cfg.sliding_window is not None
    if cfg.family == "ssm":
        return _ssm_axes(("layers",))
    if cfg.family == "hybrid":
        return HybridCache(ssm=_ssm_axes(("layers", None)), attn=_kv_axes(("layers",), rolling))
    if cfg.attention == "mla":
        return _mla_axes(("layers",))
    return _kv_axes(("layers",), rolling)


def build_model(cfg: ModelConfig) -> LMModel:
    """The model of ``cfg``."""
    return LMModel(cfg=cfg)

