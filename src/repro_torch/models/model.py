"""Config -> model: descriptors, forward passes and caches in one object.

The counterpart of ``repro.models.model``. The same :class:`LMModel` drives
training (``forward``, or ``hidden`` + ``logits`` for the chunked loss) and
inference (``prefill`` / ``decode``). Params and caches are passed
explicitly; the model holds only its config. A cache is the stack's cache
tree: a :class:`KVCache` for the attention family (an :class:`MLACache`
for MLA), an :class:`SSMState` for the SSM stack, a :class:`HybridCache`
for the hybrid. What the reference adds for meshes (``specs``,
``shardings``, ``cache_specs``, ``cache_shardings`` and the cache axes
``_kv_axes``, ``_mla_axes``, ``_ssm_axes``, ``_cache_axes``) waits for
several cards (ROADMAP Queue 1 item 9a); ``abstract_cache`` waits for the
dry run (item 11e). ``abstract`` gives the param tree on the ``meta``
device, with no allocation.

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
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_embed, apply_lm_head, apply_norm, desc_embed, desc_lm_head, desc_norm
from repro_torch.models.module import abstract_params, flatten_descs, init_params
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

    def _embed(self, params: Tree, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_embed(params["embed"], inputs, cfg)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x

    def _head(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(params["ln_final"], x, self.cfg)
        return apply_lm_head(params["head"], params["embed"], x, self.cfg)

    def hidden(self, params: Tree, inputs: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
        """Backbone only: final-norm'd hidden states [B, L, D] + metrics.
        The training loss chunks the (huge-vocab) head over this output."""
        if positions is None:
            positions = torch.arange(inputs.shape[1], dtype=torch.int32, device=inputs.device)
        x = self._embed(params, inputs)
        x, _, metrics = transformer.apply_stack(params["stack"], x, positions, self.cfg)
        return apply_norm(params["ln_final"], x, self.cfg), metrics

    def logits(self, params: Tree, hidden: torch.Tensor) -> torch.Tensor:
        """LM head over (already final-norm'd) hidden states."""
        return apply_lm_head(params["head"], params["embed"], hidden, self.cfg)

    def forward(self, params: Tree, inputs: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
        """Stateless training/encoder forward. Returns (logits [B,L,V], metrics)."""
        x, metrics = self.hidden(params, inputs, positions)
        return self.logits(params, x), metrics

    def prefill(self, params: Tree, inputs: torch.Tensor, cache: Tree,
                positions: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, Tree]:
        """Fill the cache with a prompt; returns (last-position logits [B,1,V], cache')."""
        if positions is None:
            positions = torch.arange(inputs.shape[1], dtype=torch.int32, device=inputs.device)
        x = self._embed(params, inputs)
        x, new_cache, _ = transformer.apply_stack(params["stack"], x, positions, self.cfg, caches=cache,
                                                  return_state=True)
        return self._head(params, x[:, -1:, :]), new_cache

    def decode(self, params: Tree, tokens: torch.Tensor, cache: Tree,
               positions: torch.Tensor) -> tuple[torch.Tensor, Tree]:
        """One-token decode step at absolute ``positions`` [1]. Returns (logits [B,1,V], cache')."""
        x = self._embed(params, tokens)
        x, new_cache, _ = transformer.apply_stack(params["stack"], x, positions, self.cfg, caches=cache)
        return self._head(params, x), new_cache

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device: str | torch.device | None = None) -> Optional[Tree]:
        """Zero decode caches for ``batch`` sequences of up to ``max_len`` tokens on ``device`` (``None``: the card)."""
        return transformer.init_caches(self.cfg, batch, max_len, resolve_device(device))


def build_model(cfg: ModelConfig) -> LMModel:
    """The model of ``cfg``."""
    return LMModel(cfg=cfg)

