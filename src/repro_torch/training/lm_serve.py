"""LM serving steps: prefill (prompt -> cache) and decode (one token per step).

The counterpart of ``repro.training.lm_serve``. A decode step samples
greedily, or from ``softmax(logits / temperature)`` with an explicit
``torch.Generator`` (the reference's key), and returns the sampled token,
so a serving loop is a host loop over this function. The steps run without
autograd and read nothing back to the host. A cache is whatever tree
``LMModel.init_cache`` gives: a ``KVCache``, an ``MLACache``, an
``SSMState`` or a ``HybridCache``.

Over a mesh of ranks (``rules``, ``mesh``; ROADMAP Queue 1 item 9a) the
params and the cache are this rank's shards (``model.shard_init``,
``model.init_cache(..., ctx=model.ctx(rules, mesh))``), the prompt and the
tokens are whole, and so are the logits and tokens the steps return: each
rank runs its rows, and the last logits are gathered. Prefill runs under
``SERVE_RULES`` (the KV cache split along the sequence over ``model``),
decode under ``SERVE_RULES`` or ``DECODE_RULES`` (weights used as stored).
With ``temperature > 0`` every rank draws from the same whole logits, so
the ranks' generators must be seeded alike.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.models.layers import vocab_axes
from repro_torch.models.model import LMModel
from repro_torch.models.module import SERVE_RULES, PartitionSpec, ShardingCtx, ShardingRules, gather_full, resolve_spec

Tree = Any


def _serve_ctx(model: LMModel, rules: ShardingRules, mesh: Any, batch: int, max_len: Optional[int]) -> ShardingCtx:
    if mesh is None:
        return model.ctx(rules, None)
    if max_len is None:
        raise ValueError("a step over a mesh needs the caches' max_len")
    return model.ctx(rules, mesh).with_batch(batch, max_len)


def gather_logits(model: LMModel, params: Tree, logits: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """The whole [B, L, V] logits from this rank's rows and vocabulary block (a collective; no autograd)."""
    if not ctx.active:
        return logits
    v = vocab_axes(model.cfg, ctx)
    return gather_full(logits, PartitionSpec.of(ctx.batch_axes, None, v), ctx.mesh)


def make_prefill_step(model: LMModel, rules: ShardingRules = SERVE_RULES, mesh: Any = None,
                      max_len: Optional[int] = None) -> Callable[[Tree, torch.Tensor, Tree], tuple[torch.Tensor, Tree]]:
    """``prefill_step(params, prompt [B, L], zero cache) -> (last logits [B, 1, V], cache')``.

    With a ``mesh``: ``max_len`` is the caches' length, the params and the
    cache are this rank's shards, the prompt and the logits whole.
    """

    @torch.no_grad()
    def prefill_step(params: Tree, inputs: torch.Tensor, cache: Tree) -> tuple[torch.Tensor, Tree]:
        ctx = _serve_ctx(model, rules, mesh, inputs.shape[0], max_len)
        logits, cache = model.prefill(params, ctx.rows(inputs), cache, ctx=ctx)
        return gather_logits(model, params, logits, ctx), cache

    return prefill_step


def make_decode_step(model: LMModel, temperature: float = 0.0, rules: ShardingRules = SERVE_RULES,
                     mesh: Any = None, max_len: Optional[int] = None) -> Callable[..., tuple[torch.Tensor, Tree]]:
    """``decode_step(params, tokens [B, 1], cache, pos [], generator=None) -> (next [B, 1] int32, cache')``.

    ``pos`` is the absolute position of ``tokens``. With ``temperature > 0``
    the next token is drawn with ``generator`` (on the logits' device);
    otherwise it is the argmax. With a ``mesh`` as :func:`make_prefill_step`.
    """

    @torch.no_grad()
    def decode_step(params: Tree, tokens: torch.Tensor, cache: Tree, pos: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, Tree]:
        ctx = _serve_ctx(model, rules, mesh, tokens.shape[0], max_len)
        logits, cache = model.decode(params, ctx.rows(tokens), cache, pos.reshape(1), ctx=ctx)
        last = gather_logits(model, params, logits, ctx)[:, -1, :]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = last.argmax(dim=-1)
        return nxt[:, None].to(torch.int32), cache

    return decode_step


def greedy_generate(model: LMModel, params: Tree, prompt: torch.Tensor, steps: int, max_len: int,
                    rules: ShardingRules = SERVE_RULES, mesh: Any = None) -> torch.Tensor:
    """Prefill ``prompt`` [B, L], then ``steps - 1`` greedy decode steps: the ``steps`` new tokens [B, steps].

    With a ``mesh``, ``params`` are this rank's shards under ``rules``.
    """
    B, L = prompt.shape
    ctx = _serve_ctx(model, rules, mesh, B, max_len)
    cache = model.init_cache(B, max_len, prompt.device, ctx=ctx)
    logits, cache = make_prefill_step(model, rules, mesh, max_len)(params, prompt, cache)
    decode = make_decode_step(model, rules=rules, mesh=mesh, max_len=max_len)
    tok = logits[:, -1, :].argmax(dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for t in range(steps - 1):
        pos = torch.tensor(L + t, dtype=torch.int32, device=prompt.device)
        tok, cache = decode(params, tok, cache, pos)
        out.append(tok)
    return torch.cat(out, dim=1)


def serve_input_specs(model: LMModel, rules: ShardingRules, mesh: Any, batch: int) -> PartitionSpec:
    """The spec of the decode step's token inputs [batch, 1]."""
    return resolve_spec((batch, 1), ("batch", None), rules, mesh)
