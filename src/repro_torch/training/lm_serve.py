"""LM serving steps: prefill (prompt -> cache) and decode (one token per step).

The counterpart of ``repro.training.lm_serve`` on one device. A decode step
samples greedily, or from ``softmax(logits / temperature)`` with an
explicit ``torch.Generator`` (the reference's key), and returns the sampled
token, so a serving loop is a host loop over this function. The steps run
without autograd and read nothing back to the host. A cache is whatever
tree ``LMModel.init_cache`` gives: a ``KVCache``, an ``MLACache``, an
``SSMState`` or a ``HybridCache``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.models.model import LMModel

Tree = Any


def make_prefill_step(model: LMModel) -> Callable[[Tree, torch.Tensor, Tree], tuple[torch.Tensor, Tree]]:
    """``prefill_step(params, prompt [B, L], zero cache) -> (last logits [B, 1, V], cache')``."""

    @torch.no_grad()
    def prefill_step(params: Tree, inputs: torch.Tensor, cache: Tree) -> tuple[torch.Tensor, Tree]:
        return model.prefill(params, inputs, cache)

    return prefill_step


def make_decode_step(model: LMModel, temperature: float = 0.0) -> Callable[..., tuple[torch.Tensor, Tree]]:
    """``decode_step(params, tokens [B, 1], cache, pos [], generator=None) -> (next [B, 1] int32, cache')``.

    ``pos`` is the absolute position of ``tokens``. With ``temperature > 0``
    the next token is drawn with ``generator`` (on the logits' device);
    otherwise it is the argmax.
    """

    @torch.no_grad()
    def decode_step(params: Tree, tokens: torch.Tensor, cache: Tree, pos: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, Tree]:
        logits, cache = model.decode(params, tokens, cache, pos.reshape(1))
        last = logits[:, -1, :]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = last.argmax(dim=-1)
        return nxt[:, None].to(torch.int32), cache

    return decode_step


def greedy_generate(model: LMModel, params: Tree, prompt: torch.Tensor, steps: int, max_len: int) -> torch.Tensor:
    """Prefill ``prompt`` [B, L], then ``steps - 1`` greedy decode steps: the ``steps`` new tokens [B, steps]."""
    B, L = prompt.shape
    cache = model.init_cache(B, max_len, prompt.device)
    logits, cache = make_prefill_step(model)(params, prompt, cache)
    decode = make_decode_step(model)
    tok = logits[:, -1, :].argmax(dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for t in range(steps - 1):
        pos = torch.tensor(L + t, dtype=torch.int32, device=prompt.device)
        tok, cache = decode(params, tok, cache, pos)
        out.append(tok)
    return torch.cat(out, dim=1)
