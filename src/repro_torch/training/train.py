"""The train step: loss, gradients (autograd) and the optimizer update.

The counterpart of ``repro.training.train`` on one device. The factory
returns ``train_step(state, batch) -> (state, metrics)``; the loss runs the
backbone once and the vocabulary head per chunk (``chunked_lm_loss``).
With ``microbatches = n > 1`` the batch is cut into n consecutive pieces
(the reference's reshape to ``[n, B/n, ...]``), their gradients summed in
fp32 and divided by n, and the metrics averaged. What the reference adds
for meshes (``jit_train_step``, ``state_specs``, ``batch_specs``) waits for
several cards (ROADMAP Queue 1 item 9).

The step updates the params and moments in place (``AdamW.update``): the
state it returns holds the same tensors as the state it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.convert import lm_params_from_tree, lm_params_to_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel
from repro_torch.training.losses import chunked_lm_loss
from repro_torch.training.optimizer import AdamW, OptState, tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state and the step count ([] int32)."""

    params: Tree
    opt: OptState
    step: torch.Tensor


def init_train_state(key: torch.Tensor, model: LMModel, optimizer: AdamW,
                     device: str | torch.device | None = None) -> TrainState:
    """Fresh params from ``key`` on ``device`` (``None``: the card), zero moments, step 0."""
    params = model.init(key, device)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return TrainState(params=params, opt=optimizer.init(params), step=step)


def abstract_batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """One training batch on the ``meta`` device: shapes and dtypes, no storage."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if cfg.input_mode == "tokens":
        inputs = meta((batch, seq), torch.int32)
    else:
        inputs = meta((batch, seq, cfg.frame_dim), torch.bfloat16)
    return {"inputs": inputs, "labels": meta((batch, seq), torch.int32), "mask": meta((batch, seq), torch.float32)}


def _with_grad(params: Tree) -> Tree:
    """Leaf tensors sharing ``params``' storage that autograd differentiates against."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _loss_fn(model: LMModel, params: Tree, batch: dict, z_weight: float,
             loss_chunk: int) -> tuple[torch.Tensor, dict]:
    cfg = model.cfg
    hidden, moe_metrics = model.hidden(params, batch["inputs"])
    loss, metrics = chunked_lm_loss(
        lambda h: model.logits(params, h), hidden, batch["labels"], batch["mask"],
        chunk=loss_chunk, z_weight=z_weight,
    )
    if cfg.num_experts:
        loss = loss + cfg.router_aux_weight * moe_metrics["aux_loss"] + 1e-3 * moe_metrics["router_z"]
        metrics = {**metrics, **moe_metrics}
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(model: LMModel, params: Tree, batch: dict, microbatches: int = 1,
                   z_weight: float = 1e-4, loss_chunk: int = 512) -> tuple[Tree, dict]:
    """(gradients shaped like ``params``, metrics) of the training loss on ``batch``.

    ``batch`` holds ``inputs`` ([B, L] token ids, or [B, L, frame_dim]
    frames), ``labels`` ([B, L]) and ``mask`` ([B, L], 1 = counts). The
    metrics (device tensors) are the loss's (``loss``, ``ce``, ``z_loss``,
    ``accuracy``, ``tokens``) and the zero MoE metrics; with microbatches,
    the gradients are fp32 and both are means over the pieces.
    """

    def one(piece: dict) -> tuple[list[torch.Tensor], dict]:
        leaves_tree = _with_grad(params)
        with torch.enable_grad():
            loss, metrics = _loss_fn(model, leaves_tree, piece, z_weight, loss_chunk)
            grads = torch.autograd.grad(loss, tree_leaves(leaves_tree))
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    if microbatches == 1:
        flat, metrics = one(batch)
    else:
        n = batch["labels"].shape[0] // microbatches
        acc, mets = None, []
        for i in range(microbatches):
            grads, m = one({k: v[i * n : (i + 1) * n] for k, v in batch.items()})
            grads = [g.float() for g in grads]
            acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
            mets.append(m)
        flat = [a / microbatches for a in acc]
        metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    return _rebuild(params, iter(flat)), metrics


def make_train_step(
    model: LMModel,
    optimizer: AdamW,
    microbatches: int = 1,
    z_weight: float = 1e-4,
    loss_chunk: int = 512,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state, metrics)``: :func:`loss_and_grads`, then ``optimizer.update``.

    The metrics are :func:`loss_and_grads`' plus ``grad_norm`` and ``lr``.
    """

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        grads, metrics = loss_and_grads(model, state.params, batch, microbatches, z_weight, loss_chunk)
        params, opt, opt_metrics = optimizer.update(grads, state.opt, state.params)
        return TrainState(params=params, opt=opt, step=state.step + 1), {**metrics, **opt_metrics}

    return train_step


def _rebuild(like: Tree, it) -> Tree:
    """A tree shaped like ``like`` whose leaves, in leaf order, come from ``it``."""
    if isinstance(like, torch.Tensor):
        return next(it)
    return {k: _rebuild(like[k], it) for k in sorted(like)}


def state_leaves(state: TrainState) -> dict[str, Any]:
    """The state's leaves under the names the reference's checkpoints give a ``TrainState``.

    ``jax.tree_util.tree_flatten_with_path`` names a leaf by its path, parts
    joined by ``__``: dataclass fields as ``.params``, ``.opt``, ``.mu``,
    dict keys bare. So ``.params__embed__tok``, ``.opt__.mu__embed__tok``,
    ``.opt__.count``, ``.step``, in the reference's order. Either package's
    checkpoint manager reads the other's files under these names.
    """
    out: dict[str, Any] = {}

    def add(prefix: str, tree: Tree) -> None:
        if isinstance(tree, torch.Tensor):
            out[prefix] = tree
            return
        for k in sorted(tree):
            add(f"{prefix}__{k}", tree[k])

    add(".params", state.params)
    add(".opt__.mu", state.opt.mu)
    add(".opt__.nu", state.opt.nu)
    out[".opt__.count"] = state.opt.count
    out[".step"] = state.step
    return out


def state_host_leaves(state: TrainState) -> dict[str, Any]:
    """:func:`state_leaves` as host numpy copies, what a checkpoint writes (bfloat16 as ``ml_dtypes``)."""
    return {name: lm_params_to_tree(leaf) for name, leaf in state_leaves(state).items()}


def state_from_leaves(leaves: dict[str, Any], like: TrainState) -> TrainState:
    """A :class:`TrainState` shaped like ``like`` (and on its device) from named host leaves.

    The inverse of :func:`state_leaves`: ``leaves`` maps those names to
    numpy arrays (``CheckpointManager.restore``'s result), in any order.
    """
    names = iter(state_leaves(like).items())

    def take(tree: Tree) -> Tree:
        if isinstance(tree, torch.Tensor):
            name, ref = next(names)
            return lm_params_from_tree(leaves[name]).to(device=ref.device, dtype=ref.dtype)
        return {k: take(tree[k]) for k in sorted(tree)}

    params, mu, nu = take(like.params), take(like.opt.mu), take(like.opt.nu)
    count, step = take(like.opt.count), take(like.step)
    return TrainState(params=params, opt=OptState(mu=mu, nu=nu, count=count), step=step)
