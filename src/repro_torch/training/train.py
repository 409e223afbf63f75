"""The train step: loss, gradients (autograd) and the optimizer update.

The counterpart of ``repro.training.train`` on one device. The factory
returns ``train_step(state, batch) -> (state, metrics)``; the loss runs the
backbone once and the vocabulary head per chunk (``chunked_lm_loss``).
With ``microbatches = n > 1`` the batch is cut into n consecutive pieces
(the reference's reshape to ``[n, B/n, ...]``), their gradients summed in
fp32 and divided by n, and the metrics averaged.

Over a mesh of ranks (``make_train_step(..., rules=, mesh=)``, ROADMAP
Queue 1 item 9a) the state holds this rank's shards (``state_specs``;
``init_train_state(..., rules=, mesh=)`` makes them) and the step takes
the whole batch (``batch_specs`` says how its rows split) and slices its
rows. The loss is the whole batch's on every rank, so its gradient is
taken at weight ``1 / ranks`` and each leaf's gradient is summed over the
axes its shard is replicated on; ``jit_train_step`` binds the step to a
batch shape and checks the placements of the state and the batch on entry.

The step updates the params and moments in place (``AdamW.update``): the
state it returns holds the same tensors as the state it was given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.checkpoint import ShardedHostLeaf
from repro_torch.convert import lm_params_from_tree, lm_params_to_tree
from repro_torch.launch.hostdevices import process_count
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import lm_head_weight, vocab_axes
from repro_torch.models.model import LMModel
from repro_torch.models.module import (
    NO_SHARDING,
    TRAIN_RULES,
    PartitionSpec,
    ShardingCtx,
    ShardingRules,
    local_box,
    local_shape,
    resolve_spec,
    shard_of,
)
from repro_torch.training.losses import chunked_lm_loss
from repro_torch.training.optimizer import AdamW, OptState, tree_leaves, tree_leaves_specs, tree_map

Tree = Any


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state and the step count ([] int32)."""

    params: Tree
    opt: OptState
    step: torch.Tensor


def init_train_state(key: torch.Tensor, model: LMModel, optimizer: AdamW,
                     device: str | torch.device | None = None, rules: ShardingRules = TRAIN_RULES,
                     mesh: Any = None) -> TrainState:
    """Fresh params from ``key`` on ``device`` (``None``: the card), zero moments, step 0.

    With a ``mesh``, this rank's shards of them (``model.shard_init``).
    """
    params = model.shard_init(key, rules, mesh, device) if mesh is not None else model.init(key, device)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return TrainState(params=params, opt=optimizer.init(params), step=step)


def abstract_train_state(model: LMModel, optimizer: AdamW, rules: ShardingRules = TRAIN_RULES,
                         mesh: Any = None) -> TrainState:
    """The :class:`TrainState` on the ``meta`` device, for the dry run: params, moments and the step.

    With a ``mesh``, this rank's shards of them (what
    ``init_train_state(..., rules=, mesh=)`` makes); no storage is allocated.
    """
    params = model.abstract()
    if mesh is not None:
        params = tree_map(lambda p, sp: torch.empty(local_shape(tuple(p.shape), sp, mesh), dtype=p.dtype,
                                                    device="meta"), params, model.specs(rules, mesh))
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def abstract_batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """One training batch on the ``meta`` device: shapes and dtypes, no storage."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if cfg.input_mode == "tokens":
        inputs = meta((batch, seq), torch.int32)
    else:
        inputs = meta((batch, seq, cfg.frame_dim), torch.bfloat16)
    return {"inputs": inputs, "labels": meta((batch, seq), torch.int32), "mask": meta((batch, seq), torch.float32)}


def batch_specs(cfg: ModelConfig, rules: ShardingRules, mesh: Any, batch: int, seq: int) -> dict:
    """The specs of one training batch's tensors."""
    if cfg.input_mode == "tokens":
        inp = resolve_spec((batch, seq), ("batch", "seq"), rules, mesh)
    else:
        inp = resolve_spec((batch, seq, cfg.frame_dim), ("batch", "seq", None), rules, mesh)
    tok = resolve_spec((batch, seq), ("batch", "seq"), rules, mesh)
    return {"inputs": inp, "labels": tok, "mask": tok}


def state_specs(model: LMModel, optimizer: AdamW, rules: ShardingRules, mesh: Any) -> TrainState:
    """The specs of a :class:`TrainState`: the params', the moments' (the same) and the scalars'."""
    p = model.specs(rules, mesh)
    return TrainState(params=p, opt=optimizer.state_specs(p), step=PartitionSpec())


def _with_grad(params: Tree) -> Tree:
    """Leaf tensors sharing ``params``' storage that autograd differentiates against."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _loss_fn(model: LMModel, params: Tree, batch: dict, z_weight: float,
             loss_chunk: int, ctx: ShardingCtx = NO_SHARDING) -> tuple[torch.Tensor, dict]:
    cfg = model.cfg
    B = batch["labels"].shape[0]
    ctx = ctx.with_batch(B) if ctx.active else ctx
    lctx = ctx.loss_ctx()
    hidden, moe_metrics = model.hidden(params, ctx.rows(batch["inputs"]), ctx=ctx)
    # the head's weight laid out once for every chunk, in its stored dtype: one gather a step, one
    # reduce-scatter of its gradient, and each chunk's cast sums its cotangent in the stored dtype
    w_head = lm_head_weight(params["head"], params["embed"], cfg, lctx)

    def head(h: torch.Tensor) -> torch.Tensor:
        # per chunk: the rows move from the batch's layout to the loss boundary's
        shape = (B, *h.shape[1:])
        h = ctx.constrain(h, ("loss_batch", "seq", "act_embed"), shape, ctx.spec(shape, ("batch", "seq", "act_embed")))
        return model.logits(params, h, lctx, w_head)

    loss, metrics = chunked_lm_loss(
        head, hidden, lctx.rows(batch["labels"]), lctx.rows(batch["mask"]), chunk=loss_chunk, z_weight=z_weight,
        ctx=lctx, vocab_axes=vocab_axes(cfg, lctx),
    )
    if cfg.num_experts:
        loss = loss + cfg.router_aux_weight * moe_metrics["aux_loss"] + 1e-3 * moe_metrics["router_z"]
        metrics = {**metrics, **moe_metrics}
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(model: LMModel, params: Tree, batch: dict, microbatches: int = 1,
                   z_weight: float = 1e-4, loss_chunk: int = 512, ctx: ShardingCtx = NO_SHARDING,
                   specs: Tree = None) -> tuple[Tree, dict]:
    """(gradients shaped like ``params``, metrics) of the training loss on ``batch``.

    ``batch`` holds ``inputs`` ([B, L] token ids, or [B, L, frame_dim]
    frames), ``labels`` ([B, L]) and ``mask`` ([B, L], 1 = counts). The
    metrics (device tensors) are the loss's (``loss``, ``ce``, ``z_loss``,
    ``accuracy``, ``tokens``) and the zero MoE metrics; with microbatches,
    the gradients are fp32 and both are means over the pieces. Over a mesh
    (``ctx``, ``specs``: the params' specs) ``params`` are this rank's
    shards, ``batch`` is whole, and the gradients are the shards'.
    """
    ranks = ctx.mesh.size if ctx.active else 1
    spec_leaves = tree_leaves_specs(specs) if ctx.active else None

    def one(piece: dict) -> tuple[list[torch.Tensor], dict]:
        leaves_tree = _with_grad(params)
        with torch.enable_grad():
            loss, metrics = _loss_fn(model, leaves_tree, piece, z_weight, loss_chunk, ctx)
            # the loss is whole on every rank: each rank's gradient is its share of the sum over ranks
            grads = torch.autograd.grad(loss / ranks if ranks > 1 else loss, tree_leaves(leaves_tree))
        return ctx.sync_grads(list(grads), spec_leaves), {k: v.detach() for k, v in metrics.items()}

    if microbatches == 1:
        flat, metrics = one(batch)
    else:
        n = batch["labels"].shape[0] // microbatches
        acc, mets = None, []
        for i in range(microbatches):
            grads, m = one({k: v[i * n : (i + 1) * n] for k, v in batch.items()})
            grads = [g.float() for g in grads]
            acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
            del grads  # not held through the next microbatch's backward (one gradient copy less)
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
    rules: ShardingRules = TRAIN_RULES,
    mesh: Any = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``train_step(state, batch) -> (state, metrics)``: :func:`loss_and_grads`, then ``optimizer.update``.

    The metrics are :func:`loss_and_grads`' plus ``grad_norm`` and ``lr``.
    With a ``mesh`` the state is this rank's shards under ``rules`` and the
    batch is whole; the metrics are the whole batch's on every rank.
    """
    ctx = model.ctx(rules, mesh)
    specs = model.specs(rules, mesh) if mesh is not None else None

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        grads, metrics = loss_and_grads(model, state.params, batch, microbatches, z_weight, loss_chunk, ctx, specs)
        state, opt_metrics = apply_update(optimizer, grads, state, ctx, specs)
        return state, {**metrics, **opt_metrics}

    return train_step


def apply_update(optimizer: AdamW, grads: Tree, state: TrainState, ctx: ShardingCtx = NO_SHARDING,
                 specs: Tree = None) -> tuple[TrainState, dict]:
    """The train step's tail: ``optimizer.update`` (in place) and the step count; (state, ``grad_norm`` and ``lr``)."""
    params, opt, opt_metrics = optimizer.update(grads, state.opt, state.params, ctx, specs)
    return TrainState(params=params, opt=opt, step=state.step + 1), opt_metrics


def jit_train_step(
    model: LMModel,
    optimizer: AdamW,
    mesh: Any,
    rules: ShardingRules = TRAIN_RULES,
    microbatches: int = 1,
    batch: int = 8,
    seq: int = 512,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """:func:`make_train_step` bound to ``mesh`` and a ``[batch, seq]`` batch, checking placements on entry.

    Every leaf of the state must have its spec's local shape and lie on one
    device, and the batch's tensors their global shapes there; a mismatch
    raises ``ValueError``. The step updates the state in place, which
    is what the reference's buffer donation gives.
    """
    step_fn = make_train_step(model, optimizer, microbatches, rules=rules, mesh=mesh)
    sspec = state_specs(model, optimizer, rules, mesh)
    want = {name: local_shape(tuple(leaf.shape), spec, mesh) for (name, leaf), spec in zip(
        state_leaves(_abstract_state(model)).items(), _spec_leaves(sspec))}
    bspec = abstract_batch(model.cfg, batch, seq)

    def step(state: TrainState, data: dict) -> tuple[TrainState, dict]:
        leaves = state_leaves(state)
        device = leaves[".step"].device
        for name, leaf in leaves.items():
            if tuple(leaf.shape) != want[name] or leaf.device != device:
                raise ValueError(f"state leaf {name}: {tuple(leaf.shape)} on {leaf.device}, the mesh places "
                                 f"{want[name]} on {device}")
        for k, v in data.items():
            if tuple(v.shape) != tuple(bspec[k].shape) or v.device != device:
                raise ValueError(f"batch {k}: {tuple(v.shape)} on {v.device}, want {tuple(bspec[k].shape)} "
                                 f"on {device}")
        return step_fn(state, data)

    return step


def _abstract_state(model: LMModel) -> TrainState:
    """A :class:`TrainState` of ``meta`` tensors with the global shapes."""
    params = model.abstract()
    zero = torch.zeros((), dtype=torch.int32, device="meta")
    return TrainState(params=params, opt=OptState(mu=params, nu=params, count=zero), step=zero)


def _spec_leaves(specs: TrainState) -> list[PartitionSpec]:
    """The specs of :func:`state_specs` in :func:`state_leaves`' order."""
    return [*tree_leaves_specs(specs.params), *tree_leaves_specs(specs.opt.mu), *tree_leaves_specs(specs.opt.nu),
            specs.opt.count, specs.step]


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


def state_host_leaves(state: TrainState, specs: TrainState | None = None, mesh: Any = None) -> dict[str, Any]:
    """:func:`state_leaves` as host numpy copies, what a checkpoint writes (bfloat16 as ``ml_dtypes``).

    In a job of several processes with a ``mesh`` (``specs``:
    :func:`state_specs`), each leaf is this rank's shard as a
    :class:`~repro_torch.checkpoint.ShardedHostLeaf`: the checkpoint
    reassembles whole leaves, leaf for leaf the reference's.
    """
    leaves = state_leaves(state)
    if mesh is None or process_count() == 1:
        return {name: lm_params_to_tree(leaf) for name, leaf in leaves.items()}
    out = {}
    for (name, leaf), spec in zip(leaves.items(), _spec_leaves(specs)):
        shape = tuple(n * mesh.axis_size(spec.axes(d)) for d, n in enumerate(leaf.shape))  # the whole leaf's
        block = lm_params_to_tree(leaf)
        out[name] = ShardedHostLeaf(shape, str(block.dtype), ((local_box(shape, spec, mesh), block),))
    return out


def state_from_leaves(leaves: dict[str, Any], like: TrainState, specs: TrainState | None = None,
                      mesh: Any = None) -> TrainState:
    """A :class:`TrainState` shaped like ``like`` (and on its device) from named host leaves.

    The inverse of :func:`state_leaves`: ``leaves`` maps those names to
    numpy arrays (``CheckpointManager.restore``'s result), in any order.
    With a ``mesh`` (``specs``: :func:`state_specs`) the leaves are whole
    and ``like`` holds this rank's shards: each leaf is cut to its shard.
    """
    names = iter(state_leaves(like).items())
    spec_it = iter(_spec_leaves(specs)) if mesh is not None else None

    def take(tree: Tree) -> Tree:
        if isinstance(tree, torch.Tensor):
            name, ref = next(names)
            whole = lm_params_from_tree(leaves[name])
            if spec_it is not None:
                whole = shard_of(whole, next(spec_it), mesh).contiguous()
            return whole.to(device=ref.device, dtype=ref.dtype)
        return {k: take(tree[k]) for k in sorted(tree)}

    params, mu, nu = take(like.params), take(like.opt.mu), take(like.opt.nu)
    count, step = take(like.opt.count), take(like.step)
    return TrainState(params=params, opt=OptState(mu=mu, nu=nu, count=count), step=step)
