"""AdamW with schedule, global-norm clipping and an optional low-precision moment dtype.

The counterpart of ``repro.training.optimizer``, with the reference's
defaults (b2 0.95, weight decay 0.1 on leaves with ndim >= 2, clipping at
global norm 1.0) and its fp32 update math. Two differences of form, not of
result: the update writes params and moments in place (the step returns
the same tensors), and it runs over the leading (layer-stack) dim in
chunks, so the fp32 temporaries stay one chunk big for every leaf (the
reference chunks only leaves whose leading dim divides ``scan_chunks``).
A chunk of more than ``_PIECE`` elements (a layer of mixtral's expert
bank holds 805 M) is cut into flat pieces of ``_PIECE``, and the global
norm sums a leaf in such pieces too, so no fp32 copy of a whole bf16 leaf
is made. The update is elementwise, so chunking changes no value.

Nothing here reads a tensor back to the host: the step count, the
learning rate and the clip scale stay on the device.

Over a mesh each rank updates its own shards (``state_specs``: the moments
are laid out as the params), which is exact for an elementwise update;
chunks and pieces cut a rank's local shard only, never a dim across
ranks. The global norm is one sum over the job of each rank's sums of
squares, each leaf weighted by one over the number of ranks holding a copy
of its shard (``global_norm(tree, ctx, specs)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional

import torch

Tree = Any

# the most elements one fp32 temporary of the update or of the global norm holds (256 MB)
_PIECE = 1 << 26


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in the reference's leaf order (keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of nested dicts of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


@dataclasses.dataclass
class OptState:
    """AdamW's state: first and second moments (trees like the params) and the step count."""

    mu: Tree
    nu: Tree
    count: torch.Tensor  # [] int32


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1) -> Callable:
    """Linear warmup then cosine decay to ``floor * peak``; maps a step tensor to an fp32 rate."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return schedule


def global_norm(tree: Tree, ctx=None, specs: Tree = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (each leaf ``_PIECE`` elements at a time).

    Over a mesh (``ctx`` active, ``specs`` the leaves' storage specs) the
    leaves are this rank's shards: each shard's sum counts once, summed
    over the job.
    """
    if ctx is None or not ctx.active:
        sums = [torch.sum(torch.square(piece.float())) for x in tree_leaves(tree)
                for piece in x.reshape(-1).split(_PIECE)]
        return torch.sqrt(torch.sum(torch.stack(sums)))
    from repro_torch.models.collectives import reduce_raw

    sums = [torch.sum(torch.stack([torch.sum(torch.square(piece.float())) for piece in x.reshape(-1).split(_PIECE)]))
            for x in tree_leaves(tree)]

    mesh = ctx.mesh
    copies = [mesh.size // mesh.axis_size([a for d in range(len(sp)) for a in sp.axes(d)])
              for sp in tree_leaves_specs(specs)]
    local = torch.sum(torch.stack([v / c for v, c in zip(sums, copies)]))
    return torch.sqrt(reduce_raw(local, ctx.group(mesh.axis_names)))


def tree_leaves_specs(specs: Tree) -> list:
    """The specs of a spec tree (nested dicts of ``PartitionSpec``), in the reference's leaf order."""
    if isinstance(specs, tuple):
        return [specs]
    return [leaf for k in sorted(specs) for leaf in tree_leaves_specs(specs[k])]


def _chunks(x: torch.Tensor, rows: int) -> Iterator[torch.Tensor]:
    """Views of ``x``, ``rows`` of its leading dim at a time (the whole of a 0- or 1-dim leaf); a
    chunk of more than ``_PIECE`` elements goes as flat pieces of ``_PIECE`` (``x`` contiguous)."""
    if x.ndim < 2:
        yield x
        return
    for chunk in x.split(rows, dim=0):
        yield from (chunk.view(-1).split(_PIECE) if chunk.numel() > _PIECE else (chunk,))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW (decoupled weight decay) with optional schedule and global-norm clipping."""

    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32
    # the update runs over about 1/scan_chunks of a leaf's leading dim at a time
    scan_chunks: int = 8

    def init(self, params: Tree) -> OptState:
        """Zero moments shaped like ``params`` (on their devices) and count 0."""
        zeros = lambda p: torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)
        first = tree_leaves(params)[0]
        return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                        count=torch.zeros((), dtype=torch.int32, device=first.device))

    def lr(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (an fp32 tensor)."""
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)

    def state_specs(self, p_specs: Tree) -> OptState:
        """The moments' specs (the params'), and the replicated count's."""
        from repro_torch.models.module import PartitionSpec

        return OptState(mu=p_specs, nu=p_specs, count=PartitionSpec())

    @torch.no_grad()
    def update(self, grads: Tree, state: OptState, params: Tree, ctx=None,
               specs: Tree = None) -> tuple[Tree, OptState, dict]:
        """One step, in place. Returns (params, new state, metrics ``grad_norm`` and ``lr``).

        ``params`` and the moments of ``state`` are updated in place and
        returned; ``state.count`` is not touched (the new state holds count + 1).
        Over a mesh (``ctx``, ``specs``: the params' specs) the leaves are
        this rank's shards and the norm is the whole tree's.
        """
        count = state.count + 1
        gnorm = global_norm(grads, ctx, specs)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        lr = self.lr(count)
        c1 = 1.0 - torch.pow(self.b1, count.float())
        c2 = 1.0 - torch.pow(self.b2, count.float())

        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                              tree_leaves(params)):
            g = g.contiguous()
            decay = bool(self.weight_decay) and p.ndim >= 2  # none on norms/biases
            rows = max(1, -(-p.shape[0] // self.scan_chunks)) if p.ndim else 1
            for gc, mc, vc, pc in zip(_chunks(g, rows), _chunks(m, rows), _chunks(v, rows), _chunks(p, rows)):
                g32 = gc.float() * scale
                m32 = self.b1 * mc.float() + (1 - self.b1) * g32
                v32 = self.b2 * vc.float() + (1 - self.b2) * torch.square(g32)
                step = lr * (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
                if decay:
                    step = step + lr * self.weight_decay * pc.float()
                pc.copy_(pc.float() - step)
                mc.copy_(m32)
                vc.copy_(v32)
        return params, OptState(mu=state.mu, nu=state.nu, count=count), {"grad_norm": gnorm, "lr": lr}
