"""The LM's mesh of ``torch.distributed`` ranks and the collectives along its axes.

The reference places tensors on a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. Here a :class:`Mesh` names the axes of a job's
ranks (row-major: rank ``r`` of a ``("data", "model")`` mesh of shape
``(d, m)`` sits at ``(r // m, r % m)``), holds one process group per set of
axes, and the collectives are explicit ``torch.autograd.Function``\\ s, each
with its exact adjoint as its backward:

* :func:`all_gather` (concatenate the ranks' blocks along a dim) and
  :func:`reduce_scatter` (sum, then keep this rank's block), each the
  other's backward;
* :func:`all_reduce` (sum), its own backward;
* :func:`local_slice` (this rank's block of a replicated tensor), whose
  backward pads with zeros and moves nothing.

With every collective differentiated exactly, each rank's backward pass
computes the gradient of the sum of every rank's scalar output, so a loss
that is the same on every rank is differentiated at weight
``1 / mesh.size`` and each weight's gradient is then summed over the axes
it is replicated on (``ShardingCtx.sync_grads``). A block "along axes
``(a, b)``" is indexed major to minor, as a ``PartitionSpec`` entry is.

Every collective hands its tensor to the job's backend as it is. Under
``gloo`` (the ranks of a job on one card share it) that holds for tensors
on the card too: ``gloo`` gave the right results for every collective and
for ``bfloat16``, and ran faster than staging the tensors through pinned
host memory by hand, while ``torch.distributed.tensor``'s ``redistribute``
killed the rank (``scripts/lm_mesh_probe.py``). Sums of ``bfloat16`` and
``float16`` tensors run in float32. :data:`STATS` counts every
collective's calls, payload bytes and host seconds.

A mesh made by :meth:`Mesh.abstract` has a shape and one rank's point of
view (rank 0 unless given) and no processes behind it: enough to resolve
specs and to trace that rank's step on the ``meta`` device for the dry run
(:mod:`repro_torch.launch.dryrun`). Its groups are abstract: each
collective there does the local work it does on a real group, returns a
tensor of the shape the group would give (an all-gather the dim times the
group's size, a reduce-scatter one block, an all-reduce the same shape),
records its op, payload bytes and group with the active
:class:`~repro_torch.launch.op_analysis.OpCostModel`, and moves nothing.
:data:`STATS` counts only what really runs.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Sequence

import torch

#: calls, payload bytes (what each rank hands to the collectives) and host seconds spent in them
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    """Zero :data:`STATS`."""
    STATS.update(calls=0, bytes=0, seconds=0.0)


class AxisGroup:
    """The ranks that share this rank's coordinates off ``axes``: one process group, ordered along ``axes``.

    ``size`` is the product of the axes' sizes and ``index`` this rank's
    position along them, major to minor. A group of size 1 moves nothing.
    """

    def __init__(self, axes: tuple[str, ...], size: int, index: int, pg=None, members: tuple[int, ...] = (),
                 abstract: bool = False):
        self.axes, self.size, self.index, self.pg = axes, size, index, pg
        self.members, self.abstract = members, abstract

    def __repr__(self) -> str:
        return f"AxisGroup(axes={self.axes}, size={self.size}, index={self.index})"


class Mesh:
    """Named axes over the ranks of a ``torch.distributed`` job (the reference's ``Mesh``).

    Build one with :meth:`create` (a collective: every rank of the job
    calls it with the same shape) or :meth:`abstract` (a shape only, for
    specs). ``shape`` maps axis names to sizes, as ``jax``'s ``mesh.shape``.
    """

    def __init__(self, sizes: Sequence[int], names: Sequence[str], rank: int = 0, abstract: bool = True):
        if len(sizes) != len(names):
            raise ValueError(f"mesh shape {tuple(sizes)} vs axis names {tuple(names)}")
        self.axis_names = tuple(names)
        self.sizes = tuple(int(s) for s in sizes)
        self.rank = rank
        self.is_abstract = abstract
        self._groups: dict[tuple[str, ...], AxisGroup] = {}

    @classmethod
    def abstract(cls, sizes: Sequence[int], names: Sequence[str], rank: int = 0) -> "Mesh":
        """A mesh of this shape seen from ``rank``, with no processes behind it (abstract groups)."""
        mesh = cls(sizes, names, rank=rank)
        if not 0 <= rank < mesh.size:
            raise ValueError(f"rank {rank} is not a rank of a mesh of shape {mesh.sizes}")
        return mesh

    @classmethod
    def create(cls, sizes: Sequence[int], names: Sequence[str]) -> "Mesh":
        """The mesh over this job's ranks (one rank outside a job); makes a process group per set of axes.

        Raises:
            ValueError: The mesh's size is not the job's process count.
        """
        from repro_torch.launch.hostdevices import multiprocess_active, process_count, process_index

        mesh = cls(sizes, names, rank=process_index(), abstract=False)
        if mesh.size != process_count():
            raise ValueError(f"a mesh of shape {mesh.sizes} needs {mesh.size} processes, the job has "
                             f"{process_count()}")
        # every rank creates every group, in one order, as torch.distributed.new_group requires
        for k in range(1, len(mesh.axis_names) + 1):
            for axes in itertools.combinations(mesh.axis_names, k):
                size = math.prod(mesh.shape[a] for a in axes)
                pg = None
                if size > 1 and multiprocess_active():
                    for members in mesh._partition(axes):
                        new = torch.distributed.new_group(members)
                        if mesh.rank in members:
                            pg = new
                mesh._groups[axes] = AxisGroup(axes, size, mesh.axis_index(axes), pg)
        return mesh

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in mesh order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of ranks."""
        return math.prod(self.sizes)

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """Axis name -> coordinate of ``rank`` (default: this rank), row-major."""
        r = self.rank if rank is None else rank
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % size
            r //= size
        return {n: out[n] for n in self.axis_names}

    def ordered(self, axes: Sequence[str]) -> tuple[str, ...]:
        """``axes`` checked to be distinct mesh axes in mesh order (a spec entry's order)."""
        axes = tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(set(order)):
            raise ValueError(f"axes {axes} are not distinct axes of {self.axis_names} in mesh order")
        return axes

    def axis_size(self, axes: Sequence[str]) -> int:
        """Product of the sizes of ``axes``."""
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes: Sequence[str], rank: int | None = None) -> int:
        """Position of ``rank`` (default: this rank) along ``axes``, major to minor."""
        c = self.coords(rank)
        idx = 0
        for a in self.ordered(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def _partition(self, axes: tuple[str, ...]) -> list[list[int]]:
        """The groups of ranks along ``axes``: ranks that agree off ``axes``, each list ascending."""
        groups: dict[tuple, list[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            groups.setdefault(tuple(c[a] for a in self.axis_names if a not in axes), []).append(r)
        return list(groups.values())

    def group(self, axes: Sequence[str]) -> AxisGroup:
        """The :class:`AxisGroup` of this rank along ``axes`` (size 1 for no axes)."""
        axes = self.ordered(axes)
        if not axes:
            return AxisGroup((), 1, 0)
        if self.is_abstract and axes not in self._groups:
            members = next(m for m in self._partition(axes) if self.rank in m)
            self._groups[axes] = AxisGroup(axes, len(members), self.axis_index(axes), members=tuple(members),
                                           abstract=True)
        return self._groups[axes]

    def __repr__(self) -> str:
        kind = "abstract " if self.is_abstract else ""
        return f"Mesh({kind}{self.shape}, rank={self.rank})"


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------


def _count(x: torch.Tensor, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += x.nbytes
    STATS["seconds"] += time.perf_counter() - t0


def _record(op: str, x: torch.Tensor, group: AxisGroup) -> None:
    """An abstract group's collective: recorded with the dry run's cost model, ``x``'s bytes as its payload."""
    from repro_torch.launch.op_analysis import record_collective

    record_collective(op, x.nbytes, group.axes, group.size, group.members)


def gather_raw(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in the group's order; no autograd."""
    if group.size == 1:
        return x
    t0 = time.perf_counter()
    send = x.contiguous()
    outs = [torch.empty_like(send) for _ in range(group.size)]
    if group.abstract:
        _record("all-gather", x, group)
    else:
        torch.distributed.all_gather(outs, send, group=group.pg)
    out = torch.cat(outs, dim=dim)
    if not group.abstract:
        _count(x, t0)
    return out


def reduce_raw(x: torch.Tensor, group: AxisGroup, op=None, _as: str = "all-reduce") -> torch.Tensor:
    """The sum (or ``op``) of the ranks' ``x``, on every rank of the group; no autograd."""
    if group.size == 1:
        return x
    t0 = time.perf_counter()
    buf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    if group.abstract:
        _record(_as, x, group)
    else:
        torch.distributed.all_reduce(buf, op=torch.distributed.ReduceOp.SUM if op is None else op,
                                     group=group.pg)
        _count(x, t0)
    return buf.to(x.dtype)


def _block(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"dim {dim} of size {n} does not split over {group.size} ranks of {group.axes}")
    c = n // group.size
    return x.narrow(dim, group.index * c, c)


def reduce_scatter_raw(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """The sum of the ranks' ``x``, this rank's block along ``dim``; no autograd.

    A sum and a slice, since not every ``gloo`` build has the fused collective
    (an abstract group records it as a reduce-scatter).
    """
    if group.size == 1:
        return x
    return _block(reduce_raw(x, group, _as="reduce-scatter"), dim, group).contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives (exact adjoints)
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_raw(g.contiguous(), ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_raw(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; backward: :func:`reduce_scatter`."""
    return x if group.size == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum; backward: :func:`all_gather`."""
    return x if group.size == 1 else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The group's sum on every rank; backward: the sum of the cotangents."""
    return x if group.size == 1 else _AllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The group's elementwise max, without a gradient (a softmax's shift)."""
    if group.size == 1:
        return x.detach()
    return reduce_raw(x.detach(), group, None if group.abstract else torch.distributed.ReduceOp.MAX)


def local_slice(x: torch.Tensor, dim: int, group: AxisGroup) -> torch.Tensor:
    """This rank's block of a tensor replicated over the group; backward pads with zeros."""
    return x if group.size == 1 else _block(x, dim, group)
