"""A minimal parameter system: descriptors, materialized params, abstract params.

The counterpart of ``repro.models.module``. Every weight is declared once as
a :class:`TensorDesc` (shape, logical axis names, init law, dtype); from one
descriptor tree (nested dicts) come

  * materialized params (``init_params``): nested dicts of tensors;
  * abstract params (``abstract_params``): the same tree on the ``meta``
    device, with shapes and dtypes and no storage.

Layer weights are declared once and stacked ``[L, ...]`` (``stacked``), as
in the reference, so a tree of the reference's params carries across leaf
by leaf (``repro_torch.convert.lm_params_from_tree``).

Logical axis names map to the axes of a mesh of ranks
(:class:`repro_torch.models.collectives.Mesh`) through one rule table
(:class:`ShardingRules`: ``TRAIN_RULES``, ``SERVE_RULES``,
``DECODE_RULES``, ``ZERO_RULES``), as the reference's: ``resolve_spec``
gives each tensor a :class:`PartitionSpec`, ``shard_init`` materializes only
a rank's shard of every weight, and :class:`ShardingCtx`, threaded through
every model function, issues the collectives that GSPMD inserts for the
reference (``weight``: gather a stored shard for use, and reduce-scatter
its gradient back; ``constrain``: move an activation between layouts).

Init differs from the reference's on purpose. The reference keys each leaf
with ``fold_in(key, hash(path) % 2**31)``, and Python salts ``hash`` of a
``str`` per process, so its init changes from run to run. Here the leaf key
is ``fold_in(key, crc32(path) % 2**31)``, stable across processes and
devices, and the draw is :func:`repro_torch.core.prng.normal`: the same
random bits on the CPU and on the card, turned into normals by each
device's ``log1p`` and ``sqrt``, so the two agree to float32 rounding, not
bit for bit. Tests that compare the two packages carry weights across
instead of comparing inits.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import prng

Params = Any  # nested dict[str, ...] of torch.Tensor
Tree = Any

# elements drawn at a time (a leaf's piece i from fold_in(leaf key, i)):
# bounds the int64 temporaries of the counter hash to a few hundred MB
_DRAW_PIECE = 1 << 24


@dataclasses.dataclass(frozen=True)
class TensorDesc:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 1.0  # stddev for normal/scaled init
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def desc(shape: tuple[int, ...], axes: tuple[str | None, ...], init: str = "normal",
         scale: float = 1.0, dtype: torch.dtype = torch.float32) -> TensorDesc:
    """A :class:`TensorDesc` (shape and axes as tuples)."""
    return TensorDesc(tuple(shape), tuple(axes), init, scale, dtype)


def fan_in_desc(shape: tuple[int, ...], axes: tuple[str | None, ...], fan_in: int,
                dtype: torch.dtype = torch.float32) -> TensorDesc:
    """He/LeCun-style 1/sqrt(fan_in) normal init."""
    return TensorDesc(tuple(shape), tuple(axes), "normal", 1.0 / math.sqrt(max(fan_in, 1)), dtype)


def map_descs(fn: Callable[[TensorDesc], Any], tree: Tree) -> Tree:
    """``tree`` (nested dicts) with ``fn`` applied to every descriptor."""
    if isinstance(tree, TensorDesc):
        return fn(tree)
    return {k: map_descs(fn, v) for k, v in tree.items()}


def flatten_descs(tree: Tree, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], TensorDesc]]:
    """(path, descriptor) pairs in the reference's leaf order (dict keys sorted)."""
    if isinstance(tree, TensorDesc):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten_descs(tree[k], (*prefix, k)))
    return out


def stacked(tree: Tree, num: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacking dim (the layer stack) to every descriptor."""
    return map_descs(
        lambda d: TensorDesc((num, *d.shape), (axis_name, *d.axes), d.init, d.scale, d.dtype), tree
    )


def _path_str(path: tuple[str, ...]) -> str:
    return "/".join(path)


def _init_leaf(key: torch.Tensor, d: TensorDesc, device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {d.init!r}")
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    flat = out.view(-1)
    for i, start in enumerate(range(0, flat.numel(), _DRAW_PIECE)):
        n = min(_DRAW_PIECE, flat.numel() - start)
        flat[start : start + n] = d.scale * prng.normal(prng.fold_in(key, i), (n,))
    return out


def init_params(key: torch.Tensor, descs: Tree, device: str | torch.device = "cpu") -> Params:
    """Materialize a descriptor tree on ``device``; each leaf draws from a path-derived key.

    The leaf at path ``p`` is drawn ``_DRAW_PIECE`` elements at a time,
    piece i as ``scale * normal(fold_in(fold_in(key, crc32(p) % 2**31), i))``.
    The bits depend only on ``key`` and the tree; the normals made from
    them agree across devices to float32 rounding.
    """
    device = torch.device(device)
    key = key.to(device)

    def leaf(path: tuple[str, ...], d: TensorDesc) -> torch.Tensor:
        k = prng.fold_in(key, zlib.crc32(_path_str(path).encode()) % (2**31))
        return _init_leaf(k, d, device)

    def build(tree: Tree, prefix: tuple[str, ...]) -> Tree:
        if isinstance(tree, TensorDesc):
            return leaf(prefix, tree)
        return {k: build(v, (*prefix, k)) for k, v in tree.items()}

    return build(descs, ())


def abstract_params(descs: Tree) -> Params:
    """The param tree on the ``meta`` device: shapes and dtypes, no allocation."""
    return map_descs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), descs)


# ---------------------------------------------------------------------------
# Logical -> mesh sharding
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """Mesh axes per dim, as the reference's ``PartitionSpec``: ``None``, an axis name, or a tuple of
    names (major to minor); trailing ``None``\\ s are dropped."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes of ``dim`` as a tuple (``()`` when replicated)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else ((e,) if isinstance(e, str) else tuple(e))

    @classmethod
    def of(cls, *dims: tuple[str, ...] | None) -> "PartitionSpec":
        """The spec whose dim i splits over the axes ``dims[i]`` (``()`` or ``None``: replicated)."""
        out = [tuple(d or ()) for d in dims]
        while out and not out[-1]:
            out.pop()
        return cls(*[None if not d else (d[0] if len(d) == 1 else d) for d in out])


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axis (tuples).

    ``None`` value = replicate. Missing key = replicate. ``table`` shards
    parameter STORAGE and activations; ``use_table`` (optional) shards
    parameters at USE time (``ShardingCtx.weight``): stored sharded over
    many axes, gathered (or partly gathered) right before the product, which
    is how ZeRO/FSDP is expressed. With ``use_table=None`` weight use falls
    back to "storage spec minus the FSDP axes". Divisibility is checked per
    shape at resolution time.
    """

    table: Mapping[str, tuple[str, ...] | str | None]
    use_table: Mapping[str, tuple[str, ...] | str | None] | None = None

    def mesh_axes(self, logical: str | None, use: bool = False) -> tuple[str, ...]:
        """The mesh axes ``logical`` maps to (at use time when ``use``); ``()`` = replicated."""
        if logical is None:
            return ()
        if use and self.use_table is not None:
            v = self.use_table.get(logical)  # missing key = replicated at use
        else:
            v = self.table.get(logical)
        if v is None:
            return ()
        return (v,) if isinstance(v, str) else tuple(v)


# Default rules: 2-D weight sharding ("fsdp" over data x "tensor" over model),
# batch data-parallel over (pod, data). The reference's tables, copied.
TRAIN_RULES = ShardingRules(
    table={
        "batch": ("pod", "data"),
        "seq": None,
        "vocab": ("model",),
        "embed": ("data",),
        "embed_out": ("data",),
        "mlp": ("model",),
        "q_heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "kv_head_dim": None,
        "experts": None,
        "layers": None,
        "inner": ("model",),  # mamba d_inner / conv channels
        "ssm_heads": ("model",),
        "state": None,
        "conv": None,
        "latent": None,  # MLA lora ranks
        "act_embed": None,  # activation d_model axis
        "cache_seq": None,
        # the loss/head boundary: batch over (pod, data) only, so the
        # vocab-parallel head has the model axis free (per loss chunk)
        "loss_batch": ("pod", "data"),
        # flash q-block axis for sequence-parallel prefill (attention.py)
        "qblocks": ("model",),
    }
)

# Serving: weights as for training; the KV cache sequence-sharded over
# "model" (decode merges per-shard partial softmaxes with small all-reduces)
SERVE_RULES = ShardingRules(table={**TRAIN_RULES.table, "cache_seq": ("model",)})

# Decode: weights used as stored (use_table == table); prefill keeps SERVE_RULES
DECODE_RULES = ShardingRules(table=SERVE_RULES.table, use_table=SERVE_RULES.table)

# Pure ZeRO: batch over every mesh axis, weights stored 2-D sharded and
# gathered whole at use, except the vocabulary (head and table), which stays
# tensor-parallel over "model"
ZERO_RULES = ShardingRules(
    table={
        **TRAIN_RULES.table,
        "batch": ("pod", "data", "model"),
        "embed": ("data", "model"),
        "mlp": None,
        "q_heads": None,
        "kv_heads": None,
        "inner": None,
        "ssm_heads": None,
        "latent": None,
    },
    use_table={"vocab": ("model",)},
)

FSDP_AXES = ("data", "pod")  # mesh axes weights are *stored* sharded over and gathered at use


def resolve_spec(shape: tuple[int, ...], axes: tuple[str | None, ...], rules: ShardingRules, mesh: Any,
                 use: bool = False) -> PartitionSpec:
    """The :class:`PartitionSpec` of one tensor of global ``shape`` with logical ``axes``.

    A dim that does not divide the product of its mapped mesh axes falls
    back to ever shorter prefixes of the axis tuple (batch 256 on
    ``("pod", "data", "model")`` = 512 ranks resolves to ``("pod",
    "data")``), and to replication when no prefix divides; a mesh axis
    serves one dim at most. Only ``mesh.shape`` is read.
    """
    used: set[str] = set()
    out: list[tuple[str, ...]] = []
    for dim, ax in zip(shape, axes):
        names = tuple(n for n in rules.mesh_axes(ax, use=use) if n in mesh.shape and n not in used)
        chosen: tuple[str, ...] = ()
        while names:
            if dim > 0 and dim % math.prod(mesh.shape[n] for n in names) == 0:
                chosen = names
                break
            names = names[:-1]
        used.update(chosen)
        out.append(chosen)
    return PartitionSpec.of(*out)


def spec_drop(spec: PartitionSpec, drop: set[str] | tuple[str, ...]) -> PartitionSpec:
    """``spec`` without the mesh axes in ``drop`` (trailing ``None``\\ s dropped)."""
    return PartitionSpec.of(*[tuple(a for a in spec.axes(d) if a not in drop) for d in range(len(spec))])


def local_box(shape: tuple[int, ...], spec: PartitionSpec, mesh: Any, rank: int | None = None
              ) -> tuple[tuple[int, int], ...]:
    """The (start, stop) of ``rank``'s shard (default: this rank) in each dim of a tensor of ``shape``."""
    out = []
    for d, n in enumerate(shape):
        ax = spec.axes(d)
        c = n // mesh.axis_size(ax) if ax else n
        i = mesh.axis_index(ax, rank) if ax else 0
        out.append((i * c, (i + 1) * c))
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh: Any) -> tuple[int, ...]:
    """The shape of one rank's shard."""
    return tuple(b - a for a, b in local_box(shape, spec, mesh, rank=0))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's placement on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def local_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of one rank's shard of a tensor of ``shape``."""
        return local_shape(shape, self.spec, self.mesh)

    def box(self, shape: tuple[int, ...], rank: int | None = None) -> tuple[tuple[int, int], ...]:
        """``rank``'s shard (default: this rank) as (start, stop) per dim."""
        return local_box(shape, self.spec, self.mesh, rank)


def param_specs(descs: Tree, rules: ShardingRules, mesh: Any) -> Tree:
    """The :class:`PartitionSpec` of every descriptor."""
    return map_descs(lambda d: resolve_spec(d.shape, d.axes, rules, mesh), descs)


def param_shardings(descs: Tree, rules: ShardingRules, mesh: Any) -> Tree:
    """The :class:`Sharding` of every descriptor."""
    return map_descs(lambda d: Sharding(mesh, resolve_spec(d.shape, d.axes, rules, mesh)), descs)


def _draw_box(key: torch.Tensor, d: TensorDesc, box: tuple[tuple[int, int], ...],
              device: torch.device) -> torch.Tensor:
    """The ``box`` of the leaf ``_init_leaf`` draws, drawing only the pieces its flat range meets."""
    shape = d.shape
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    lo = sum(a * s for (a, _), s in zip(box, strides))
    hi = sum((b - 1) * s for (_, b), s in zip(box, strides)) + 1
    total = math.prod(shape)
    buf = torch.empty(hi - lo, dtype=d.dtype, device=device)
    for i in range(lo // _DRAW_PIECE, (hi - 1) // _DRAW_PIECE + 1):
        start = i * _DRAW_PIECE
        n = min(_DRAW_PIECE, total - start)
        a, b = max(lo, start), min(hi, start + n)
        piece = d.scale * prng.normal(prng.fold_in(key, i), (n,))
        buf[a - lo : b - lo] = piece[a - start : b - start]
    return torch.as_strided(buf, [b - a for a, b in box], strides, 0).clone()


def shard_init(key: torch.Tensor, descs: Tree, rules: ShardingRules, mesh: Any,
               device: str | torch.device = "cpu") -> Params:
    """This rank's shard of every leaf of ``init_params(key, descs)``, bit for bit, on ``device``.

    Each leaf draws only the pieces of ``_DRAW_PIECE`` elements that its
    shard's flat range meets, so a leaf sharded along its first dim draws
    about its shard, and one sharded along a later dim draws up to the
    whole leaf (the peak is the largest leaf).
    """
    device = torch.device(device)
    key = key.to(device)

    def build(tree: Tree, prefix: tuple[str, ...]) -> Tree:
        if isinstance(tree, TensorDesc):
            box = local_box(tree.shape, resolve_spec(tree.shape, tree.axes, rules, mesh), mesh)
            if tree.init in ("zeros", "ones"):
                fill = torch.zeros if tree.init == "zeros" else torch.ones
                return fill([b - a for a, b in box], dtype=tree.dtype, device=device)
            if tree.init not in ("normal", "scaled"):
                raise ValueError(f"unknown init {tree.init!r}")
            k = prng.fold_in(key, zlib.crc32(_path_str(prefix).encode()) % (2**31))
            return _draw_box(k, tree, box, device)
        return {k: build(v, (*prefix, k)) for k, v in tree.items()}

    return build(descs, ())


def gather_full(x: torch.Tensor, spec: PartitionSpec, mesh: Any) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x`` laid out by ``spec`` (a collective; no autograd)."""
    from repro_torch.models.collectives import gather_raw

    for d in range(len(spec)):
        if spec.axes(d):
            x = gather_raw(x, d, mesh.group(spec.axes(d)))
    return x


def shard_of(x: torch.Tensor, spec: PartitionSpec, mesh: Any) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` (a view; no communication)."""
    for d, (a, b) in enumerate(local_box(tuple(x.shape), spec, mesh)):
        x = x.narrow(d, a, b - a)
    return x


def logical(x: torch.Tensor, axes: tuple[str | None, ...], rules: ShardingRules | None, mesh: Any,
            shape: tuple[int, ...] | None = None, current: PartitionSpec | None = None) -> torch.Tensor:
    """``x`` (global ``shape``, laid out by ``current``) moved to the layout of logical ``axes``; no-op without a mesh."""
    if rules is None or mesh is None:
        return x
    return ShardingCtx(mesh=mesh, rules=rules).constrain(x, axes, shape, current)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Threaded through the model functions; ``mesh=None`` is the single-process run.

    Inputs and outputs of the steps are whole tensors; the activations
    in between are this rank's rows of the batch (``batch``: the global
    batch size, laid out by the logical axis ``act_batch``), and weights,
    optimizer moments and caches are this rank's shards. A weight's
    descriptor (:class:`TensorDesc`: global shape and logical axes) gives
    its specs; ``cache_len`` is the global length of the decode caches.
    """

    mesh: Any = None
    rules: ShardingRules | None = None
    batch: int | None = None
    cache_len: int | None = None
    act_batch: str = "batch"

    @property
    def active(self) -> bool:
        """Whether a mesh and rules are set."""
        return self.mesh is not None and self.rules is not None

    # ---- layouts ---------------------------------------------------------

    def spec(self, shape: tuple[int, ...], axes: tuple[str | None, ...], use: bool = False) -> PartitionSpec:
        """:func:`resolve_spec` on this context's mesh and rules (``P()`` without a mesh)."""
        return resolve_spec(shape, axes, self.rules, self.mesh, use) if self.active else PartitionSpec()

    def group(self, axes: tuple[str, ...]):
        """The :class:`~repro_torch.models.collectives.AxisGroup` along ``axes``."""
        from repro_torch.models.collectives import AxisGroup

        return self.mesh.group(axes) if self.active else AxisGroup((), 1, 0)

    def index(self, axes: tuple[str, ...]) -> int:
        """This rank's position along ``axes`` (0 without a mesh)."""
        return self.mesh.axis_index(axes) if self.active and axes else 0

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """The mesh axes the activations' batch rows are split over."""
        if not self.active or self.batch is None:
            return ()
        return self.spec((self.batch,), (self.act_batch,)).axes(0)

    def with_batch(self, batch: int, cache_len: int | None = None) -> "ShardingCtx":
        """This context for activations of ``batch`` global rows (and caches of ``cache_len`` slots)."""
        return dataclasses.replace(self, batch=batch, cache_len=cache_len)

    def loss_ctx(self) -> "ShardingCtx":
        """This context at the loss boundary: rows laid out by ``loss_batch``."""
        return dataclasses.replace(self, act_batch="loss_batch")

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch tensor (``t`` replicated on every rank)."""
        ax = self.batch_axes
        if not ax:
            return t
        c = t.shape[0] // self.mesh.axis_size(ax)
        return t.narrow(0, self.index(ax) * c, c)

    def relayout(self, x: torch.Tensor, src: PartitionSpec, dst: PartitionSpec) -> torch.Tensor:
        """``x``, laid out by ``src``, laid out by ``dst``: gathers and slices, each differentiated exactly.

        A dim whose ``dst`` axes are a prefix of its ``src`` axes gathers
        over the rest only.
        """
        from repro_torch.models.collectives import all_gather, local_slice

        if not self.active:
            return x
        for d in range(max(len(src), len(dst))):
            s, t = src.axes(d), dst.axes(d)
            if s == t:
                continue
            if s[: len(t)] == t:
                x = all_gather(x, d, self.group(s[len(t):]))
                continue
            if s:
                x = all_gather(x, d, self.group(s))
            if t:
                x = local_slice(x, d, self.group(t))
        return x

    def constrain(self, x: torch.Tensor, axes: tuple[str | None, ...], shape: tuple[int, ...] | None = None,
                  current: PartitionSpec | None = None) -> torch.Tensor:
        """``x`` moved to the layout of logical ``axes`` (the reference's ``with_sharding_constraint``).

        ``shape`` is ``x``'s global shape and ``current`` its layout now;
        without them ``x`` is taken to be in that layout already, and
        returned as it is (the constraint only documents it).
        """
        if not self.active or shape is None or current is None:
            return x
        return self.relayout(x, current, self.spec(shape, axes))

    def psum(self, x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        """The sum of ``x`` over ``axes`` (a product's partial sums over a sharded contraction dim)."""
        from repro_torch.models.collectives import all_reduce

        return all_reduce(x, self.group(axes)) if self.active and axes else x

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch's shards of a per-shard mean (each shard holds as many rows)."""
        ax = self.batch_axes
        return self.psum(x, ax) / self.mesh.axis_size(ax) if ax else x

    # ---- weights ---------------------------------------------------------

    def weight_specs(self, d: TensorDesc) -> tuple[PartitionSpec, PartitionSpec]:
        """(storage spec, use spec) of the weight described by ``d``.

        The use spec is ``use_table``'s (``ZERO_RULES``: the vocabulary over
        ``model``; ``DECODE_RULES``: the storage), else the storage, in both
        cases minus ``FSDP_AXES``. So at use a weight is split over
        ``model`` at most: under ``DECODE_RULES`` on a mesh with ``data`` > 1
        a weight stored over ``data`` is gathered at use, where the
        reference uses it in place and GSPMD moves the rows instead (the
        values are the same).
        """
        store = self.spec(d.shape, d.axes)
        use = self.spec(d.shape, d.axes, use=True) if self.rules.use_table is not None else store
        return store, spec_drop(use, FSDP_AXES)

    def weight(self, w: torch.Tensor, d: TensorDesc) -> torch.Tensor:
        """The stored shard ``w`` of the weight ``d`` laid out for use: gathered over what the use spec drops.

        Its backward reduce-scatters the gradient back to the storage
        shards (the reference pins the storage spec first for that).

        Raises:
            ValueError: ``w`` is not the shape of ``d``'s shard on this rank.
        """
        if not self.active:
            return w
        store, use = self.weight_specs(d)
        want = local_shape(d.shape, store, self.mesh)
        if tuple(w.shape) != want:
            raise ValueError(f"weight {d.axes} of shape {d.shape}: the shard here is {want}, got {tuple(w.shape)}")
        return self.relayout(w, store, use)

    def weight_axes(self, d: TensorDesc, dim: int) -> tuple[str, ...]:
        """The mesh axes that split ``dim`` of the weight ``d`` at use (``()`` without a mesh)."""
        return self.weight_specs(d)[1].axes(dim) if self.active else ()

    def sync_grads(self, grads: list[torch.Tensor], specs: list[PartitionSpec]) -> list[torch.Tensor]:
        """Each leaf's gradient summed over the mesh axes its storage spec replicates it on (in place)."""
        from repro_torch.models.collectives import reduce_raw

        if not self.active:
            return grads
        out = []
        for g, spec in zip(grads, specs):
            held = {a for d in range(len(spec)) for a in spec.axes(d)}
            free = tuple(a for a in self.mesh.axis_names if a not in held and self.mesh.shape[a] > 1)
            out.append(reduce_raw(g, self.group(free)) if free else g)
        return out


NO_SHARDING = ShardingCtx()
