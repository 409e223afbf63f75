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

The logical axis names are kept on the descriptors, but nothing maps them
to devices yet: the reference's ``ShardingRules`` and friends place tensors
over a mesh of several devices (ROADMAP Queue 1 item 9).

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
from typing import Any, Callable

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
