"""Dispatch of the Gram ops: per bucket, and per ring step.

``impl`` / ``gram_impl`` take the JAX package's spellings so that configs
carry over, and ``"auto"`` resolves through :mod:`repro_torch.kernels.autotune`
(a measured cache entry, else its heuristic). For one bucket
(:func:`bpmf_gram`):

  - ``"pallas"``, ``"pallas_fused"``: the hand-written kernel
    (:func:`repro_torch.kernels.bpmf_gram.bpmf_gram`), which launches the
    CUDA kernel on a CUDA tensor and takes the plain version on a CPU one.
    ``"pallas_fused"`` names the fused ring-step kernel in the JAX package;
    outside a ring step it means the per-bucket kernel there too. ``piece``
    sets the kernel's piece width (default: its ``piece_width`` rule);
  - ``"xla"``: the plain PyTorch version. It runs on CPU tensors only and
    raises on a CUDA tensor instead of quietly replacing the kernel;
  - ``"auto"``: the decision for the bucket's ``autotune.bucket_key``. On
    a CUDA tensor without a cache entry that is the kernel with the rule,
    on a CPU tensor the plain version.

For one ring step (:func:`bpmf_gram_step`) the dispatch is a
:class:`StepPlan`: the fused kernel launched once over the step's
flattened chunk layout (:func:`fused_step`) at the decided chunk width, or
the per-bucket op for each bucket with its own decision, added into
``(G, g)``. :func:`plan_step` makes the plan as the JAX package's
``bpmf_gram_step`` resolves it: ``"auto"`` looks up the step key first;
without an entry the heuristic decides fused or not, and when not, each
bucket resolves its own bucket key, so one step can mix implementations
from a warmed cache. The ring backends plan every (side, step, shard)
once, when they place their data, and capture what was planned.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.kernels.autotune import Decision
from repro_torch.utils import round_up

# Chunk width of the fused layout without a measurement (autotune.FUSED_PC
# says why 128).
FUSED_PC = autotune.FUSED_PC
# Chunk-count multiple of the layout, as in the JAX package; the CUDA
# kernel does not need it (padding chunks are dead and skipped).
FUSED_TB = 8

GRAM_IMPLS = ("auto", "pallas_fused", "pallas", "xla")


def bpmf_gram(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
    piece: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-bucket gather+Gram op; returns ``(G [B, K, K], g [B, K])``.

    Raises:
        ValueError: An unknown ``impl``, or ``impl="xla"`` on a CUDA tensor.
    """
    if impl not in GRAM_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    if impl == "auto":
        B, P = nbr.shape
        dec = autotune.decide(autotune.bucket_key(B, P, X.shape[0], X.shape[1], compute_dtype, X.device.type))
        impl, piece = dec.impl, piece or dec.piece
    if impl == "xla":
        if X.device.type != "cpu":
            raise ValueError(
                "impl='xla' is the plain PyTorch version, which runs only on CPU "
                f"tensors; on {X.device} use 'auto' (the CUDA kernel)"
            )
        return gram_kernel.bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    return gram_kernel.bpmf_gram(X, nbr, val, nnz, compute_dtype, piece)


def _pad_rows(x: torch.Tensor, multiple: int, fill: int = 0) -> torch.Tensor:
    extra = round_up(max(x.shape[0], 1), multiple) - x.shape[0]
    if extra == 0:
        return x
    pad = x.new_full((extra,) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def flatten_step(buckets, pc: int, tb: int):
    """Flatten a ring step's buckets into the fused kernel's chunk layout.

    Every bucket row is split into ``ceil(P / pc)`` width-``pc`` chunks
    (rows pad to a ``pc`` multiple with empty slots); chunks carry their
    destination item row and their own valid count, so the kernel needs no
    per-bucket metadata. The layout of ``repro.kernels.ops.flatten_step``.

    Args:
        buckets: The step's ``Bucket`` tuple (``item_ids`` may hold -1
            padding rows, which become dead chunks).
        pc: Chunk width.
        tb: The chunk count pads to a multiple of it.

    Returns:
        ``(nbr [C, pc], val [C, pc], item [C], cnt [C])`` with
        ``C % tb == 0``; dead chunks have ``item == -1`` and ``cnt == 0``.
    """
    nbrs, vals, items, cnts = [], [], [], []
    for b in buckets:
        B, P = b.nbr.shape
        ck = round_up(P, pc) // pc
        extra = ck * pc - P
        nbr, val = b.nbr, b.val
        if extra:
            nbr = torch.cat([nbr, nbr.new_zeros(B, extra)], dim=1)
            val = torch.cat([val, val.new_zeros(B, extra)], dim=1)
        nbrs.append(nbr.reshape(B * ck, pc))
        vals.append(val.reshape(B * ck, pc))
        items.append(torch.repeat_interleave(b.item_ids, ck))
        offs = torch.arange(ck, dtype=torch.int32, device=b.nnz.device) * pc
        cnts.append((b.nnz[:, None] - offs[None, :]).clamp(0, pc).reshape(B * ck))
    nbr = _pad_rows(torch.cat(nbrs), tb)
    val = _pad_rows(torch.cat(vals), tb)
    item = _pad_rows(torch.cat(items), tb, fill=-1)
    cnt = _pad_rows(torch.cat(cnts), tb)
    return nbr, val, item.to(torch.int32), cnt.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FusedStep:
    """One ring step's flattened layout, its item -> chunk order and piece plan, built once."""

    nbr: torch.Tensor  # [C, pc] int32
    val: torch.Tensor  # [C, pc] float32
    item: torch.Tensor  # [C] int32, -1 = dead chunk
    cnt: torch.Tensor  # [C] int32
    order: gram_kernel.ChunkOrder

    @property
    def num_rows(self) -> int:
        """Destination rows with a live chunk; 0 means the step launches nothing."""
        return self.order.num_rows


def fused_step(buckets, pc: int = FUSED_PC, tb: int = FUSED_TB) -> FusedStep:
    """:func:`flatten_step` plus the kernel's :func:`~repro_torch.kernels.bpmf_gram.chunk_order`.

    A block of the fused kernel walks at most ``PIECE_RATINGS // pc``
    chunks of one row (16 at ``pc = 128``, 2,048 ratings), the same piece
    size as the per-bucket kernel's.
    """
    nbr, val, item, cnt = flatten_step(buckets, pc, tb)
    piece_chunks = max(1, gram_kernel.PIECE_RATINGS // pc)
    return FusedStep(nbr, val, item, cnt, gram_kernel.chunk_order(item, cnt, piece_chunks))


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """A ring step's Gram dispatch, resolved once.

    ``decision`` is the step's own. A fused step carries its layout
    (``layout``, at ``decision.pc``); any other step carries one decision
    per bucket (``buckets``), which may differ between buckets.
    """

    decision: Decision
    layout: FusedStep | None = None
    buckets: tuple[Decision, ...] = ()

    @property
    def fused(self) -> bool:
        return self.layout is not None

    @classmethod
    def for_decision(cls, decision: Decision, buckets) -> "StepPlan":
        """The plan that runs ``decision`` for the whole step (every bucket alike when not fused)."""
        if decision.impl == "pallas_fused":
            return cls(decision, layout=fused_step(buckets, decision.pc or FUSED_PC))
        return cls(decision, buckets=(Decision(decision.impl, piece=decision.piece),) * len(buckets))


def plan_step(buckets, Ns: int, K: int, cap: int, *, compute_dtype: torch.dtype = torch.float32,
              gram_impl: str = "auto", backend: str = "cuda") -> StepPlan:
    """Resolve one ring step's dispatch, as the JAX package's ``bpmf_gram_step`` does.

    ``"auto"``: an entry for the step's ``autotune.step_key`` pins the
    whole step; without one the heuristic decides fused or not, and when
    not, each bucket takes the decision for its own ``bucket_key``.
    ``"pallas_fused"``: the fused kernel at ``FUSED_PC``; ``"pallas"`` and
    ``"xla"``: that op for every bucket. A fused plan builds its layout on
    the buckets' device.

    Raises:
        ValueError: An unknown ``gram_impl``, or K above the kernels' limit
            on a CUDA key.
    """
    if gram_impl not in GRAM_IMPLS:
        raise ValueError(f"unknown gram_impl {gram_impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    shapes = [(b.B, b.P) for b in buckets]
    if gram_impl == "auto":
        skey = autotune.step_key(shapes, Ns, K, cap, compute_dtype, backend)
        dec = autotune.get_cache().lookup(skey)
        if dec is None:
            dec = autotune.heuristic(skey)
            if dec.impl != "pallas_fused":
                return StepPlan(dec, buckets=tuple(
                    autotune.decide(autotune.bucket_key(B, P, Ns, K, compute_dtype, backend))
                    for B, P in shapes))
    elif gram_impl == "pallas_fused":
        dec = Decision("pallas_fused", pc=FUSED_PC)
    else:
        dec = Decision(gram_impl)
    return StepPlan.for_decision(dec, buckets)


def bpmf_gram_step(
    G: torch.Tensor,
    g: torch.Tensor,
    X_src: torch.Tensor,
    buckets,
    *,
    alpha: float,
    compute_dtype: torch.dtype = torch.float32,
    gram_impl: str = "auto",
    plan: StepPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Add one ring step's bucket contributions into ``(G, g)``, in place.

    The distributed half-sweeps call this once per ring step and shard,
    with the ``plan`` made when the data was placed; without one the step
    is planned here from ``gram_impl`` (:func:`plan_step`). A fused plan
    launches the fused kernel once over its layout; otherwise each bucket
    runs :func:`bpmf_gram` with its decision and ``alpha * (G_b, g_b)`` is
    added into the bucket's rows. A bucket's rows are distinct, so each add
    touches a row once and the sums do not depend on the device; padding
    rows (``item_ids == -1``) add exact zeros.

    Args:
        G: ``[cap, K, K]`` float32 running Gram sums.
        g: ``[cap, K]`` float32 running linear terms.
        X_src: ``[Ns, K]`` opposite-side shard of this step.
        buckets: The step's ``Bucket`` tuple.
        alpha: Rating noise precision (scales both terms).
        compute_dtype: Gram input rounding (float32 or bfloat16).
        gram_impl: ``"auto" | "pallas_fused" | "pallas" | "xla"``, used
            when no ``plan`` is given.
        plan: The step's prebuilt :class:`StepPlan`.

    Returns:
        ``(G, g)``, the same tensors, updated.

    Raises:
        ValueError: An unknown ``gram_impl``, or ``"xla"`` on a CUDA tensor.
    """
    if gram_impl not in GRAM_IMPLS:
        raise ValueError(f"unknown gram_impl {gram_impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    if not buckets:
        return G, g
    if plan is None:
        Ns, K = X_src.shape
        plan = plan_step(buckets, Ns, K, G.shape[0], compute_dtype=compute_dtype, gram_impl=gram_impl,
                         backend=X_src.device.type)
    if plan.fused:
        layout = plan.layout
        return gram_kernel.bpmf_gram_fused(
            G, g, X_src, layout.nbr, layout.val, layout.item, layout.cnt,
            alpha, compute_dtype, layout.order,
        )
    a = float(alpha)  # a float32 multiplier: the same product as a float32 tensor's, no host copy
    for b, dec in zip(buckets, plan.buckets, strict=True):
        Gb, gb = bpmf_gram(X_src, b.nbr, b.val, b.nnz, compute_dtype=compute_dtype, impl=dec.impl,
                           piece=dec.piece)
        live = (b.item_ids >= 0).to(torch.float32)
        rows = b.item_ids.clamp_min(0).long()
        _add_rows(G, rows, (a * Gb) * live[:, None, None])
        _add_rows(g, rows, (a * gb) * live[:, None])
    return G, g


def _add_rows(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[rows[i]] += src[i]`` in place, for distinct rows (padding rows add exact zeros to row 0).

    One float add per entry either way, so the bits do not depend on the
    route. On the CPU ``index_add_`` issues one small add per row, each a
    parallel region (milliseconds per bucket beside other busy processes),
    so the CPU takes the one-pass accumulating ``index_put_``; the card
    keeps ``index_add_``.
    """
    if dst.device.type == "cpu":
        dst.index_put_((rows,), src, accumulate=True)
    else:
        dst.index_add_(0, rows, src)
