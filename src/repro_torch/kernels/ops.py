"""Dispatch of the Gram ops: per bucket, and per ring step.

``impl`` / ``gram_impl`` take the JAX package's spellings so that configs
carry over. For one bucket (:func:`bpmf_gram`):

  - ``"auto"``, ``"pallas"``, ``"pallas_fused"``: the hand-written kernel
    (:func:`repro_torch.kernels.bpmf_gram.bpmf_gram`), which launches the
    CUDA kernel on a CUDA tensor and takes the plain version on a CPU one.
    ``"pallas_fused"`` names the fused ring-step kernel in the JAX package;
    outside a ring step it means the per-bucket kernel there too;
  - ``"xla"``: the plain PyTorch version. It runs on CPU tensors only and
    raises on a CUDA tensor instead of quietly replacing the kernel.

For one ring step (:func:`bpmf_gram_step`), ``"auto"`` and
``"pallas_fused"`` launch the fused kernel once over the step's flattened
chunk layout (:func:`flatten_step`); ``"pallas"`` and ``"xla"`` run the
per-bucket op and add each bucket into ``(G, g)``. The JAX package's
autotune cache and measured step decisions are not ported: on a GPU the
fused kernel is the one that carries the ring.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.utils import round_up

# Chunk width of the fused layout. The JAX package sizes it from the TPU's
# VMEM budget; on Hopper the kernel stages 64 gathered [x | val] rows in
# shared memory at a time, and 128 = two such tiles keeps a chunk's
# neighbor ids and values in one 512-byte line each. It costs padding only
# in the layout, not in the kernel, which reads cnt[c] rows: a bucket with
# P < 128 pads its rows to 128 slots (8 bytes each).
FUSED_PC = 128
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-bucket gather+Gram op; returns ``(G [B, K, K], g [B, K])``.

    Raises:
        ValueError: An unknown ``impl``, or ``impl="xla"`` on a CUDA tensor.
    """
    if impl not in GRAM_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    if impl == "xla":
        if X.device.type != "cpu":
            raise ValueError(
                "impl='xla' is the plain PyTorch version, which runs only on CPU "
                f"tensors; on {X.device} use 'auto' (the CUDA kernel)"
            )
        return gram_kernel.bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    return gram_kernel.bpmf_gram(X, nbr, val, nnz, compute_dtype)


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


def bpmf_gram_step(
    G: torch.Tensor,
    g: torch.Tensor,
    X_src: torch.Tensor,
    buckets,
    *,
    alpha: float,
    compute_dtype: torch.dtype = torch.float32,
    gram_impl: str = "auto",
    layout: FusedStep | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Add one ring step's bucket contributions into ``(G, g)``, in place.

    The distributed half-sweeps call this once per ring step and shard.
    ``"auto"`` and ``"pallas_fused"`` launch the fused kernel once over the
    step's layout (``layout``, or one flattened here);
    ``"pallas"`` and ``"xla"`` run :func:`bpmf_gram` per bucket and add
    ``alpha * (G_b, g_b)`` into the bucket's rows. A bucket's rows are
    distinct, so each add touches a row once and the sums do not depend on
    the device; padding rows (``item_ids == -1``) add exact zeros.

    Args:
        G: ``[cap, K, K]`` float32 running Gram sums.
        g: ``[cap, K]`` float32 running linear terms.
        X_src: ``[Ns, K]`` opposite-side shard of this step.
        buckets: The step's ``Bucket`` tuple.
        alpha: Rating noise precision (scales both terms).
        compute_dtype: Gram input rounding (float32 or bfloat16).
        gram_impl: ``"auto" | "pallas_fused" | "pallas" | "xla"``.
        layout: The step's prebuilt :class:`FusedStep`.

    Returns:
        ``(G, g)``, the same tensors, updated.

    Raises:
        ValueError: An unknown ``gram_impl``, or ``"xla"`` on a CUDA tensor.
    """
    if gram_impl not in GRAM_IMPLS:
        raise ValueError(f"unknown gram_impl {gram_impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    if not buckets:
        return G, g
    if gram_impl in ("auto", "pallas_fused"):
        if layout is None:
            layout = fused_step(buckets)
        return gram_kernel.bpmf_gram_fused(
            G, g, X_src, layout.nbr, layout.val, layout.item, layout.cnt,
            alpha, compute_dtype, layout.order,
        )
    a = float(alpha)  # a float32 multiplier: the same product as a float32 tensor's, no host copy
    for b in buckets:
        Gb, gb = bpmf_gram(X_src, b.nbr, b.val, b.nnz, compute_dtype=compute_dtype, impl=gram_impl)
        live = (b.item_ids >= 0).to(torch.float32)
        rows = b.item_ids.clamp_min(0).long()
        G.index_add_(0, rows, (a * Gb) * live[:, None, None])
        g.index_add_(0, rows, (a * gb) * live[:, None])
    return G, g
