"""The gather + Gram kernels: CUDA kernels and their plain PyTorch versions.

For a bucket of B items, each with up to P neighbor ids into the opposite
side's factors ``X [Ns, K]``, compute per item::

    G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T        [K, K]
    g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}            [K]

:func:`bpmf_gram` is the port of ``repro/kernels/bpmf_gram.py:
bpmf_gram_pallas``. :func:`bpmf_gram_fused` is the port of
``bpmf_gram_fused``: one launch per ring step over the flattened chunk
layout of ``ops.flatten_step``, adding ``alpha`` times every chunk's
``(G, g)`` into the running sums of its destination row, in place. On a
CUDA tensor each launches its hand-written kernel in ``csrc/bpmf_gram.cu``
(the note there says what bounds them and how the design answers); on a
CPU tensor each runs its plain version. There is no other route: a CUDA
tensor never falls back to a plain version.

``LAUNCHES`` / ``FUSED_LAUNCHES`` count kernel launches and
``PLAIN_CALLS`` / ``FUSED_PLAIN_CALLS`` calls of the plain versions, so a
run can show which of the two did its work.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.build import load_library

LAUNCHES = 0
PLAIN_CALLS = 0
FUSED_LAUNCHES = 0
FUSED_PLAIN_CALLS = 0

MAX_K = 128  # the kernel keeps at most 33 sums per thread: K (K + 3) / 2 <= 33 * 256


def _round(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and back to float32 (identity for f32)."""
    if compute_dtype == torch.float32:
        return x.to(torch.float32)
    return x.to(compute_dtype).to(torch.float32)


def bpmf_gram_plain(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather once, then one augmented contraction ``Z = Y^T Y`` with ``Y = [Xn | val]``.

    Mirrors ``repro.kernels.ops._bpmf_gram_xla``: the masked ``[B, P, K]``
    neighbor block is built once, ``G = Z[:K, :K]`` and ``g = Z[:K, K]``.
    Inputs are rounded to ``compute_dtype``; the contraction runs in
    float64, where their products are exact, and rounds to float32 once.
    So this is the correctly rounded sum, a yardstick for any float32
    summation order: two float32 orders (the JAX package's and a BLAS
    one) can sit 2e-5 apart at the test shapes, each within 1e-5 of it.
    """
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    P = nbr.shape[1]
    mask = torch.arange(P, device=nbr.device)[None, :] < nnz[:, None]
    Xn = _round(X[nbr.long()], compute_dtype).double() * mask[..., None]
    Y = torch.cat([Xn, _round(val, compute_dtype).double()[..., None]], dim=-1)
    Z = torch.bmm(Y.transpose(1, 2), Y).float()
    return Z[:, :-1, :-1].contiguous(), Z[:, :-1, -1].contiguous()


def _check(X, nbr, val, nnz, compute_dtype) -> None:
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be a float32 [Ns, K] tensor, got {X.dtype} {tuple(X.shape)}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2:
        raise ValueError(f"nbr must be an int32 [B, P] tensor, got {nbr.dtype} {tuple(nbr.shape)}")
    if val.dtype != torch.float32 or val.shape != nbr.shape:
        raise ValueError(f"val must be float32 {tuple(nbr.shape)}, got {val.dtype} {tuple(val.shape)}")
    if nnz.dtype != torch.int32 or nnz.shape != nbr.shape[:1]:
        raise ValueError(f"nnz must be int32 [{nbr.shape[0]}], got {nnz.dtype} {tuple(nnz.shape)}")
    if not 1 <= X.shape[1] <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}, got K={X.shape[1]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    for name, t in (("X", X), ("nbr", nbr), ("val", val), ("nnz", nnz)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    loaded = load_library("bpmf_gram")
    lib = loaded.lib
    if lib.bpmf_gram_launch.argtypes is None:
        lib.bpmf_gram_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.bpmf_gram_launch.restype = ctypes.c_int
        lib.bpmf_gram_fused_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.bpmf_gram_fused_launch.restype = ctypes.c_int
        lib.bpmf_gram_error_string.argtypes = [ctypes.c_int]
        lib.bpmf_gram_error_string.restype = ctypes.c_char_p
    return lib


def bpmf_gram(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G [B, K, K], g [B, K])`` in float32: the CUDA kernel, or the plain version on CPU.

    Raises:
        ValueError: Wrong dtypes, shapes, devices, non-contiguous inputs or
            K outside ``[1, 128]`` (CUDA tensors).
        RuntimeError: The kernel failed to build or to launch.
    """
    if X.device.type == "cpu":
        return bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    if X.device.type != "cuda":
        raise ValueError(f"bpmf_gram runs on CPU or CUDA tensors, got {X.device}")
    _check(X, nbr, val, nnz, compute_dtype)
    B, P = nbr.shape
    Ns, K = X.shape
    G = torch.empty(B, K, K, dtype=torch.float32, device=X.device)
    g = torch.empty(B, K, dtype=torch.float32, device=X.device)
    if B == 0:
        return G, g
    lib = _library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.bpmf_gram_launch(
        X.data_ptr(), nbr.data_ptr(), val.data_ptr(), nnz.data_ptr(),
        G.data_ptr(), g.data_ptr(), B, P, Ns, K,
        int(compute_dtype == torch.bfloat16), stream,
    )
    if err:
        msg = lib.bpmf_gram_error_string(err).decode()
        raise RuntimeError(f"bpmf_gram kernel launch failed: {msg} (cuda error {err})")
    global LAUNCHES
    LAUNCHES += 1
    return G, g


@dataclasses.dataclass(frozen=True)
class ChunkOrder:
    """Which chunks each destination row owns, for the fused kernel.

    One segment per row that has a live chunk (``item >= 0`` and
    ``cnt > 0``): ``chunks[start[r] : start[r] + length[r]]`` are the chunk
    ids of row ``item[r]``, ascending, the order in which the JAX kernel's
    grid adds them. Segments run longest first, so the blocks that walk the
    most chunks start earliest. Dead and empty chunks add exact zeros and
    are left out. The layout of a ring step is fixed for the whole run, so
    this is built once per step, beside ``ops.flatten_step``'s output.
    """

    item: torch.Tensor  # [R] int32 destination row, distinct
    start: torch.Tensor  # [R] int32 first position in `chunks`
    length: torch.Tensor  # [R] int32 number of chunks
    chunks: torch.Tensor  # [L] int32 chunk ids, grouped by segment
    lengths: tuple[int, ...]  # host copy of `length`

    @property
    def num_rows(self) -> int:
        return len(self.lengths)


def chunk_order(item: torch.Tensor, cnt: torch.Tensor) -> ChunkOrder:
    """The :class:`ChunkOrder` of a flattened layout (a stable sort by item; reads the device once)."""
    live = torch.nonzero((item >= 0) & (cnt > 0)).flatten()
    rows, perm = torch.sort(item[live].long(), stable=True)
    chunks = live[perm]
    seg_item, length = torch.unique_consecutive(rows, return_counts=True)
    start = torch.cumsum(length, 0) - length
    by_len = torch.sort(length, descending=True, stable=True).indices
    length = length[by_len]
    return ChunkOrder(
        item=seg_item[by_len].int(), start=start[by_len].int(), length=length.int(),
        chunks=chunks.int(), lengths=tuple(length.tolist()),
    )


def bpmf_gram_fused_plain(
    G: torch.Tensor,
    g: torch.Tensor,
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    item: torch.Tensor,
    cnt: torch.Tensor,
    alpha: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    order: ChunkOrder | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused step; updates ``G`` and ``g`` in place and returns them.

    Each live chunk is contracted in float64 as :func:`bpmf_gram_plain`
    does, a row's chunk partials are summed in float64 (its k-th chunks of
    all rows at once, so no index is added twice in one call: the result
    does not depend on the device), rounded to float32 once, and the row
    becomes ``G + alpha * partial`` in float32. The kernel instead rounds
    each chunk's partial and adds it, as the JAX kernel does; the two agree
    to float32 rounding.
    """
    global FUSED_PLAIN_CALLS
    FUSED_PLAIN_CALLS += 1
    order = order if order is not None else chunk_order(item, cnt)
    if order.num_rows == 0:
        return G, g
    K = X.shape[1]
    pc = nbr.shape[1]
    dev = X.device
    pos = torch.arange(pc, device=dev)
    Z = torch.empty(order.chunks.shape[0], K + 1, K + 1, dtype=torch.float64, device=dev)
    step = max(1, (1 << 24) // (pc * (K + 1)))  # ~128 MiB of float64 rows at a time
    for lo in range(0, Z.shape[0], step):
        c = order.chunks[lo : lo + step].long()
        mask = pos[None, :] < cnt[c][:, None]
        Xn = _round(X[nbr[c].long()], compute_dtype).double() * mask[..., None]
        Y = torch.cat([Xn, _round(val[c], compute_dtype).double()[..., None] * mask[..., None]], dim=-1)
        Z[lo : lo + step] = torch.bmm(Y.transpose(1, 2), Y)
    lengths = np.asarray(order.lengths)
    part = torch.zeros(order.num_rows, K + 1, K + 1, dtype=torch.float64, device=dev)
    for k in range(int(lengths[0])):
        n = int(np.count_nonzero(lengths > k))  # segments run longest first
        part[:n] += Z[order.start[:n].long() + k]
    part = part.float()
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    rows = order.item.long()
    G.index_copy_(0, rows, G[rows] + a * part[:, :K, :K])
    g.index_copy_(0, rows, g[rows] + a * part[:, :K, K])
    return G, g


def _check_fused(G, g, X, nbr, val, item, cnt, compute_dtype) -> None:
    cap, K = g.shape
    if G.dtype != torch.float32 or G.shape != (cap, K, K):
        raise ValueError(f"G must be float32 [{cap}, {K}, {K}], got {G.dtype} {tuple(G.shape)}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    if X.dtype != torch.float32 or X.dim() != 2 or X.shape[1] != K:
        raise ValueError(f"X must be float32 [Ns, {K}], got {X.dtype} {tuple(X.shape)}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2:
        raise ValueError(f"nbr must be an int32 [C, pc] tensor, got {nbr.dtype} {tuple(nbr.shape)}")
    if val.dtype != torch.float32 or val.shape != nbr.shape:
        raise ValueError(f"val must be float32 {tuple(nbr.shape)}, got {val.dtype} {tuple(val.shape)}")
    for name, t in (("item", item), ("cnt", cnt)):
        if t.dtype != torch.int32 or t.shape != nbr.shape[:1]:
            raise ValueError(f"{name} must be int32 [{nbr.shape[0]}], got {t.dtype} {tuple(t.shape)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}, got K={K}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    for name, t in (("G", G), ("g", g), ("X", X), ("nbr", nbr), ("val", val), ("item", item), ("cnt", cnt)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bpmf_gram_fused(
    G: torch.Tensor,
    g: torch.Tensor,
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    item: torch.Tensor,
    cnt: torch.Tensor,
    alpha: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    order: ChunkOrder | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ring step's ``G[item[c]] += alpha Xg_c^T Xg_c``, ``g[item[c]] += alpha Xg_c^T v_c``.

    ``G [cap, K, K]`` and ``g [cap, K]`` are updated in place (the JAX
    kernel aliases them) and returned. ``nbr``/``val [C, pc]``, ``item``,
    ``cnt [C]`` are ``ops.flatten_step``'s layout; ``order`` is its
    :func:`chunk_order`, built here when not given. The CUDA kernel on a
    CUDA tensor, the plain version on a CPU one.

    Raises:
        ValueError: Wrong dtypes, shapes, devices, non-contiguous inputs or
            K outside ``[1, 128]`` (CUDA tensors).
        RuntimeError: The kernel failed to build or to launch.
    """
    if X.device.type == "cpu":
        return bpmf_gram_fused_plain(G, g, X, nbr, val, item, cnt, alpha, compute_dtype, order)
    if X.device.type != "cuda":
        raise ValueError(f"bpmf_gram_fused runs on CPU or CUDA tensors, got {X.device}")
    _check_fused(G, g, X, nbr, val, item, cnt, compute_dtype)
    order = order if order is not None else chunk_order(item, cnt)
    if order.num_rows == 0:
        return G, g
    if order.item.device != X.device:
        raise ValueError(f"the chunk order is on {order.item.device}, X on {X.device}")
    lib = _library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.bpmf_gram_fused_launch(
        G.data_ptr(), g.data_ptr(), X.data_ptr(), nbr.data_ptr(), val.data_ptr(), cnt.data_ptr(),
        order.item.data_ptr(), order.start.data_ptr(), order.length.data_ptr(),
        order.chunks.data_ptr(), order.num_rows, nbr.shape[1], X.shape[0], X.shape[1],
        float(alpha), int(compute_dtype == torch.bfloat16), stream,
    )
    if err:
        msg = lib.bpmf_gram_error_string(err).decode()
        raise RuntimeError(f"bpmf_gram_fused kernel launch failed: {msg} (cuda error {err})")
    global FUSED_LAUNCHES
    FUSED_LAUNCHES += 1
    return G, g
