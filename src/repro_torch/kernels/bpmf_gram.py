"""The gather + Gram kernels: CUDA kernels and their plain PyTorch versions.

For a bucket of B items, each with up to P neighbor ids into the opposite
side's factors ``X [Ns, K]``, compute per item::

    G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T        [K, K]
    g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}            [K]

:func:`bpmf_gram` is the port of ``repro/kernels/bpmf_gram.py:124
bpmf_gram_pallas``. :func:`bpmf_gram_fused` is the port of
``bpmf_gram.py:245 bpmf_gram_fused``: one launch per ring step over the
flattened chunk layout of ``ops.flatten_step``, adding ``alpha`` times each
destination row's ``(G, g)`` into its running sums, in place. On a CUDA
tensor each launches its hand-written kernel in ``csrc/bpmf_gram.cu``; on a
CPU tensor each runs its plain version. There is no other route: a CUDA
tensor never falls back to a plain version.

Both kernels are bound by the float32 FMA rate (the fused one, on the
users side of the ring, by the bytes of the running ``(G, g)`` rows). The
source note says how the design answers: a long row is split into pieces
that run on separate blocks, and a second pass adds the pieces in a fixed
order; the products are register-tiled; the gather is asynchronous and
double-buffered. Here the wrapper plans the pieces: :func:`piece_width`
gives the per-bucket kernel's piece of at most ``PIECE_RATINGS`` ratings
(a caller may pass its own, as the autotuner's decisions do), and :func:`chunk_order` cuts each destination row of a fused layout into
runs of at most ``PIECE_RATINGS // pc`` chunks, once per layout. Scratch
for the pieces' partial sums is allocated here with ``torch.empty``.

On a ``meta`` tensor (the dry run, :mod:`repro_torch.launch.dryrun`) each
op is a shape path for analysis: it returns outputs of the right shapes,
launches nothing, computes nothing, and charges its kernel's own work
(:func:`gram_work`, :func:`fused_work`) to the active cost model. A
``meta`` tensor never reaches a kernel, and a CUDA tensor never reaches
the shape path.

``LAUNCHES`` / ``FUSED_LAUNCHES`` count calls of the ops that launch a
kernel (one per bucket, one per ring step and shard), ``REDUCE_LAUNCHES``
/ ``FUSED_REDUCE_LAUNCHES`` their second passes, and ``PLAIN_CALLS`` /
``FUSED_PLAIN_CALLS`` calls of the plain versions, so a run can show
which of them did its work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.build import load_library

LAUNCHES = 0
PLAIN_CALLS = 0
REDUCE_LAUNCHES = 0
FUSED_LAUNCHES = 0
FUSED_PLAIN_CALLS = 0
FUSED_REDUCE_LAUNCHES = 0

# a thread of the kernels' 128 holds up to 5 sub-tiles of 4 x 4 sums:
# ceil((K + 1) / 4) (ceil((K + 1) / 4) + 1) / 2 <= 5 * 128
MAX_K = 128
# Ratings of one piece: a block sums at most this many of one row (fewer
# in a bucket too small to fill the card, see piece_width).
PIECE_RATINGS = 2048
MIN_PIECE_RATINGS = 256  # four 64-row tiles


def gram_work(nnz_total: int, B: int, Ns: int, K: int) -> tuple[float, float]:
    """(bytes, flops) the per-bucket Gram function needs for these inputs (``chip_smoke.py``'s bound).

    Bytes: each rating's neighbor id and value once, ``nnz``, ``X`` once,
    ``G`` and ``g`` written once. Flops: the K (K + 3) / 2 multiply-adds a
    rating adds to the lower triangle of G and to g.
    """
    bytes_ = 8.0 * nnz_total + 4.0 * B + 4.0 * Ns * K + 4.0 * B * (K * K + K)
    return bytes_, float(nnz_total) * K * (K + 3)


def fused_work(ratings: int, chunks: int, num_rows: int, Ns: int, K: int) -> tuple[float, float]:
    """(bytes, flops) one fused launch needs for these inputs (``chip_smoke.py``'s bound).

    Each rating's id and value, ``X`` once, each chunk's item and count,
    and the running ``(G, g)`` row of every live item read and written
    once; K (K + 3) flops per rating.
    """
    bytes_ = 8.0 * ratings + 4.0 * Ns * K + 8.0 * chunks + 2 * 4.0 * (K * K + K) * num_rows
    return bytes_, float(ratings) * K * (K + 3)


def _charge(name: str, work: tuple[float, float]) -> None:
    from repro_torch.launch.op_analysis import charge_kernel

    charge_kernel(name, work[1], work[0])


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
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bpmf_gram_launch.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.bpmf_gram_reduce_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.bpmf_gram_fused_launch.argtypes = [ptr] * 12 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        lib.bpmf_gram_fused_reduce_launch.argtypes = [ptr] * 6 + [i32] * 2 + [ctypes.c_float, ptr]
        for fn in ("bpmf_gram_launch", "bpmf_gram_reduce_launch", "bpmf_gram_fused_launch",
                   "bpmf_gram_fused_reduce_launch"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.bpmf_gram_error_string.argtypes = [ctypes.c_int]
        lib.bpmf_gram_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.bpmf_gram_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda error {err})")


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _entries(K: int) -> int:
    """Floats of one packed partial sum: the lower triangle of G plus g."""
    return K * (K + 3) // 2


def piece_width(B: int, P: int, num_sms: int) -> int:
    """Ratings per piece W of the per-bucket kernel for a ``[B, P]`` bucket.

    ``PIECE_RATINGS``, halved down to ``MIN_PIECE_RATINGS`` while the
    bucket would give fewer than eight pieces per SM, the blocks an SM
    holds at once: a bucket of a few heavy items still spreads over the
    card, and one block's wait for its loads is another's turn to multiply.
    It depends on the shape and the card only, never on the data, so the
    grid needs no host read.
    """
    W = PIECE_RATINGS
    while W > MIN_PIECE_RATINGS and B * -(-P // W) < 8 * num_sms:
        W //= 2
    return W


def bpmf_gram(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    piece: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G [B, K, K], g [B, K])`` in float32: the CUDA kernel, or the plain version on CPU.

    ``piece`` is the kernel's piece width W, the most ratings of one item
    that one block sums (default: :func:`piece_width`); the plain version
    has no pieces.

    Raises:
        ValueError: Wrong dtypes, shapes, devices, non-contiguous inputs,
            K outside ``[1, 128]`` or a piece width below 1 (CUDA tensors).
        RuntimeError: The kernel failed to build or to launch.
    """
    if X.device.type == "cpu":
        return bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    if X.device.type == "meta":  # the dry run's shape path: every slot a rating, the most the shapes allow
        (B, P), (Ns, K) = nbr.shape, X.shape
        _charge("bpmf_gram", gram_work(B * P, B, Ns, K))
        return X.new_empty((B, K, K)), X.new_empty((B, K))
    if X.device.type != "cuda":
        raise ValueError(f"bpmf_gram runs on CPU, CUDA or meta tensors, got {X.device}")
    _check(X, nbr, val, nnz, compute_dtype)
    if piece is not None and piece < 1:
        raise ValueError(f"a piece holds at least one rating, got piece={piece}")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    return _launch_gram(_library(), X, nbr, val, nnz, compute_dtype, _num_sms(X.device), stream, piece)


def bucket_pieces(nnz: np.ndarray, P: int, W: int) -> tuple[np.ndarray, ...]:
    """The per-bucket kernel's pieces that do work: ``(item, lo, hi, direct)`` arrays.

    Block ``(b, q)`` of the grid ``(B, ceil(P / W))`` sums ratings
    ``[q W, min(nnz[b], (q + 1) W))`` of item ``b``; a block with ``q > 0``
    past ``nnz[b]`` does nothing. An item with ``nnz <= W`` is written by its
    piece 0 (``direct``), a longer one by the second pass. The kernel works
    this out itself from ``nnz``; this spells it out on the host, to count a
    bucket's pieces and to test the plan.
    """
    n = np.clip(np.asarray(nnz, np.int64), 0, P)
    count = np.maximum(1, -(-n // W))
    item = np.repeat(np.arange(n.shape[0]), count)
    lo = (np.arange(item.shape[0]) - np.repeat(np.cumsum(count) - count, count)) * W
    return item, lo, np.minimum(n[item], lo + W), n[item] <= W


def _launch_gram(lib, X, nbr, val, nnz, compute_dtype, num_sms: int, stream, piece: int | None = None):
    """Allocate the outputs and scratch and launch the per-bucket kernel (and its second pass).

    ``piece`` is the piece width W; ``None`` takes :func:`piece_width`'s.
    """
    global LAUNCHES, REDUCE_LAUNCHES
    B, P = nbr.shape
    Ns, K = X.shape
    G = torch.empty(B, K, K, dtype=torch.float32, device=X.device)
    g = torch.empty(B, K, dtype=torch.float32, device=X.device)
    if B == 0:
        return G, g
    W = piece or piece_width(B, P, num_sms)
    pieces = max(1, -(-P // W))
    partials = torch.empty(B * pieces * _entries(K) if pieces > 1 else 0, dtype=torch.float32,
                           device=X.device)
    bf16 = int(compute_dtype == torch.bfloat16)
    err = lib.bpmf_gram_launch(
        X.data_ptr(), nbr.data_ptr(), val.data_ptr(), nnz.data_ptr(), G.data_ptr(), g.data_ptr(),
        partials.data_ptr(), B, P, W, pieces, Ns, K, bf16, stream,
    )
    _raise_on(lib, err, "bpmf_gram")
    LAUNCHES += 1
    if pieces > 1:
        err = lib.bpmf_gram_reduce_launch(
            nnz.data_ptr(), partials.data_ptr(), G.data_ptr(), g.data_ptr(), B, P, W, pieces, K, stream,
        )
        _raise_on(lib, err, "bpmf_gram second pass")
        REDUCE_LAUNCHES += 1
    return G, g


@dataclasses.dataclass(frozen=True)
class PiecePlan:
    """How the fused kernel's blocks split the rows of a :class:`ChunkOrder`.

    Each row's ascending chunk list is cut into runs of at most
    ``piece_chunks`` chunks (:func:`chunk_order`); block ``q`` walks
    ``chunks[start[q] : start[q] + length[q]]``, all of row ``item[q]``.
    A row with one piece is updated in place (``slot[q] == -1``). The
    pieces of a longer row write their partial sums to scratch slots
    ``slot[q]``, consecutive and in chunk order; the second pass adds the
    slots ``row_start[r] .. row_start[r] + row_len[r]`` of split row
    ``row_item[r]`` in that order. Pieces run longest first.
    """

    start: torch.Tensor  # [Q] int32 first position in ChunkOrder.chunks
    length: torch.Tensor  # [Q] int32 chunks in the piece, 1..piece_chunks
    item: torch.Tensor  # [Q] int32 destination row
    slot: torch.Tensor  # [Q] int32 scratch slot, -1 = the row's only piece
    row_item: torch.Tensor  # [R2] int32 rows with more than one piece
    row_start: torch.Tensor  # [R2] int32 their first slot
    row_len: torch.Tensor  # [R2] int32 their number of slots
    num_slots: int  # host copy of row_len.sum(): the scratch rows a launch needs

    @property
    def num_pieces(self) -> int:
        return self.start.shape[0]

    @property
    def num_split_rows(self) -> int:
        return self.row_item.shape[0]


@dataclasses.dataclass(frozen=True)
class ChunkOrder:
    """Which chunks each destination row owns, for the fused kernel.

    One segment per row that has a live chunk (``item >= 0`` and
    ``cnt > 0``): ``chunks[start[r] : start[r] + length[r]]`` are the chunk
    ids of row ``item[r]``, ascending, the order in which the JAX kernel's
    grid adds them. Segments run longest first. Dead and empty chunks add
    exact zeros and are left out. ``pieces`` is the kernel's split of the
    segments into blocks. The layout of a ring step is fixed for the whole
    run, so this is built once per step, beside ``ops.flatten_step``'s
    output.
    """

    item: torch.Tensor  # [R] int32 destination row, distinct
    start: torch.Tensor  # [R] int32 first position in `chunks`
    length: torch.Tensor  # [R] int32 number of chunks
    chunks: torch.Tensor  # [L] int32 chunk ids, grouped by segment
    lengths: tuple[int, ...]  # host copy of `length`
    pieces: PiecePlan

    @property
    def num_rows(self) -> int:
        return len(self.lengths)


def _piece_plan(item: np.ndarray, start: np.ndarray, length: np.ndarray, piece_chunks: int,
               device: torch.device) -> PiecePlan:
    """The :class:`PiecePlan` of segments ``(item, start, length)`` (host arrays)."""
    if piece_chunks < 1:
        raise ValueError(f"a piece holds at least one chunk, got piece_chunks={piece_chunks}")
    n_pieces = -(-length // piece_chunks)
    row = np.repeat(np.arange(length.shape[0]), n_pieces)
    first = np.cumsum(n_pieces) - n_pieces  # first piece of each row
    k = np.arange(row.shape[0]) - first[row]
    p_len = np.minimum(piece_chunks, length[row] - k * piece_chunks)
    split = n_pieces[row] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    by_len = np.argsort(-p_len, kind="stable")
    rows = np.nonzero(n_pieces > 1)[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return PiecePlan(
        start=dev((start[row] + k * piece_chunks)[by_len]), length=dev(p_len[by_len]),
        item=dev(item[row][by_len]), slot=dev(slot[by_len]),
        row_item=dev(item[rows]), row_start=dev(slot[first[rows]]), row_len=dev(n_pieces[rows]),
        num_slots=int(n_pieces[rows].sum()),
    )


def chunk_order(item: torch.Tensor, cnt: torch.Tensor, piece_chunks: int = 16) -> ChunkOrder:
    """The :class:`ChunkOrder` of a flattened layout, with pieces of at most ``piece_chunks`` chunks.

    A stable sort by item on the layout's device; the piece plan is built
    on the host from one copy of the segments.
    """
    live = torch.nonzero((item >= 0) & (cnt > 0)).flatten()
    rows, perm = torch.sort(item[live].long(), stable=True)
    chunks = live[perm]
    seg_item, length = torch.unique_consecutive(rows, return_counts=True)
    start = torch.cumsum(length, 0) - length
    by_len = torch.sort(length, descending=True, stable=True).indices
    seg_item, start, length = seg_item[by_len].int(), start[by_len].int(), length[by_len].int()
    host = [t.cpu().numpy().astype(np.int64) for t in (seg_item, start, length)]
    return ChunkOrder(
        item=seg_item, start=start, length=length, chunks=chunks.int(),
        lengths=tuple(host[2].tolist()), pieces=_piece_plan(*host, piece_chunks, item.device),
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
    becomes ``G + alpha * partial`` in float32. The kernel sums a row's
    chunks in float32 and adds ``alpha * partial`` once; the JAX kernel adds
    each chunk's partial. All agree to float32 rounding.
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
    a = float(alpha)  # multiplied in float32, as a float32 tensor would be
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
    if X.device.type == "meta":  # the dry run's shape path: every slot a rating, every chunk its own row
        (C, pc), (Ns, K) = nbr.shape, X.shape
        _charge("bpmf_gram_fused", fused_work(C * pc, C, min(C, G.shape[0]), Ns, K))
        return G, g
    if X.device.type != "cuda":
        raise ValueError(f"bpmf_gram_fused runs on CPU, CUDA or meta tensors, got {X.device}")
    _check_fused(G, g, X, nbr, val, item, cnt, compute_dtype)
    order = order if order is not None else chunk_order(item, cnt)
    if order.num_rows == 0:
        return G, g
    if order.item.device != X.device:
        raise ValueError(f"the chunk order is on {order.item.device}, X on {X.device}")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    return _launch_fused(_library(), G, g, X, nbr, val, cnt, alpha, compute_dtype, order, stream)


def _launch_fused(lib, G, g, X, nbr, val, cnt, alpha, compute_dtype, order: ChunkOrder, stream):
    """Allocate the scratch and launch the fused kernel over the order's pieces (and its second pass)."""
    global FUSED_LAUNCHES, FUSED_REDUCE_LAUNCHES
    plan = order.pieces
    K = X.shape[1]
    partials = torch.empty(plan.num_slots * _entries(K), dtype=torch.float32, device=X.device)
    err = lib.bpmf_gram_fused_launch(
        G.data_ptr(), g.data_ptr(), X.data_ptr(), nbr.data_ptr(), val.data_ptr(), cnt.data_ptr(),
        order.chunks.data_ptr(), plan.start.data_ptr(), plan.length.data_ptr(), plan.item.data_ptr(),
        plan.slot.data_ptr(), partials.data_ptr(), plan.num_pieces, nbr.shape[1], X.shape[0], K,
        float(alpha), int(compute_dtype == torch.bfloat16), stream,
    )
    _raise_on(lib, err, "bpmf_gram_fused")
    FUSED_LAUNCHES += 1
    if plan.num_split_rows:
        err = lib.bpmf_gram_fused_reduce_launch(
            G.data_ptr(), g.data_ptr(), partials.data_ptr(), plan.row_item.data_ptr(),
            plan.row_start.data_ptr(), plan.row_len.data_ptr(), plan.num_split_rows, K, float(alpha),
            stream,
        )
        _raise_on(lib, err, "bpmf_gram_fused second pass")
        FUSED_REDUCE_LAUNCHES += 1
    return G, g
