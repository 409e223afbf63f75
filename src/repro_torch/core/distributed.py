"""Distributed BPMF Gibbs sampling (paper §IV) over a ring of S shards.

The paper distributes U and V across MPI ranks, balances work with a
cost-model-driven reorder of R, and overlaps communication with computation
using buffered MPI_Isend/Irecv. The JAX package runs that as one
``shard_map`` program over S devices, which may belong to several
processes. This port runs the same per-shard program:

  * ranks            -> an ordered list of S shard devices (:class:`Ring`).
                        In one process shard d sits on card ``d % n`` of
                        the n visible cards, or on the CPU. Across P
                        ``torch.distributed`` processes, process p owns
                        shards ``local_shard_range(S, p, P)``, all on its
                        own device. Each shard's factor block, buckets and
                        ``(G, g)`` sums live on its device, and every step
                        of the per-shard program runs for each local shard
                        in turn
  * R reordering     -> ``balance.partition_items`` relabeling; shard s owns
                        the relabeled id range [s*cap, (s+1)*cap)
  * Isend/Irecv +    -> ``comm_mode="ring"``: :meth:`Ring.rotate` hands each
    send buffers        shard's opposite-side block to the next shard; the
                        rotation for step t+1 is issued before step t's
                        Gram, as the JAX package issues its ``ppermute``
  * deep pipelining  -> ``comm_mode="ring_async"``: the same rotation with
    (1705.10633)        ``pipeline_depth`` rotations in flight in a queue
  * synchronous      -> ``comm_mode="allgather"``: every shard's device
    baseline            concatenates all opposite blocks, then updates

Shards that share a device hand their buffers over without a copy, so S
shards on one card run the whole ring schedule on that card. Between two
cards of one process a rotation is a ``tensor.to(next_device,
non_blocking=True)`` on a side stream of each card, and the compute stream
waits on an event before it reads the buffer. Between two processes each
rank sends its last local shard's block to the next rank and receives the
previous rank's in one ``torch.distributed.batch_isend_irecv``; under
``gloo`` a CUDA block is staged through pinned host memory (copied to the
host once per half-sweep, received into the host, copied to the card on a
side stream behind an event). The hyper-parameter statistics, the test
predictions' factor rows and the allgather mode's blocks cross processes by
``all_gather``, and every rank then computes the same replicated values.

Correctness contract (DESIGN.md §1, §14): for identical (key, data), every
comm_mode, every shard count and every split of the S shards over
processes draws the same posterior samples as the sequential sampler, up to
float reduction order, and the process split changes no bit. Per-item noise
is keyed by original item id (``posterior.item_noise``) and the
hyper-parameter statistics are summed over shards in global shard order
(:func:`_psum_ordered`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.checkpoint.checkpoint import ShardedHostLeaf, _shard_ranges
from repro_torch.core import posterior, prng
from repro_torch.core.balance import CostModel, Partition, partition_items
from repro_torch.core.gibbs import SweepMetrics, init_rows, metrics_row, sweep_keys
from repro_torch.core.hyper import hyper_ok, hyper_sufficient_stats, sample_hyper_from_stats
from repro_torch.core.prediction import (
    PredictionState,
    accumulate_predictions,
    update_posterior_accum,
)
from repro_torch.core.types import (
    BPMFConfig,
    Bucket,
    HyperParams,
    NormalWishartPrior,
    PosteriorAccum,
    counter,
)
from repro_torch.data.sparse import (
    ChunkedRatings,
    RatingsCOO,
    StableMeanAccumulator,
    csr_from_coo,
    stable_mean,
    train_test_split,
)
from repro_torch.kernels import ops
from repro_torch.launch.hostdevices import process_count, process_index


# --------------------------------------------------------------------------
# Containers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingSide:
    """Neighbor lists for updating one side, laid out for the ring schedule.

    ``steps[t][i]`` holds the buckets of local shard i (global shard
    ``d = shard_offset + i``) for ring step t: the contributions to each of
    its items' Gram terms from opposite-side items owned by shard
    ``(d - t) mod S``, which is the block in shard d's buffer at step t.
    Neighbor indices are local to that source shard. Bucket shapes at a
    step agree across all S shards, as in the JAX package, whose
    ``[S * B, ...]`` arrays are these blocks stacked. A process of a
    multi-process ring holds its own shards only (``shard_offset`` is its
    first); a single process holds all S.

    ``Bucket.item_ids`` are local rows of the shard's ``[cap, K]`` block
    (-1 = padding); ``orig_ids[i]`` gives each row's original item id
    (-1 = padding slot), which keys the per-item noise.

    ``plans[t][i]`` is the step's Gram dispatch (``ops.StepPlan``: the
    fused kernel's flattened layout, or one decision per bucket; ``None``
    where the step has no buckets), decided and built once on the shard's
    device by :func:`place_data`; empty when the data was placed without a
    config, and then each step is planned at its call.
    """

    steps: tuple[tuple[tuple[Bucket, ...], ...], ...]
    orig_ids: tuple[torch.Tensor, ...]  # per local shard [cap] int32
    cap: int = 0
    num_items: int = 0
    plans: tuple[tuple[ops.StepPlan | None, ...], ...] = dataclasses.field(
        default=(), metadata={"port_only": True})
    shard_offset: int = 0

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def fused(self) -> tuple[tuple[ops.FusedStep | None, ...], ...]:
        """``fused[t][i]``: the fused layout of each planned step (``None`` where not fused); empty when none is."""
        layouts = tuple(tuple(p.layout if p is not None else None for p in per_step) for per_step in self.plans)
        return layouts if any(f is not None for per_step in layouts for f in per_step) else ()

    @property
    def num_shards(self) -> int:
        """Shards held here (all S in one process, this process's own in a multi-process ring)."""
        return len(self.orig_ids)


@dataclasses.dataclass(frozen=True)
class DistTestSet:
    """Held-out triples in relabeled coordinates, on the ring's first device."""

    rows: torch.Tensor  # [T] int32 relabeled user slot (shard*cap_u + row)
    cols: torch.Tensor  # [T] int32 relabeled movie slot
    vals: torch.Tensor  # [T] f32


@dataclasses.dataclass(frozen=True)
class DistBPMFData:
    """Everything the distributed sweep needs besides the factor shards."""

    users: RingSide  # for updating U (neighbors: movies)
    movies: RingSide  # for updating V (neighbors: users)
    test: DistTestSet
    mean_rating: torch.Tensor
    num_shards: int = 1
    min_rating: float = float("-inf")
    max_rating: float = float("inf")

    def fused_launches_per_sweep(self) -> int:
        """Fused-kernel launches one sweep makes: the (side, step, shard) fused layouts with a live row."""
        return sum(
            1 for side in (self.users, self.movies)
            for per_step in side.fused for f in per_step
            if f is not None and f.num_rows > 0
        )

    def step_plans(self) -> list[tuple[str, int, int, ops.StepPlan]]:
        """``(side name, step, local shard, plan)`` of every planned ring step, users side first."""
        return [(name, t, i, p) for name, side in (("users", self.users), ("movies", self.movies))
                for t, per_step in enumerate(side.plans) for i, p in enumerate(per_step) if p is not None]


@dataclasses.dataclass(frozen=True)
class DistState:
    """Sharded Gibbs state: ``U[d]`` is shard d's ``[cap_u, K]`` block, ``V[d]`` its ``[cap_v, K]``."""

    U: tuple[torch.Tensor, ...]
    V: tuple[torch.Tensor, ...]
    hyper_U: HyperParams
    hyper_V: HyperParams
    sweep: torch.Tensor  # 0-dim int32 on the ring's home device


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Host-side record of how the problem was partitioned.

    ``local_shards`` / ``local_nnz`` / ``total_nnz`` are set by the per-host
    builder (:func:`build_distributed_data_per_host`): which ring shards
    this process materialized and how many training ratings it kept against
    the global count (``local_nnz < total_nnz`` on every process of a
    multi-process run).
    """

    part_users: Partition
    part_movies: Partition
    num_shards: int
    strategy: str
    local_shards: tuple[int, ...] | None = None
    local_nnz: int = 0
    total_nnz: int = 0


@dataclasses.dataclass(frozen=True)
class LocalShardedArray:
    """One process's row block of a ring-sharded global array: the only part it holds.

    ``shape``/``dtype`` describe the global ``[global_rows, ...]`` array;
    ``block`` holds its rows ``[row_offset, row_offset + block.shape[0])``.
    :func:`fetch_global` gathers the blocks of every process (a
    collective); :meth:`host_leaf` is this process's share of a checkpoint
    leaf, written as a per-shard file.
    """

    block: torch.Tensor
    global_rows: int
    row_offset: int

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.global_rows,) + tuple(self.block.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    def host_leaf(self) -> ShardedHostLeaf:
        """This process's rows as a :class:`~repro_torch.checkpoint.ShardedHostLeaf` (a host copy)."""
        index = (slice(self.row_offset, self.row_offset + self.block.shape[0]),) + (slice(None),) * (
            self.block.dim() - 1)
        host = self.block.detach().to("cpu", copy=True).numpy()
        return ShardedHostLeaf(
            global_shape=self.shape, dtype=str(host.dtype),
            shards=((_shard_ranges(self.shape, index), host),),
        )


# --------------------------------------------------------------------------
# The ring of shard devices
# --------------------------------------------------------------------------


class _Pending:
    """Sends and receives between processes in flight. :meth:`wait` waits for them once
    (waiting twice on a finished ``gloo`` work blocks)."""

    def __init__(self, works):
        self._works = list(works)

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works.clear()


class InFlight(NamedTuple):
    """A shard's buffer on its way: the tensor, and what :meth:`Ring.take` must wait for.

    ``event``: the buffer's arrival on its device (``None``: in place).
    ``host``: a pinned host copy of the buffer, made for sending it to
    another process under ``gloo``. ``pending``: the send and receive
    between processes that bring it. A buffer received through the host
    has no ``tensor`` yet: ``take`` copies ``host`` to ``device``.
    """

    tensor: torch.Tensor | None
    event: torch.cuda.Event | None = None
    host: torch.Tensor | None = None
    pending: _Pending | None = None
    device: torch.device | None = None


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _stages_through_host(device: torch.device) -> bool:
    """Whether a tensor on ``device`` crosses processes through host memory (``gloo`` cannot move CUDA tensors)."""
    return device.type == "cuda" and torch.distributed.get_backend() == "gloo"


def _host_copies(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Pinned host copies of ``xs``, complete on return: each copy follows the work queued before it on its stream."""
    hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
    for h, x in zip(hosts, xs):
        h.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(xs[0].device))
    done.synchronize()
    return hosts


def all_gather_blocks(x: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``x`` (one shape on all), in rank order, on ``x``'s device. A collective.

    Under ``gloo`` a CUDA tensor goes through pinned host memory, and the
    gathered blocks come back to the card with non-blocking copies on the
    current stream.
    """
    if process_count() == 1:
        return [x]
    staged = _stages_through_host(x.device)
    send = _host_copies([x])[0] if staged else x.contiguous()
    outs = [torch.empty(send.shape, dtype=send.dtype, device=send.device, pin_memory=staged)
            for _ in range(process_count())]
    torch.distributed.all_gather(outs, send)
    return [o.to(x.device, non_blocking=True) for o in outs] if staged else outs


class Ring:
    """The S shard devices of a ring, and the rotation of buffers around it.

    Args:
        devices: The devices of the shards this process holds, in shard
            order (all S in a single-process ring).
        num_shards: The ring's S; ``None`` means ``len(devices)``. Larger
            means the ring spans ``S / len(devices)`` processes, one per
            rank of the ``torch.distributed`` job, and this process holds
            shards ``[shard_offset, shard_offset + len(devices))``.
        shard_offset: This process's first shard.
        abstract: The dry run's ring of rank ``shard_offset`` (devices
            ``["meta"]``, one shard a rank), with no processes behind it:
            a hand-over returns a ``meta`` buffer of the sent shape and a
            gather ``meta`` blocks, each recorded with the active
            ``launch.op_analysis.OpCostModel`` (a collective-permute, an
            all-gather over the ring) and counted in
            ``rotation_bytes_sent`` / ``gather_bytes_sent``; nothing moves.

    ``host_bytes`` and ``host_seconds`` count what crossed processes
    through host memory under ``gloo``: the bytes copied to and from the
    card, and the host's wall time in those copies and in the waits for
    ``gloo`` (reset them to measure a window), summed from the host spans
    ``ring.stage``, ``ring.wait``, ``ring.upload``, ``ring.all_gather``
    and ``ring.exchange`` (:mod:`repro_torch.trace`). ``rotation_bytes_sent``
    and ``gather_bytes_sent`` count the bytes this process sent to other
    processes, by hand-overs of :meth:`rotate` and by :meth:`all_gather`
    (its block once to each other rank), on any device.
    """

    def __init__(self, devices: Sequence[torch.device | str], num_shards: int | None = None,
                 shard_offset: int = 0, abstract: bool = False):
        if not devices:
            raise ValueError("a ring needs at least one shard device")
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        L = len(self.devices)
        self.num_shards = L if num_shards is None else int(num_shards)
        self.shard_offset = int(shard_offset)
        if self.num_shards % L or self.shard_offset % L or self.shard_offset + L > self.num_shards:
            raise ValueError(f"{L} local shards from shard {shard_offset} do not tile a ring of {self.num_shards}")
        self.num_processes = self.num_shards // L
        self.rank = self.shard_offset // L
        self.abstract = abstract
        if abstract and self.devices != (torch.device("meta"),):
            raise ValueError(f"an abstract ring holds one meta shard, got {self.devices}")
        if not abstract and self.num_processes > 1 and (process_count(), process_index()) != (
                self.num_processes, self.rank):
            raise RuntimeError(
                f"a ring over {self.num_processes} processes needs rank {self.rank} of a "
                f"{self.num_processes}-process job (init_multiprocess); this is rank "
                f"{process_index()} of {process_count()}"
            )
        self._side_streams: dict[torch.device, torch.cuda.Stream] = {}
        self._tag = 0
        self.host_bytes = 0
        self.host_seconds = 0.0
        self.rotation_bytes_sent = 0
        self.gather_bytes_sent = 0

    def _record(self, op: str, x: torch.Tensor) -> None:
        from repro_torch.launch.op_analysis import record_collective

        record_collective(op, x.nbytes, ("ring",), self.num_shards, range(self.num_shards))

    @property
    def spans_processes(self) -> bool:
        """Whether the ring's shards belong to more than one process."""
        return self.num_processes > 1

    @property
    def local_shards(self) -> range:
        """The global ids of the shards this process holds."""
        return range(self.shard_offset, self.shard_offset + len(self.devices))

    @property
    def home(self) -> torch.device:
        """The first local shard's device: hyper-parameters, test predictions and metrics live here."""
        return self.devices[0]

    def distinct_devices(self) -> list[torch.device]:
        """The local shards' devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def shards_per_device(self) -> dict[str, int]:
        """How many local shards share each device."""
        out: dict[str, int] = {}
        for dev in self.devices:
            out[str(dev)] = out.get(str(dev), 0) + 1
        return out

    def _staged(self) -> bool:
        return self.spans_processes and not self.abstract and _stages_through_host(self.home)

    def stage(self, bufs: Sequence[InFlight]) -> list[InFlight]:
        """The buffers with pinned host copies attached, when they will cross processes through the host.

        One device-to-host copy of every local block at the start of a
        half-sweep (a single wait for the card), so that no later send has
        to wait for the Gram kernels queued after it. Otherwise the
        buffers as they are.
        """
        if not self._staged():
            return list(bufs)
        with trace.span("ring.stage") as stage:
            hosts = _host_copies([self.take(b) for b in bufs])
            self.host_bytes += sum(h.nbytes for h in hosts)
        self.host_seconds += stage.seconds
        return [b._replace(host=h) for b, h in zip(bufs, hosts)]

    def rotate(self, bufs: Sequence[InFlight]) -> list[InFlight]:
        """One ring hop (``lax.ppermute`` with perm ``i -> i + 1``): shard d receives shard d-1's buffer.

        A buffer whose next shard shares its device is handed over as it
        is. Between cards of this process the copy is issued on side
        streams of both cards and returns at once. Across processes this
        rank's last local shard's buffer goes to the next rank, and the
        previous rank's arrives for the first local shard, in one
        ``batch_isend_irecv`` that returns at once. :meth:`take` makes the
        reader wait for either.
        """
        L = len(bufs)
        out = []
        for i in range(L):
            if i == 0 and self.spans_processes:
                out.append(self._exchange(bufs[L - 1]))
                continue
            buf = bufs[(i - 1) % L]
            dst = self.devices[i]
            here = buf.device if buf.tensor is None else buf.tensor.device
            out.append(buf if here == dst else self._send(buf, dst))
        return out

    def take(self, buf: InFlight) -> torch.Tensor:
        """The buffer's tensor, once the current stream of its device has waited for its arrival."""
        if buf.pending is not None:
            with trace.span("ring.wait") as wait:
                buf.pending.wait()
            self.host_seconds += wait.seconds
        if buf.tensor is None:  # received into the host: to the card on a side stream, behind an event
            with trace.span("ring.upload") as upload:
                side = self._side_stream(buf.device)
                with torch.cuda.stream(side):
                    tensor = buf.host.to(buf.device, non_blocking=True)
                arrived = torch.cuda.Event()
                arrived.record(side)
                buf = InFlight(tensor, arrived)
                self.host_bytes += tensor.nbytes
            self.host_seconds += upload.seconds
        if buf.event is None:
            return buf.tensor
        stream = torch.cuda.current_stream(buf.tensor.device)
        stream.wait_event(buf.event)
        buf.tensor.record_stream(stream)
        return buf.tensor

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every process's ``x``, in rank order (so in shard order), on ``x``'s device: :func:`all_gather_blocks`, counted."""
        if not self.spans_processes:
            return [x]
        with trace.span("ring.all_gather") as gather:
            if self.abstract:
                self._record("all-gather", x)
                out = [torch.empty_like(x) for _ in range(self.num_processes)]
            else:
                out = all_gather_blocks(x)
            self.gather_bytes_sent += x.nbytes * (self.num_processes - 1)
            if _stages_through_host(x.device):
                self.host_bytes += x.nbytes * (1 + self.num_processes)
        self.host_seconds += gather.seconds
        return out

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device)
        return self._side_streams[device]

    def _send(self, buf: InFlight, dst: torch.device) -> InFlight:
        src = buf.tensor
        s_src, s_dst = self._side_stream(src.device), self._side_stream(dst)
        if buf.event is not None:
            s_src.wait_event(buf.event)
        else:
            s_src.wait_stream(torch.cuda.current_stream(src.device))
        # a copy between cards runs on the current streams of both: make
        # those the side streams, so the compute streams go on meanwhile
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            out = src.to(dst, non_blocking=True)
        src.record_stream(s_src)
        arrived = torch.cuda.Event()
        arrived.record(s_dst)
        return InFlight(out, arrived)

    def _exchange(self, buf: InFlight) -> InFlight:
        """Send ``buf`` to the next rank and post the receive of the previous rank's buffer."""
        with trace.span("ring.exchange") as exchange:
            nxt = (self.rank + 1) % self.num_processes
            prv = (self.rank - 1) % self.num_processes
            self._tag += 1  # every rank rotates in the same order: the tags pair the messages
            if self._staged():
                if buf.pending is not None:  # a block received earlier, forwarded from the host as it came
                    buf.pending.wait()
                if buf.host is None:
                    buf = self.stage([buf])[0]
                send = buf.host
                recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
            else:
                send = self.take(buf)
                recv = torch.empty_like(send)
            self.rotation_bytes_sent += send.nbytes
            if self.abstract:
                self._record("collective-permute", send)
                return InFlight(recv)
            works = torch.distributed.batch_isend_irecv([
                torch.distributed.P2POp(torch.distributed.isend, send, nxt, tag=self._tag),
                torch.distributed.P2POp(torch.distributed.irecv, recv, prv, tag=self._tag),
            ])
        self.host_seconds += exchange.seconds
        if self._staged():
            return InFlight(None, host=recv, pending=_Pending(works), device=self.devices[0])
        return InFlight(recv, pending=_Pending(works))


def _per_shard(x, ring: Ring) -> list:
    """``x`` (a tensor or a container with ``.to``) on every local shard's device, one copy per device."""
    copies = {dev: x.to(dev) for dev in ring.distinct_devices()}
    return [copies[dev] for dev in ring.devices]


# --------------------------------------------------------------------------
# Host-side data distribution (paper §IV-B)
# --------------------------------------------------------------------------


def _neighbor_shard_counts(
    indptr: np.ndarray, indices: np.ndarray, part_opp: Partition, num_shards: int
) -> np.ndarray:
    """``[num_items, S]`` count of each item's neighbors per owning opposite shard."""
    nnz_all = (indptr[1:] - indptr[:-1]).astype(np.int64)
    row_of = np.repeat(np.arange(len(nnz_all), dtype=np.int64), nnz_all)
    src = part_opp.perm[indices] // part_opp.cap
    flat = np.bincount(row_of * num_shards + src, minlength=len(nnz_all) * num_shards)
    return flat.reshape(len(nnz_all), num_shards).astype(np.int32)


def _pad_class_of(counts: np.ndarray, pads_sorted: Sequence[int]) -> np.ndarray:
    """Vectorized pad class: smallest configured pad >= n, else next power of two."""
    pads_arr = np.asarray(pads_sorted, dtype=np.int64)
    idx = np.searchsorted(pads_arr, counts, side="left")
    out = pads_arr[np.minimum(idx, len(pads_arr) - 1)].copy()
    for i in np.nonzero(idx >= len(pads_arr))[0]:
        p = int(pads_arr[-1])
        while p < counts[i]:
            p *= 2
        out[i] = p
    return out


def _ring_side_buckets(
    indptr: np.ndarray,
    indices: np.ndarray,  # already relabeled opposite-side ids
    values: np.ndarray,
    part_self: Partition,
    part_opp: Partition,
    num_shards: int,
    pads: Sequence[int],
    bucket_multiple: int = 8,
    *,
    shard_counts: np.ndarray | None = None,
    local_shards: Sequence[int] | None = None,
) -> RingSide:
    """Build the per-step bucketed neighbor lists for one side (CPU tensors).

    For item i (owned by shard d at local row r) and ring step t, collect the
    neighbors j with shard(j) == (d - t) mod S, and store their local
    opposite indices. Bucket shapes are agreed over all shards (max per step
    and pad class). Slots fill in ascending original id and neighbors in
    CSR order: the layout of ``repro.core.distributed._ring_side_buckets``,
    element for element.

    Per-host mode: with ``local_shards`` (a contiguous ascending subset) the
    bucket *shapes* still come from all S shards, through ``shard_counts``
    (the ``[num_items, S]`` neighbor counts per source shard that every
    process derives from the same partition), but only the local shards'
    buckets are built. The CSR then needs only the rows of locally owned
    items, and each local shard's buckets equal that shard's in a full
    build.
    """
    S = num_shards
    cap = part_self.cap
    cap_opp = part_opp.cap
    num_items = len(indptr) - 1
    local = tuple(range(S)) if local_shards is None else tuple(int(d) for d in local_shards)
    if not local or list(local) != list(range(local[0], local[-1] + 1)):
        raise ValueError(f"local_shards must be contiguous ascending, got {local}")
    L = len(local)
    if shard_counts is None:
        shard_counts = _neighbor_shard_counts(indptr, indices, part_opp, S)

    pads_sorted = sorted(pads)
    d_of = (part_self.perm // cap).astype(np.int64)  # owning shard per item
    item_ids_all = np.arange(num_items, dtype=np.int64)

    steps = []
    for t in range(S):
        src_t = (d_of - t) % S
        cnt_t = shard_counts[item_ids_all, src_t].astype(np.int64)
        present = (cnt_t > 0) | (t == 0)  # t == 0 rows always present
        pc_t = _pad_class_of(cnt_t, pads_sorted)
        per_shard: list[list[Bucket]] = [[] for _ in range(L)]
        for pc in sorted(int(p) for p in np.unique(pc_t[present])):
            in_class = present & (pc_t == pc)
            per_dev = np.bincount(d_of[in_class], minlength=S)
            B = -(-int(per_dev.max()) // bucket_multiple) * bucket_multiple
            item_ids = np.full((L, B), -1, dtype=np.int32)
            nbr = np.zeros((L, B, pc), dtype=np.int32)
            val = np.zeros((L, B, pc), dtype=np.float32)
            nnz = np.zeros((L, B), dtype=np.int32)
            for li, d in enumerate(local):
                # ascending original id, as in the JAX package
                for slot, old_id in enumerate(np.nonzero(in_class & (d_of == d))[0]):
                    r = int(part_self.perm[old_id]) % cap
                    lo, hi = indptr[old_id], indptr[old_id + 1]
                    nbr_new = part_opp.perm[indices[lo:hi]]
                    sel = (nbr_new // cap_opp) == ((d - t) % S)
                    nb = (nbr_new % cap_opp)[sel]
                    item_ids[li, slot] = r
                    nnz[li, slot] = len(nb)
                    nbr[li, slot, : len(nb)] = nb
                    val[li, slot, : len(nb)] = values[lo:hi][sel]
            for li in range(L):
                per_shard[li].append(Bucket(
                    item_ids=torch.from_numpy(item_ids[li]),
                    nbr=torch.from_numpy(nbr[li]),
                    val=torch.from_numpy(val[li]),
                    nnz=torch.from_numpy(nnz[li]),
                ))
        steps.append(tuple(tuple(b) for b in per_shard))

    orig = np.asarray(part_self.inv_perm, dtype=np.int32)  # [S*cap], -1 pads
    return RingSide(
        steps=tuple(steps),
        orig_ids=tuple(torch.from_numpy(orig[d * cap : (d + 1) * cap].copy()) for d in local),
        cap=cap,
        num_items=num_items,
        shard_offset=local[0],
    )


def build_distributed_data(
    coo: RatingsCOO,
    num_shards: int,
    pads: Sequence[int] = (8, 32, 128, 512, 2048),
    test_fraction: float = 0.1,
    seed: int = 0,
    strategy: str = "lpt",
    cost_model: CostModel | None = None,
    min_rating: float | None = None,
    max_rating: float | None = None,
) -> tuple[DistBPMFData, DistPlan]:
    """Full host-side distribution pipeline (paper §IV-B), as CPU tensors.

    Splits train/test, computes the cost-balanced partition of both sides,
    relabels R accordingly and builds the per-ring-step neighbor lists.
    Centers on :func:`~repro_torch.data.sparse.stable_mean`, as the JAX
    package's ``build_distributed_data`` does. :func:`place_data` moves the
    result to a ring.
    """
    train, test = train_test_split(coo, test_fraction, seed)
    mean = stable_mean(train.vals) if train.nnz else 0.0
    centered = train.vals - np.float32(mean)

    u_indptr, u_idx, u_val = csr_from_coo(train.rows, train.cols, centered, coo.num_users)
    m_indptr, m_idx, m_val = csr_from_coo(train.cols, train.rows, centered, coo.num_movies)

    cm = cost_model or CostModel()
    part_u = partition_items(
        (u_indptr[1:] - u_indptr[:-1]).astype(np.int64), num_shards, cm, strategy
    )
    part_m = partition_items(
        (m_indptr[1:] - m_indptr[:-1]).astype(np.int64), num_shards, cm, strategy
    )

    users = _ring_side_buckets(u_indptr, u_idx, u_val, part_u, part_m, num_shards, pads)
    movies = _ring_side_buckets(m_indptr, m_idx, m_val, part_m, part_u, num_shards, pads)

    lo = float(coo.vals.min()) if min_rating is None else min_rating
    hi = float(coo.vals.max()) if max_rating is None else max_rating
    data = DistBPMFData(
        users=users,
        movies=movies,
        test=DistTestSet(
            rows=torch.from_numpy(part_u.perm[test.rows].astype(np.int32)),
            cols=torch.from_numpy(part_m.perm[test.cols].astype(np.int32)),
            vals=torch.from_numpy(np.asarray(test.vals, np.float32)),
        ),
        mean_rating=torch.tensor(mean, dtype=torch.float32),
        num_shards=num_shards,
        min_rating=lo,
        max_rating=hi,
    )
    return data, DistPlan(part_u, part_m, num_shards, strategy)


def local_shard_range(num_shards: int, process_index: int, num_processes: int) -> range:
    """The contiguous ring shards owned by one process: ``[p*S/P, (p+1)*S/P)``.

    Raises:
        ValueError: ``num_shards`` is not a multiple of ``num_processes``.
    """
    if num_shards % num_processes:
        raise ValueError(f"num_shards={num_shards} must be divisible by num_processes={num_processes}")
    per = num_shards // num_processes
    return range(process_index * per, (process_index + 1) * per)


def build_distributed_data_per_host(
    ratings: ChunkedRatings,
    num_shards: int,
    local_shards: Sequence[int],
    pads: Sequence[int] = (8, 32, 128, 512, 2048),
    test_fraction: float = 0.1,
    seed: int = 0,
    strategy: str = "lpt",
    cost_model: CostModel | None = None,
    min_rating: float | None = None,
    max_rating: float | None = None,
) -> tuple[DistBPMFData, DistPlan]:
    """Per-host distribution pipeline: the global plan, the local shards only.

    Every process streams the same rating chunks twice and computes the
    same global state: the train/test split (the seeded draws consumed in
    chunk order, which equals the one-shot draw), per-item rating counts,
    the cost-balanced partitions, the centering mean (the
    chunking-invariant accumulator) and the bucket shape plan. It keeps
    only the training ratings that touch one of its ``local_shards`` and
    builds only those shards' buckets; no process holds the whole training
    array (the guard below raises if the filter keeps everything). The
    held-out triples stay whole on every process.

    With ``local_shards`` covering every shard this equals
    :func:`build_distributed_data` on the materialized stream, bit for bit.

    Raises:
        ValueError: A chunk larger than ``ratings.chunk_rows``.
        RuntimeError: A process owning part of the shards kept every
            training rating.
    """
    S = num_shards
    local = tuple(int(d) for d in local_shards)
    U, M = ratings.num_users, ratings.num_movies

    # -- pass 1: split, per-item train counts, mean, test triples
    rng = np.random.default_rng(seed)
    u_nnz = np.zeros(U, dtype=np.int64)
    m_nnz = np.zeros(M, dtype=np.int64)
    mean_acc = StableMeanAccumulator()
    test_rows, test_cols, test_vals = [], [], []
    vmin, vmax = np.inf, -np.inf
    total_train = 0
    for chunk in ratings.chunks():
        if chunk.nnz > ratings.chunk_rows:
            raise ValueError(f"chunk of {chunk.nnz} ratings exceeds chunk_rows={ratings.chunk_rows}")
        t = rng.random(chunk.nnz) < test_fraction
        tr = ~t
        u_nnz += np.bincount(chunk.rows[tr], minlength=U)
        m_nnz += np.bincount(chunk.cols[tr], minlength=M)
        mean_acc.add(chunk.vals[tr])
        test_rows.append(chunk.rows[t])
        test_cols.append(chunk.cols[t])
        test_vals.append(chunk.vals[t])
        if chunk.nnz:
            vmin = min(vmin, float(chunk.vals.min()))
            vmax = max(vmax, float(chunk.vals.max()))
        total_train += int(tr.sum())
    mean = mean_acc.mean()

    cm = cost_model or CostModel()
    part_u = partition_items(u_nnz, S, cm, strategy)
    part_m = partition_items(m_nnz, S, cm, strategy)
    shard_of_u = (part_u.perm // part_u.cap).astype(np.int64)
    shard_of_m = (part_m.perm // part_m.cap).astype(np.int64)
    local_u = np.isin(shard_of_u, local)
    local_m = np.isin(shard_of_m, local)

    # -- pass 2: neighbor counts per source shard (global), local ratings kept
    rng2 = np.random.default_rng(seed)
    cnt_u = np.zeros(U * S, dtype=np.int64)
    cnt_m = np.zeros(M * S, dtype=np.int64)
    keep_r, keep_c, keep_v = [], [], []
    for chunk in ratings.chunks():
        tr = ~(rng2.random(chunk.nnz) < test_fraction)
        r, c, v = chunk.rows[tr], chunk.cols[tr], chunk.vals[tr]
        cnt_u += np.bincount(r.astype(np.int64) * S + shard_of_m[c], minlength=U * S)
        cnt_m += np.bincount(c.astype(np.int64) * S + shard_of_u[r], minlength=M * S)
        keep = local_u[r] | local_m[c]
        keep_r.append(r[keep])
        keep_c.append(c[keep])
        keep_v.append(v[keep])
    cnt_u = cnt_u.reshape(U, S).astype(np.int32)
    cnt_m = cnt_m.reshape(M, S).astype(np.int32)

    r = np.concatenate(keep_r) if keep_r else np.zeros(0, np.int32)
    c = np.concatenate(keep_c) if keep_c else np.zeros(0, np.int32)
    v = np.concatenate(keep_v) if keep_v else np.zeros(0, np.float32)
    local_nnz = int(r.shape[0])
    if len(local) < S and total_train and local_nnz >= total_train:
        raise RuntimeError(
            f"per-host retention kept all {total_train} training ratings on a process owning "
            f"only shards {local} of {S}: the locality filter is not reducing the resident ratings"
        )
    cv = v - np.float32(mean)
    own_u, own_m = local_u[r], local_m[c]
    u_indptr, u_idx, u_val = csr_from_coo(r[own_u], c[own_u], cv[own_u], U)
    m_indptr, m_idx, m_val = csr_from_coo(c[own_m], r[own_m], cv[own_m], M)
    users = _ring_side_buckets(u_indptr, u_idx, u_val, part_u, part_m, S, pads,
                               shard_counts=cnt_u, local_shards=local)
    movies = _ring_side_buckets(m_indptr, m_idx, m_val, part_m, part_u, S, pads,
                                shard_counts=cnt_m, local_shards=local)

    trows = np.concatenate(test_rows) if test_rows else np.zeros(0, np.int32)
    tcols = np.concatenate(test_cols) if test_cols else np.zeros(0, np.int32)
    tvals = np.concatenate(test_vals) if test_vals else np.zeros(0, np.float32)
    lo = (vmin if np.isfinite(vmin) else -np.inf) if min_rating is None else min_rating
    hi = (vmax if np.isfinite(vmax) else np.inf) if max_rating is None else max_rating
    data = DistBPMFData(
        users=users,
        movies=movies,
        test=DistTestSet(
            rows=torch.from_numpy(part_u.perm[trows].astype(np.int32)),
            cols=torch.from_numpy(part_m.perm[tcols].astype(np.int32)),
            vals=torch.from_numpy(np.asarray(tvals, np.float32)),
        ),
        mean_rating=torch.tensor(mean, dtype=torch.float32),
        num_shards=S,
        min_rating=lo,
        max_rating=hi,
    )
    plan = DistPlan(part_u, part_m, S, strategy, local_shards=local, local_nnz=local_nnz,
                    total_nnz=total_train)
    return data, plan


def _place_side(side: RingSide, opp_cap: int, ring: Ring, cfg: BPMFConfig | None) -> RingSide:
    devs = ring.devices
    steps = tuple(
        tuple(tuple(b.to(devs[d]) for b in per_shard) for d, per_shard in enumerate(per_step))
        for per_step in side.steps
    )
    plans = ()
    if cfg is not None:
        plans = tuple(
            tuple(
                ops.plan_step(bs, opp_cap, cfg.K, side.cap, compute_dtype=cfg.compute_dtype,
                              gram_impl=cfg.gram_impl, backend=ops.key_backend(devs[d].type)) if bs else None
                for d, bs in enumerate(per_step)
            )
            for per_step in steps
        )
    return dataclasses.replace(
        side,
        steps=steps,
        orig_ids=tuple(o.to(devs[d]) for d, o in enumerate(side.orig_ids)),
        plans=plans,
    )


def place_data(data: DistBPMFData, ring: Ring, cfg: BPMFConfig | None = None) -> DistBPMFData:
    """Local shard i's buckets and ids on ``ring.devices[i]``, the test set on the ring's home.

    With ``cfg`` every (side, step, shard) also gets its Gram dispatch
    (:func:`repro_torch.kernels.ops.plan_step` for ``cfg.gram_impl``, from
    the autotune cache or its heuristic), with the fused layout and item ->
    chunk order where the plan is fused: decided and built once here,
    because the layout is the same every sweep and a captured sweep must
    run what was decided. Shards share their bucket shapes at a step, so
    every shard of a step, in every process, takes the same decision.
    """
    if data.num_shards != ring.num_shards:
        raise ValueError(f"data has {data.num_shards} shards, the ring {ring.num_shards}")
    held = range(data.users.shard_offset, data.users.shard_offset + data.users.num_shards)
    if held != ring.local_shards:
        raise ValueError(f"data holds shards {held}, the ring's process {ring.local_shards}")
    home = ring.home
    return dataclasses.replace(
        data,
        users=_place_side(data.users, data.movies.cap, ring, cfg),
        movies=_place_side(data.movies, data.users.cap, ring, cfg),
        test=DistTestSet(*(getattr(data.test, f).to(home) for f in ("rows", "cols", "vals"))),
        mean_rating=data.mean_rating.to(home),
    )


# --------------------------------------------------------------------------
# Device-side sweep: each step runs for every shard, in shard order
# --------------------------------------------------------------------------


def _accumulate(G, g, X_src, side: RingSide, t: int, i: int, cfg: BPMFConfig) -> None:
    """Add ring step t's contributions to local shard i's ``(G, g)`` (``ops.bpmf_gram_step``, its plan)."""
    ops.bpmf_gram_step(
        G, g, X_src, side.steps[t][i],
        alpha=cfg.alpha, compute_dtype=cfg.compute_dtype, gram_impl=cfg.gram_impl,
        plan=side.plans[t][i] if side.plans else None,
    )


def _zero_terms(side: RingSide, K: int, ring: Ring) -> tuple[list, list]:
    f32 = torch.float32
    G = [torch.zeros(side.cap, K, K, dtype=f32, device=dev) for dev in ring.devices]
    g = [torch.zeros(side.cap, K, dtype=f32, device=dev) for dev in ring.devices]
    return G, g


def _sample_shards(key, side: RingSide, G, g, hyper: HyperParams, ring: Ring) -> tuple:
    keys, hypers = _per_shard(key, ring), _per_shard(hyper, ring)
    return tuple(
        posterior.sample_from_terms(keys[i], side.orig_ids[i], G[i], g[i], hypers[i])
        for i in range(len(ring.devices))
    )


def _half_sweep_ring(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Paper §IV-C: rotate opposite shards around the ring, overlap compute.

    The rotation for step t+1 is issued before step t's Gram accumulation,
    so a transfer between cards or processes proceeds while the kernel runs.
    Each step is a host span ``ring.step`` (it times an eager sweep; a
    captured one shows it only at capture).
    """
    trace.phase("gram")
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    bufs = ring.stage([InFlight(x) for x in X_opp])
    for t in range(ring.num_shards):
        with trace.span("ring.step", step=t):
            nxt = ring.rotate(bufs) if t + 1 < ring.num_shards else None  # in flight during the Gram
            for i in range(len(bufs)):
                _accumulate(G[i], g[i], ring.take(bufs[i]), side, t, i, cfg)
        if nxt is not None:
            bufs = nxt
    return _sample_shards(key, side, G, g, hyper, ring)


def _half_sweep_ring_async(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Depth-d pipelined ring (Vander Aa et al. 1705.10633, DESIGN.md §7).

    A queue of ``d = cfg.pipeline_depth`` buffers: the prologue issues the
    rotations for steps 1..d-1, step t issues the one for step t+d, and the
    last d steps drain the queue. The buffer consumed at step t holds shard
    ``(d_axis - t) mod S`` at any depth, so the draw is bit-identical to
    ``comm_mode="ring"``; d opposite blocks are live at once (across
    processes: d sends and receives in flight).
    """
    if cfg.pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {cfg.pipeline_depth}")
    S = ring.num_shards
    depth = min(cfg.pipeline_depth, S)  # more than S - 1 rotations cannot exist
    trace.phase("gram")
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    queue = [ring.stage([InFlight(x) for x in X_opp])]  # queue[i] holds the buffers of step t + i
    for _ in range(depth - 1):
        queue.append(ring.rotate(queue[-1]))
    for t in range(S):
        if t + depth < S:  # issue step t+d while accumulating step t
            queue.append(ring.rotate(queue[-1]))
        bufs = queue.pop(0)
        for i in range(len(bufs)):
            _accumulate(G[i], g[i], ring.take(bufs[i]), side, t, i, cfg)
    return _sample_shards(key, side, G, g, hyper, ring)


def _half_sweep_allgather(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Synchronous baseline: each device concatenates every opposite block, then updates.

    Reuses the ring's neighbor lists: at step t shard d reads block
    ``(d - t) mod S`` of the gathered matrix. Across processes the blocks
    come by one ``all_gather``.
    """
    S = ring.num_shards
    cap_opp = X_opp[0].shape[0]
    trace.phase("gram")
    if ring.spans_processes:
        full = {ring.home: torch.cat(ring.all_gather(torch.cat(X_opp)))}
    else:
        full = {dev: torch.cat([x.to(dev) for x in X_opp]) for dev in ring.distinct_devices()}
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    for t in range(S):
        for i, d in enumerate(ring.local_shards):
            o = (d - t) % S
            block = full[ring.devices[i]][o * cap_opp : (o + 1) * cap_opp]
            _accumulate(G[i], g[i], block, side, t, i, cfg)
    return _sample_shards(key, side, G, g, hyper, ring)


_HALVES = {
    "ring": _half_sweep_ring,
    "ring_async": _half_sweep_ring_async,
    "allgather": _half_sweep_allgather,
}


def _psum_ordered(xs: Sequence[torch.Tensor], ring: Ring) -> torch.Tensor:
    """Sum over all S shards in shard order 0..S-1, on the ring's home: the order does not depend on the ring.

    Across processes the local terms are gathered first (an exact copy), so
    every process sums the same ``[S, ...]`` stack as one process would.
    """
    stack = torch.stack([x.to(ring.home) for x in xs])
    if ring.spans_processes:
        stack = torch.cat(ring.all_gather(stack))
    return stack.sum(dim=0)


def _sample_hyper_dist(key, X: Sequence[torch.Tensor], orig_ids, prior, ring: Ring) -> HyperParams:
    """NW conditional from the shards' sufficient statistics (padding slots weigh 0).

    Across processes the three statistics of every local shard travel in
    one gather, and each is unpacked to its own ``[S, ...]`` stack before
    the sum, so the sums are :func:`_psum_ordered`'s.
    """
    stats = [hyper_sufficient_stats(x, ids >= 0) for x, ids in zip(X, orig_ids)]
    if not ring.spans_processes:
        n, sx, sxx = (_psum_ordered([s[i] for s in stats], ring) for i in range(3))
        return sample_hyper_from_stats(key, n, sx, sxx, prior)
    K = X[0].shape[-1]
    packed = torch.stack([torch.cat([n.reshape(1), sx, sxx.reshape(-1)]).to(ring.home) for n, sx, sxx in stats])
    every = torch.cat(ring.all_gather(packed))  # [S, 1 + K + K*K]
    n = every[:, 0].contiguous().sum(dim=0)
    sx = every[:, 1 : 1 + K].contiguous().sum(dim=0)
    sxx = every[:, 1 + K :].reshape(-1, K, K).contiguous().sum(dim=0)
    return sample_hyper_from_stats(key, n, sx, sxx, prior)


def _predict_dist(U, V, test: DistTestSet, mean_rating, min_rating, max_rating, ring: Ring):
    """Test predictions from factor rows spread over the shards.

    Each test row lives on one shard; the JAX package sums masked local
    gathers over the ring, which adds exact zeros, so gathering from the
    shards' concatenation on the home device gives the same bits. Across
    processes every process gathers all blocks (``all_gather``) and
    computes the same replicated predictions.
    """
    home = ring.home
    U_all = torch.cat([u.to(home) for u in U])
    V_all = torch.cat([v.to(home) for v in V])
    if ring.spans_processes:
        U_all, V_all = torch.cat(ring.all_gather(U_all)), torch.cat(ring.all_gather(V_all))
    preds = (U_all[test.rows.long()] * V_all[test.cols.long()]).sum(dim=-1) + mean_rating
    return preds.clamp(min_rating, max_rating)


def _sweep_step(key, state: DistState, pred: PredictionState, data: DistBPMFData,
                cfg: BPMFConfig, ring: Ring,
                prior: NormalWishartPrior | None = None) -> tuple[DistState, PredictionState, torch.Tensor]:
    """One full Gibbs sweep over the ring (Algorithm 1, distributed); the metrics row stays on the device.

    ``prior`` is ``cfg.prior(ring.home)``, built here when not given. In a
    ring over processes every process gets the same hyper-parameters,
    predictions and metrics row.
    """
    if cfg.comm_mode not in _HALVES:
        raise ValueError(f"unknown comm_mode {cfg.comm_mode!r}; one of {sorted(_HALVES)}")
    half = _HALVES[cfg.comm_mode]
    trace.phase("hyper")
    prior = cfg.prior(ring.home) if prior is None else prior
    k_hv, k_v, k_hu, k_u = sweep_keys(key, state.sweep)

    # movies given users
    hyper_V = _sample_hyper_dist(k_hv, state.V, data.movies.orig_ids, prior, ring)
    V = half(k_v, state.U, data.movies, hyper_V, cfg, ring)
    # users given updated movies
    trace.phase("hyper")
    hyper_U = _sample_hyper_dist(k_hu, state.U, data.users.orig_ids, prior, ring)
    U = half(k_u, V, data.users, hyper_U, cfg, ring)

    trace.phase("predict")
    sweep = state.sweep + 1
    preds = _predict_dist(U, V, data.test, data.mean_rating, data.min_rating, data.max_rating, ring)
    pred, r_sample, r_avg = accumulate_predictions(pred, preds, data.test.vals, sweep > cfg.burn_in)
    row = metrics_row(r_sample, r_avg, sweep, hyper_ok(hyper_U, hyper_V))
    return DistState(U=U, V=V, hyper_U=hyper_U, hyper_V=hyper_V, sweep=sweep), pred, row


def dist_gibbs_sweep(key, state: DistState, pred: PredictionState, data: DistBPMFData,
                     cfg: BPMFConfig, ring: Ring,
                     prior: NormalWishartPrior | None = None) -> tuple[DistState, PredictionState, SweepMetrics]:
    """One distributed sweep and its metrics on the host (the JAX package's per-sweep entry point)."""
    with trace.sweep():
        state, pred, row = _sweep_step(key, state, pred, data, cfg, ring, prior)
    return state, pred, SweepMetrics(*map(float, row[:3].cpu().numpy()))


def dist_sweep_step(key, state: DistState, pred: PredictionState, accum: tuple[PosteriorAccum, ...],
                    data: DistBPMFData, cfg: BPMFConfig, ring: Ring,
                    prior: NormalWishartPrior | None = None):
    """One sweep of a block: :func:`_sweep_step`, then every shard's accumulator (in place).

    The unit that the ring backends capture as a CUDA graph. Returns
    ``(state, pred, accum, row)``.
    """
    with trace.sweep():
        state, pred, row = _sweep_step(key, state, pred, data, cfg, ring, prior)
        trace.phase("accum")
        accum = tuple(
            update_posterior_accum(a, state.U[d], state.V[d], (state.sweep > cfg.burn_in).to(a.count.device))
            for d, a in enumerate(accum)
        )
    return state, pred, accum, row


def dist_gibbs_sweep_block(
    key: torch.Tensor,
    state: DistState,
    pred: PredictionState,
    accum: tuple[PosteriorAccum, ...],
    data: DistBPMFData,
    cfg: BPMFConfig,
    ring: Ring,
    block_size: int,
    prior: NormalWishartPrior | None = None,
) -> tuple[DistState, PredictionState, tuple[PosteriorAccum, ...], torch.Tensor]:
    """``block_size`` distributed sweeps, issued one op at a time, with no read back to the host.

    Local shard i's posterior accumulator (``accum[i]``) sums its own rows
    on its device, updated in place. (Across processes the metrics rows
    come from collectives, which the host waits for.) Returns ``(state, pred, accum, metrics)``
    with ``metrics`` a ``[block_size, 4]`` float32 tensor of per-sweep rows
    (:func:`repro_torch.core.gibbs.metrics_row`) on the ring's home device.
    """
    prior = cfg.prior(ring.home) if prior is None else prior
    rows = []
    for _ in range(block_size):
        state, pred, accum, row = dist_sweep_step(key, state, pred, accum, data, cfg, ring, prior)
        rows.append(row)
    return state, pred, accum, torch.stack(rows)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def init_dist_state(key: torch.Tensor, data: DistBPMFData, cfg: BPMFConfig, ring: Ring) -> DistState:
    """Prior-predictive init; each row keyed by its original item id, as ``gibbs.init_state`` keys it."""
    ku, kv = prng.split(key)
    dt = cfg.sample_dtype
    kus, kvs = _per_shard(ku, ring), _per_shard(kv, ring)
    return DistState(
        U=tuple(init_rows(kus[d], ids, cfg.K).to(dt) for d, ids in enumerate(data.users.orig_ids)),
        V=tuple(init_rows(kvs[d], ids, cfg.K).to(dt) for d, ids in enumerate(data.movies.orig_ids)),
        hyper_U=HyperParams.init(cfg.K, dt, ring.home),
        hyper_V=HyperParams.init(cfg.K, dt, ring.home),
        sweep=counter(0, ring.home),
    )


def init_dist_accum(data: DistBPMFData, cfg: BPMFConfig, ring: Ring, keep: int) -> tuple[PosteriorAccum, ...]:
    """Zeroed posterior accumulators, one per shard on its device (pad slots are never read)."""
    return tuple(
        PosteriorAccum.init(data.users.cap, data.movies.cap, cfg.K, keep, dev) for dev in ring.devices
    )


def run_distributed(
    key: torch.Tensor,
    data: DistBPMFData,
    cfg: BPMFConfig,
    ring: Ring,
    num_sweeps: int,
    callback=None,
) -> tuple[DistState, PredictionState, list[SweepMetrics]]:
    """Run loop: init and ``num_sweeps`` sweeps on placed data (one host read per sweep)."""
    k_init, k_run = prng.split(key)
    state = init_dist_state(k_init, data, cfg, ring)
    pred = PredictionState.init(data.test.rows.shape[0], ring.home)
    history: list[SweepMetrics] = []
    for _ in range(num_sweeps):
        state, pred, metrics = dist_gibbs_sweep(k_run, state, pred, data, cfg, ring)
        history.append(metrics)
        if callback is not None:
            callback(state, metrics)
    return state, pred, history


def fetch_global(x) -> np.ndarray:
    """Host copy of a tensor, or of the global array a :class:`LocalShardedArray` is one process's block of.

    A :class:`LocalShardedArray` whose block is not the whole array is
    gathered from every process (blocks of one size, in rank order): a
    collective, which every process of the job must call together.
    """
    if isinstance(x, LocalShardedArray):
        if x.block.shape[0] == x.global_rows:
            x = x.block
        else:
            x = torch.cat(all_gather_blocks(x.block))
    return x.detach().cpu().numpy()


def gather_factors(state: DistState, plan: DistPlan) -> tuple[np.ndarray, np.ndarray]:
    """Undo the relabeling: (U, V) in original item order, on the host.

    In a ring over processes every process gets the whole factors (a
    collective, :func:`fetch_global`).
    """
    S = plan.num_shards

    def whole(blocks, cap: int) -> np.ndarray:
        local = torch.cat([b.to(blocks[0].device) for b in blocks])
        return fetch_global(LocalShardedArray(local, S * cap, process_index() * local.shape[0]))

    U = whole(state.U, plan.part_users.cap)
    V = whole(state.V, plan.part_movies.cap)
    return U[plan.part_users.perm], V[plan.part_movies.perm]
