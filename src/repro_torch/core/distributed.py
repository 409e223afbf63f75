"""Distributed BPMF Gibbs sampling (paper §IV) over a ring of S shards.

The paper distributes U and V across MPI ranks, balances work with a
cost-model-driven reorder of R, and overlaps communication with computation
using buffered MPI_Isend/Irecv. The JAX package runs that as one
``shard_map`` program over S devices; this port keeps its single-controller
model:

  * ranks            -> an ordered list of S shard devices (:class:`Ring`);
                        shard d sits on card ``d % n`` of the n visible
                        cards, or on the CPU. Each shard's factor block,
                        buckets and ``(G, g)`` sums live on its device, and
                        every step of the per-shard program runs for shard
                        0, 1, ..., S-1 in turn
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
cards a rotation is a ``tensor.to(next_device, non_blocking=True)`` on a
side stream of each card, and the compute stream waits on an event before
it reads the buffer.

Correctness contract (DESIGN.md §1): for identical (key, data), every
comm_mode and every shard count draws the same posterior samples as the
sequential sampler, up to float reduction order. Per-item noise is keyed by
original item id (``posterior.item_noise``) and the hyper-parameter
statistics are summed over shards in shard order (:func:`_psum_ordered`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

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
from repro_torch.data.sparse import RatingsCOO, csr_from_coo, stable_mean, train_test_split
from repro_torch.kernels import ops


# --------------------------------------------------------------------------
# Containers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingSide:
    """Neighbor lists for updating one side, laid out for the ring schedule.

    ``steps[t][d]`` holds shard d's buckets for ring step t: the
    contributions to each of its items' Gram terms from opposite-side items
    owned by shard ``(d - t) mod S``, which is the block in shard d's buffer
    at step t. Neighbor indices are local to that source shard. Bucket
    shapes at a step agree across shards, as in the JAX package, whose
    ``[S * B, ...]`` arrays are these blocks stacked.

    ``Bucket.item_ids`` are local rows of the shard's ``[cap, K]`` block
    (-1 = padding); ``orig_ids[d]`` gives each row's original item id
    (-1 = padding slot), which keys the per-item noise.

    ``fused[t][d]`` is the step's flattened layout for the fused kernel
    (``None`` where the step has no buckets), built once on the shard's
    device by :func:`place_data`; empty when the run does not use it.
    """

    steps: tuple[tuple[tuple[Bucket, ...], ...], ...]
    orig_ids: tuple[torch.Tensor, ...]  # per shard [cap] int32
    cap: int = 0
    num_items: int = 0
    fused: tuple[tuple[ops.FusedStep | None, ...], ...] = ()

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_shards(self) -> int:
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
        """Fused-kernel launches one sweep makes: the (side, step, shard) layouts with a live row."""
        return sum(
            1 for side in (self.users, self.movies)
            for per_step in side.fused for f in per_step
            if f is not None and f.num_rows > 0
        )


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
    """Host-side record of how the problem was partitioned."""

    part_users: Partition
    part_movies: Partition
    num_shards: int
    strategy: str


# --------------------------------------------------------------------------
# The ring of shard devices
# --------------------------------------------------------------------------


class InFlight(NamedTuple):
    """A shard's buffer and the event of its arrival (``None``: already in place)."""

    tensor: torch.Tensor
    event: torch.cuda.Event | None = None


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Ring:
    """The S shard devices of a ring, and the rotation of buffers around it."""

    def __init__(self, devices: Sequence[torch.device | str]):
        if not devices:
            raise ValueError("a ring needs at least one shard device")
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        self._side_streams: dict[torch.device, torch.cuda.Stream] = {}

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Shard 0's device: hyper-parameters, test predictions and metrics live here."""
        return self.devices[0]

    def distinct_devices(self) -> list[torch.device]:
        """The ring's devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def shards_per_device(self) -> dict[str, int]:
        """How many shards share each device."""
        out: dict[str, int] = {}
        for dev in self.devices:
            out[str(dev)] = out.get(str(dev), 0) + 1
        return out

    def rotate(self, bufs: Sequence[InFlight]) -> list[InFlight]:
        """One ring hop (``lax.ppermute`` with perm ``i -> i + 1``): shard d receives shard d-1's buffer.

        A buffer whose next shard shares its device is handed over as it
        is. Otherwise the copy is issued on side streams of both cards and
        returns at once; :meth:`take` makes the reader wait for it.
        """
        S = len(bufs)
        out = []
        for d in range(S):
            buf = bufs[(d - 1) % S]
            dst = self.devices[d]
            out.append(buf if buf.tensor.device == dst else self._send(buf, dst))
        return out

    def take(self, buf: InFlight) -> torch.Tensor:
        """The buffer's tensor, once the current stream of its device has waited for its arrival."""
        if buf.event is None:
            return buf.tensor
        stream = torch.cuda.current_stream(buf.tensor.device)
        stream.wait_event(buf.event)
        buf.tensor.record_stream(stream)
        return buf.tensor

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


def _per_shard(x, ring: Ring) -> list:
    """``x`` (a tensor or a container with ``.to``) on every shard's device, one copy per device."""
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
) -> RingSide:
    """Build the per-step bucketed neighbor lists for one side (CPU tensors).

    For item i (owned by shard d at local row r) and ring step t, collect the
    neighbors j with shard(j) == (d - t) mod S, and store their local
    opposite indices. Bucket shapes are agreed over all shards (max per step
    and pad class). Slots fill in ascending original id and neighbors in
    CSR order: the layout of ``repro.core.distributed._ring_side_buckets``,
    element for element.
    """
    S = num_shards
    cap = part_self.cap
    cap_opp = part_opp.cap
    num_items = len(indptr) - 1
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
        per_shard: list[list[Bucket]] = [[] for _ in range(S)]
        for pc in sorted(int(p) for p in np.unique(pc_t[present])):
            in_class = present & (pc_t == pc)
            per_dev = np.bincount(d_of[in_class], minlength=S)
            B = -(-int(per_dev.max()) // bucket_multiple) * bucket_multiple
            item_ids = np.full((S, B), -1, dtype=np.int32)
            nbr = np.zeros((S, B, pc), dtype=np.int32)
            val = np.zeros((S, B, pc), dtype=np.float32)
            nnz = np.zeros((S, B), dtype=np.int32)
            for d in range(S):
                # ascending original id, as in the JAX package
                for slot, old_id in enumerate(np.nonzero(in_class & (d_of == d))[0]):
                    r = int(part_self.perm[old_id]) % cap
                    lo, hi = indptr[old_id], indptr[old_id + 1]
                    nbr_new = part_opp.perm[indices[lo:hi]]
                    sel = (nbr_new // cap_opp) == ((d - t) % S)
                    nb = (nbr_new % cap_opp)[sel]
                    item_ids[d, slot] = r
                    nnz[d, slot] = len(nb)
                    nbr[d, slot, : len(nb)] = nb
                    val[d, slot, : len(nb)] = values[lo:hi][sel]
            for d in range(S):
                per_shard[d].append(Bucket(
                    item_ids=torch.from_numpy(item_ids[d]),
                    nbr=torch.from_numpy(nbr[d]),
                    val=torch.from_numpy(val[d]),
                    nnz=torch.from_numpy(nnz[d]),
                ))
        steps.append(tuple(tuple(b) for b in per_shard))

    orig = np.asarray(part_self.inv_perm, dtype=np.int32)  # [S*cap], -1 pads
    return RingSide(
        steps=tuple(steps),
        orig_ids=tuple(torch.from_numpy(orig[d * cap : (d + 1) * cap].copy()) for d in range(S)),
        cap=cap,
        num_items=num_items,
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


def _place_side(side: RingSide, ring: Ring, fused: bool) -> RingSide:
    devs = ring.devices
    steps = tuple(
        tuple(tuple(b.to(devs[d]) for b in per_shard) for d, per_shard in enumerate(per_step))
        for per_step in side.steps
    )
    layouts = ()
    if fused:
        layouts = tuple(
            tuple(ops.fused_step(bs) if bs else None for bs in per_step) for per_step in steps
        )
    return dataclasses.replace(
        side,
        steps=steps,
        orig_ids=tuple(o.to(devs[d]) for d, o in enumerate(side.orig_ids)),
        fused=layouts,
    )


def place_data(data: DistBPMFData, ring: Ring, fused: bool = True) -> DistBPMFData:
    """Shard d's buckets and ids on ``ring.devices[d]``, the test set on the ring's home.

    With ``fused`` every (side, step, shard) also gets its flattened layout
    and item -> chunk order (:func:`repro_torch.kernels.ops.fused_step`),
    built once here because the layout is the same every sweep.
    """
    if data.num_shards != ring.num_shards:
        raise ValueError(f"data has {data.num_shards} shards, the ring {ring.num_shards}")
    home = ring.home
    return dataclasses.replace(
        data,
        users=_place_side(data.users, ring, fused),
        movies=_place_side(data.movies, ring, fused),
        test=DistTestSet(*(getattr(data.test, f).to(home) for f in ("rows", "cols", "vals"))),
        mean_rating=data.mean_rating.to(home),
    )


# --------------------------------------------------------------------------
# Device-side sweep: each step runs for every shard, in shard order
# --------------------------------------------------------------------------


def _accumulate(G, g, X_src, side: RingSide, t: int, d: int, cfg: BPMFConfig) -> None:
    """Add ring step t's contributions to shard d's ``(G, g)`` (``ops.bpmf_gram_step``)."""
    ops.bpmf_gram_step(
        G, g, X_src, side.steps[t][d],
        alpha=cfg.alpha, compute_dtype=cfg.compute_dtype, gram_impl=cfg.gram_impl,
        layout=side.fused[t][d] if side.fused else None,
    )


def _zero_terms(side: RingSide, K: int, ring: Ring) -> tuple[list, list]:
    f32 = torch.float32
    G = [torch.zeros(side.cap, K, K, dtype=f32, device=dev) for dev in ring.devices]
    g = [torch.zeros(side.cap, K, dtype=f32, device=dev) for dev in ring.devices]
    return G, g


def _sample_shards(key, side: RingSide, G, g, hyper: HyperParams, ring: Ring) -> tuple:
    keys, hypers = _per_shard(key, ring), _per_shard(hyper, ring)
    return tuple(
        posterior.sample_from_terms(keys[d], side.orig_ids[d], G[d], g[d], hypers[d])
        for d in range(ring.num_shards)
    )


def _half_sweep_ring(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Paper §IV-C: rotate opposite shards around the ring, overlap compute.

    The rotation for step t+1 is issued before step t's Gram accumulation,
    so a transfer between cards proceeds while the kernel runs.
    """
    S = ring.num_shards
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    bufs = [InFlight(x) for x in X_opp]
    for t in range(S):
        nxt = ring.rotate(bufs) if t + 1 < S else None  # in flight during the Gram
        for d in range(S):
            _accumulate(G[d], g[d], ring.take(bufs[d]), side, t, d, cfg)
        if nxt is not None:
            bufs = nxt
    return _sample_shards(key, side, G, g, hyper, ring)


def _half_sweep_ring_async(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Depth-d pipelined ring (Vander Aa et al. 1705.10633, DESIGN.md §7).

    A queue of ``d = cfg.pipeline_depth`` buffers: the prologue issues the
    rotations for steps 1..d-1, step t issues the one for step t+d, and the
    last d steps drain the queue. The buffer consumed at step t holds shard
    ``(d_axis - t) mod S`` at any depth, so the draw is bit-identical to
    ``comm_mode="ring"``; d opposite blocks are live at once.
    """
    if cfg.pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {cfg.pipeline_depth}")
    S = ring.num_shards
    depth = min(cfg.pipeline_depth, S)  # more than S - 1 rotations cannot exist
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    queue = [[InFlight(x) for x in X_opp]]  # queue[i] holds the buffers of step t + i
    for _ in range(depth - 1):
        queue.append(ring.rotate(queue[-1]))
    for t in range(S):
        if t + depth < S:  # issue step t+d while accumulating step t
            queue.append(ring.rotate(queue[-1]))
        bufs = queue.pop(0)
        for d in range(S):
            _accumulate(G[d], g[d], ring.take(bufs[d]), side, t, d, cfg)
    return _sample_shards(key, side, G, g, hyper, ring)


def _half_sweep_allgather(key, X_opp, side: RingSide, hyper, cfg: BPMFConfig, ring: Ring) -> tuple:
    """Synchronous baseline: each device concatenates every opposite block, then updates.

    Reuses the ring's neighbor lists: at step t shard d reads block
    ``(d - t) mod S`` of the gathered matrix.
    """
    S = ring.num_shards
    cap_opp = X_opp[0].shape[0]
    full = {dev: torch.cat([x.to(dev) for x in X_opp]) for dev in ring.distinct_devices()}
    G, g = _zero_terms(side, X_opp[0].shape[-1], ring)
    for t in range(S):
        for d in range(S):
            o = (d - t) % S
            block = full[ring.devices[d]][o * cap_opp : (o + 1) * cap_opp]
            _accumulate(G[d], g[d], block, side, t, d, cfg)
    return _sample_shards(key, side, G, g, hyper, ring)


_HALVES = {
    "ring": _half_sweep_ring,
    "ring_async": _half_sweep_ring_async,
    "allgather": _half_sweep_allgather,
}


def _psum_ordered(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum over shards in shard order 0..S-1, on ``device``: the order does not depend on the ring."""
    return torch.stack([x.to(device) for x in xs]).sum(dim=0)


def _sample_hyper_dist(key, X: Sequence[torch.Tensor], orig_ids, prior, ring: Ring) -> HyperParams:
    """NW conditional from the shards' sufficient statistics (padding slots weigh 0)."""
    stats = [hyper_sufficient_stats(x, ids >= 0) for x, ids in zip(X, orig_ids)]
    n, sx, sxx = (_psum_ordered([s[i] for s in stats], ring.home) for i in range(3))
    return sample_hyper_from_stats(key, n, sx, sxx, prior)


def _predict_dist(U, V, test: DistTestSet, mean_rating, min_rating, max_rating, ring: Ring):
    """Test predictions from factor rows spread over the shards.

    Each test row lives on one shard; the JAX package sums masked local
    gathers over the ring, which adds exact zeros, so gathering from the
    shards' concatenation on the home device gives the same bits.
    """
    home = ring.home
    U_all = torch.cat([u.to(home) for u in U])
    V_all = torch.cat([v.to(home) for v in V])
    preds = (U_all[test.rows.long()] * V_all[test.cols.long()]).sum(dim=-1) + mean_rating
    return preds.clamp(min_rating, max_rating)


def _sweep_step(key, state: DistState, pred: PredictionState, data: DistBPMFData,
                cfg: BPMFConfig, ring: Ring,
                prior: NormalWishartPrior | None = None) -> tuple[DistState, PredictionState, torch.Tensor]:
    """One full Gibbs sweep over the ring (Algorithm 1, distributed); the metrics row stays on the device.

    ``prior`` is ``cfg.prior(ring.home)``, built here when not given.
    """
    if cfg.comm_mode not in _HALVES:
        raise ValueError(f"unknown comm_mode {cfg.comm_mode!r}; one of {sorted(_HALVES)}")
    half = _HALVES[cfg.comm_mode]
    prior = cfg.prior(ring.home) if prior is None else prior
    k_hv, k_v, k_hu, k_u = sweep_keys(key, state.sweep)

    # movies given users
    hyper_V = _sample_hyper_dist(k_hv, state.V, data.movies.orig_ids, prior, ring)
    V = half(k_v, state.U, data.movies, hyper_V, cfg, ring)
    # users given updated movies
    hyper_U = _sample_hyper_dist(k_hu, state.U, data.users.orig_ids, prior, ring)
    U = half(k_u, V, data.users, hyper_U, cfg, ring)

    sweep = state.sweep + 1
    preds = _predict_dist(U, V, data.test, data.mean_rating, data.min_rating, data.max_rating, ring)
    pred, r_sample, r_avg = accumulate_predictions(pred, preds, data.test.vals, sweep > cfg.burn_in)
    row = metrics_row(r_sample, r_avg, sweep, hyper_ok(hyper_U, hyper_V))
    return DistState(U=U, V=V, hyper_U=hyper_U, hyper_V=hyper_V, sweep=sweep), pred, row


def dist_sweep_step(key, state: DistState, pred: PredictionState, accum: tuple[PosteriorAccum, ...],
                    data: DistBPMFData, cfg: BPMFConfig, ring: Ring,
                    prior: NormalWishartPrior | None = None):
    """One sweep of a block: :func:`_sweep_step`, then every shard's accumulator (in place).

    The unit that the ring backends capture as a CUDA graph. Returns
    ``(state, pred, accum, row)``.
    """
    state, pred, row = _sweep_step(key, state, pred, data, cfg, ring, prior)
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

    Shard d's posterior accumulator (``accum[d]``) sums its own rows on its
    device, updated in place. Returns ``(state, pred, accum, metrics)``
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
    accum = init_dist_accum(data, cfg, ring, keep=0)
    history: list[SweepMetrics] = []
    for _ in range(num_sweeps):
        state, pred, accum, rows = dist_gibbs_sweep_block(k_run, state, pred, accum, data, cfg, ring, 1)
        metrics = SweepMetrics(*map(float, rows[0, :3].cpu().numpy()))
        history.append(metrics)
        if callback is not None:
            callback(state, metrics)
    return state, pred, history


def gather_factors(state: DistState, plan: DistPlan) -> tuple[np.ndarray, np.ndarray]:
    """Undo the relabeling: (U, V) in original item order, on the host."""
    U = torch.cat([u.cpu() for u in state.U]).numpy()
    V = torch.cat([v.cpu() for v in state.V]).numpy()
    return U[plan.part_users.perm], V[plan.part_movies.perm]
