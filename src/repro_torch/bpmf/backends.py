"""Backend registry: one sampler, several execution strategies.

``BPMFEngine`` dispatches to a registry entry by ``BackendConfig.name``.
Registered here:

  * ``"sequential"`` — the single-device sampler of :mod:`repro_torch.core.gibbs`;
  * ``"ring"``, ``"ring_async"``, ``"allgather"`` — the distributed sampler
    of :mod:`repro_torch.core.distributed` over a ring of
    ``BackendConfig.num_shards`` shards (paper §IV-C; ring_async keeps
    ``pipeline_depth`` rotations in flight, arXiv:1705.10633).

  * ``"posterior_merge"`` — ``BackendConfig.num_partitions`` independent
    chains of the sequential sampler over user partitions, whose subset
    posteriors merge once, at export (arXiv:1703.00734, DESIGN.md §12).

The full-data backends draw the same posterior samples for the same
``(seed, data)``, up to float reduction order; ``posterior_merge`` is
approximate inference (``exact_parity = False``).

Each backend defines one sweep, ``_sweep(key, carry)``, that issues device
work only. On a CUDA device whose shards or chains all sit on one card,
``sweep_block`` captures that sweep once as a CUDA graph and replays it
(:class:`repro_torch.core.sweep_graph.SweepGraph`), the port's
counterpart of the reference's ``jax.jit`` over ``lax.scan``; a capture
that fails raises. On the CPU, for a layout across several cards
(written, never run: the copies between cards of ``Ring._send`` are
not captured, ROADMAP Queue 1 item 9), and in a job of several processes
(a ``gloo`` call is a host call, which a graph cannot hold), the same sweep
runs eagerly, op by op. On a card the eager loop is reached only through
the private ``_eager=True`` argument, which the card tests and
``chip_smoke.py`` use to hold the graph to it.

Multi-process jobs (DESIGN.md §14): the ring backends split the S shards
over the processes (each builds only its own from the shared rating
stream), and ``posterior_merge`` gives chain c to process ``c % P``. Every
process calls every method in the same order: the metrics, the factors,
the host trees and the export are collectives whose results are the same
on every process.

Each backend also moves its state, prediction and posterior accumulators
to and from *host trees*: nested dicts of numpy arrays with the JAX
package's field names, layouts and dtypes (``int32`` counters), which the
engine writes as the checkpoint leaves that :meth:`Backend.checkpoint_leaves`
names. A ring's per-shard blocks travel concatenated in shard order, as the
JAX package's ring-sharded arrays do; ``posterior_merge`` saves one tree
per chain.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.bpmf.config import BPMFConfig
from repro_torch.checkpoint import host_snapshot_leaf
from repro_torch.core import distributed as dist
from repro_torch.core import gibbs, posterior, prng, subset_merge
from repro_torch.core.gibbs import SweepMetrics
from repro_torch.core.prediction import PredictionState
from repro_torch.core.subset_merge import MergeAccum
from repro_torch.core.sweep_graph import SweepGraph
from repro_torch.core.types import BPMFState, HyperParams, PosteriorAccum, counter
from repro_torch.data.sparse import (
    ChunkedRatings,
    RatingsCOO,
    build_bpmf_data,
    build_bpmf_data_presplit,
    train_test_split,
)
from repro_torch.launch.hostdevices import process_count, process_index
from repro_torch.launch.mesh import bpmf_ring

BACKENDS: dict[str, type["Backend"]] = {}

# The leaves of one state, prediction and posterior tree, in the JAX
# package's tree order: dataclass fields as declared, dict keys sorted.
_STATE_FIELDS = (("U",), ("V",), ("hyper_U", "mu"), ("hyper_U", "Lam"),
                 ("hyper_V", "mu"), ("hyper_V", "Lam"), ("sweep",))
_PRED_FIELDS = (("sum_pred",), ("num_samples",))
_POSTERIOR_KEYS = ("U_samples", "U_sum", "V_samples", "V_sum", "count")


def checkpoint_leaves(chains: int | None = None) -> tuple[tuple[str, tuple], ...]:
    """The leaves of an engine checkpoint and their places in the engine's host tree.

    In the JAX package's manifest order, with its names: tree paths joined
    by ``"__"``, where a dict key gives the bare key, a tuple index the
    bare integer and a dataclass field ``".<field>"``. The top-level dict
    is ``{"history", "posterior", "pred", "state"}``.

    Args:
        chains: ``None`` for one state, prediction and posterior tree; C
            for ``posterior_merge``'s tuples of C per-chain state and
            prediction trees and its posterior keyed ``chain_000``, ...

    Returns:
        ``(name, path)`` pairs; ``path`` indexes the host tree.
    """
    if chains is None:
        posterior = [("posterior", ("posterior",))]
        pred, state = [("pred", ("pred",))], [("state", ("state",))]
    else:
        posterior = [(f"posterior__{_chain_name(c)}", ("posterior", _chain_name(c))) for c in range(chains)]
        pred = [(f"pred__{c}", ("pred", c)) for c in range(chains)]
        state = [(f"state__{c}", ("state", c)) for c in range(chains)]
    out: list[tuple[str, tuple]] = [("history", ("history",))]
    for prefix, path in posterior:
        out += [(f"{prefix}__{k}", path + (k,)) for k in _POSTERIOR_KEYS]
    for trees, fields in ((pred, _PRED_FIELDS), (state, _STATE_FIELDS)):
        for prefix, path in trees:
            out += [("__".join([prefix, *(f".{f}" for f in field)]), path + field) for field in fields]
    return tuple(out)


def _chain_name(c: int) -> str:
    """Checkpoint subtree key of ``posterior_merge`` chain ``c`` (zero-padded: keys sort in chain order)."""
    return f"chain_{c:03d}"


_EMPTY_SUM = np.zeros((0, 0), np.float32)
_EMPTY_STACK = np.zeros((0, 0, 0), np.float32)


def _window_slots(count: int, keep: int, available: int) -> np.ndarray:
    """Rotating-buffer slots of the most recent samples, oldest first."""
    S = min(count, keep, available)
    return np.arange(count - S, count, dtype=np.int64) % max(keep, 1)


def accum_host_tree(
    accum: PosteriorAccum,
    u_order: np.ndarray | None = None,
    v_order: np.ndarray | None = None,
) -> dict:
    """Host view of an accumulator in the JAX package's ``"posterior"`` schema.

    ``{"U_sum", "V_sum", "count", "U_samples", "V_samples"}``: sums are
    ``(0, 0)``-shaped until the first post-burn-in sample, and the sample
    stacks are chronological (oldest kept draw first).

    Args:
        accum: The accumulator (any device; read here).
        u_order / v_order: Relabeled -> original permutations
            (``plan.part_*.perm``) applied to the item axis, for the
            distributed backends. Pass both or neither.
    """
    if (u_order is None) != (v_order is None):
        raise ValueError("accum_host_tree: pass both u_order and v_order, or neither")
    count = int(accum.count)
    if count == 0:
        U_sum, V_sum = _EMPTY_SUM, _EMPTY_SUM
    else:
        # host copies: the sums are updated in place by the next sweep
        U_sum, V_sum = host_snapshot_leaf(accum.U_sum), host_snapshot_leaf(accum.V_sum)
        if u_order is not None:
            U_sum, V_sum = U_sum[u_order], V_sum[v_order]
    slots = _window_slots(count, accum.keep, int(accum.filled))
    if slots.size:
        idx = torch.from_numpy(slots).to(accum.U_window.device)
        Us = host_snapshot_leaf(accum.U_window[idx])
        Vs = host_snapshot_leaf(accum.V_window[idx])
        if u_order is not None:
            Us, Vs = Us[:, u_order], Vs[:, v_order]
    else:
        Us, Vs = _EMPTY_STACK, _EMPTY_STACK
    return {
        "U_sum": U_sum,
        "V_sum": V_sum,
        "count": np.asarray(count, np.int32),
        "U_samples": Us,
        "V_samples": Vs,
    }


def accum_from_host_tree(
    tree: dict,
    template: PosteriorAccum,
    u_scatter: np.ndarray | None = None,
    v_scatter: np.ndarray | None = None,
) -> PosteriorAccum:
    """Rebuild an accumulator (CPU tensors) from :func:`accum_host_tree` output.

    Inverse of the host view: chronological sample stacks go back to their
    rotating-buffer slots (``(count - S + j) % keep``), so a restore at any
    sweep reproduces bit for bit the window an uninterrupted run holds.
    A checkpoint written with a different ``keep`` restores its most recent
    ``min(S, keep)`` samples.

    Args:
        tree: Host arrays in the checkpoint schema.
        template: Accumulator in the backend's internal layout, for shapes
            and ``keep`` only (``[M or S*cap, K]`` sums).
        u_scatter / v_scatter: Original -> relabeled permutations
            (``plan.part_*.perm``) mapping host rows into shard slots.
            Pass both or neither.
    """
    if (u_scatter is None) != (v_scatter is None):
        raise ValueError("accum_from_host_tree: pass both u_scatter and v_scatter, or neither")
    count = int(np.asarray(tree["count"]))
    keep = template.keep
    shape_u, shape_v = tuple(template.U_sum.shape), tuple(template.V_sum.shape)

    def to_internal(host, shape, scatter) -> np.ndarray:
        out = np.zeros(shape, np.float32)
        host = np.asarray(host, np.float32)
        if scatter is None:
            out[: host.shape[0]] = host
        else:
            out[scatter] = host
        return out

    U_sum = np.zeros(shape_u, np.float32)
    V_sum = np.zeros(shape_v, np.float32)
    if count:
        U_sum = to_internal(tree["U_sum"], shape_u, u_scatter)
        V_sum = to_internal(tree["V_sum"], shape_v, v_scatter)
    Us = np.asarray(tree["U_samples"], np.float32)
    Vs = np.asarray(tree["V_samples"], np.float32)
    U_win = np.zeros((keep,) + shape_u, np.float32)
    V_win = np.zeros((keep,) + shape_v, np.float32)
    S = min(Us.shape[0], keep, count)
    for j, slot in enumerate(_window_slots(count, keep, S)):
        src = Us.shape[0] - S + j  # the stacks hold the last Us.shape[0] draws
        U_win[slot] = to_internal(Us[src], shape_u, u_scatter)
        V_win[slot] = to_internal(Vs[src], shape_v, v_scatter)
    return PosteriorAccum(
        U_sum=torch.from_numpy(U_sum), V_sum=torch.from_numpy(V_sum),
        # only the S slots placed hold samples
        count=counter(count), filled=counter(S),
        U_window=torch.from_numpy(U_win), V_window=torch.from_numpy(V_win),
    )


def register_backend(name: str) -> Callable[[type["Backend"]], type["Backend"]]:
    """Class decorator adding a backend under ``name`` (last wins)."""

    def deco(cls: type["Backend"]) -> type["Backend"]:
        cls.name = name
        BACKENDS[name] = cls
        return cls

    return deco


def get_backend(cfg: BPMFConfig, device: torch.device) -> "Backend":
    """Instantiate the backend named by ``cfg.backend.name`` on ``device``.

    Raises:
        ValueError: A name not in the registry.
    """
    name = cfg.backend.name
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; available: {sorted(BACKENDS)}")
    return BACKENDS[name](cfg, device)


def available_backends() -> list[str]:
    """Sorted registry names."""
    return sorted(BACKENDS)


class Backend(abc.ABC):
    """Execution strategy for the BPMF Gibbs sampler.

    Lifecycle: ``prepare(coo)`` once (host-side layout, uploaded to
    ``device``), then ``init_state(key)`` and ``sweep_block(...)``
    repeatedly; ``factors(state)`` recovers (U, V) in original item order.
    A subclass defines one sweep (:meth:`_sweep`) and where its carry lives
    (:meth:`_devices`); :meth:`sweep_block` runs a block of them.
    """

    name: str = "?"
    # whether the backend draws the sequential sampler's samples (up to
    # float reduction order); posterior_merge is approximate inference
    exact_parity = True

    def __init__(self, cfg: BPMFConfig, device: torch.device):
        self.cfg = cfg
        self.core_cfg = cfg.core()
        self.device = device
        self._prepared = False
        # "auto" and "on" hand the graph's static buffers back (the next
        # block overwrites them); "off" hands back copies
        self.donate_blocks = cfg.backend.donate_blocks in ("auto", "on")
        self.graph: SweepGraph | None = None

    @abc.abstractmethod
    def prepare(self, coo: RatingsCOO | ChunkedRatings) -> None:
        """Build the backend's data layout (split, center, bucket) on its device."""

    @abc.abstractmethod
    def init_state(self, key: torch.Tensor) -> BPMFState:
        """Prior-predictive state; layout-independent per original item id."""

    @abc.abstractmethod
    def _sweep(self, key: torch.Tensor, carry: tuple) -> tuple[tuple, torch.Tensor]:
        """One sweep of ``carry = (state, pred, accum)``: ``(carry, row)``, device work only.

        ``row`` is the sweep's ``[4]`` metrics row
        (:func:`repro_torch.core.gibbs.metrics_row`) on :attr:`home`.
        """

    @abc.abstractmethod
    def _devices(self) -> list[torch.device]:
        """The devices the carry lives on."""

    @abc.abstractmethod
    def sweep(self, key: torch.Tensor, state, pred: PredictionState):
        """One Gibbs sweep -> ``(state, pred, SweepMetrics)``, the metrics on the host.

        The legacy per-sweep dispatch (the engine's run loop goes through
        :meth:`sweep_block`): it runs the sweep eagerly, folds nothing into
        a posterior accumulator, and leaves :attr:`graph` and its buffers
        alone, so a captured block replays afterwards as before.
        """

    def captures(self) -> bool:
        """Whether :meth:`sweep_block` replays a CUDA graph: the carry is on one CUDA device, in one process."""
        devices = set(self._devices())
        return len(devices) == 1 and next(iter(devices)).type == "cuda" and process_count() == 1

    def sweep_block(
        self, key: torch.Tensor, state, pred: PredictionState,
        accum: PosteriorAccum, block_size: int, *, _eager: bool = False,
    ):
        """``block_size`` sweeps with no host read inside.

        On one card the first call captures :meth:`_sweep` as a CUDA graph
        (:attr:`graph`) and every call replays it; elsewhere the sweeps run
        eagerly. ``_eager=True`` forces the eager loop on a card too: it is
        private, the comparison that the card tests and ``chip_smoke.py``
        hold the graph to.

        Returns:
            ``(state, pred, accum, metrics)`` — ``metrics`` a
            ``[block_size, 4]`` float32 device tensor of per-sweep
            ``(rmse_sample, rmse_avg, sweep, bad)`` rows
            (:func:`repro_torch.core.gibbs.metrics_row`).
        """
        carry = (state, pred, accum)
        if _eager or not self.captures():
            rows = []
            for _ in range(block_size):
                carry, row = self._sweep(key, carry)
                rows.append(row)
            return (*carry, torch.stack(rows))
        if self.graph is None:
            self.graph = SweepGraph(self._sweep, key, carry)
        carry, rows = self.graph.run(key, carry, block_size, donate=self.donate_blocks)
        return (*carry, rows)

    @abc.abstractmethod
    def factors(self, state) -> tuple[np.ndarray, np.ndarray]:
        """(U, V) as host arrays in *original* item order."""

    @abc.abstractmethod
    def init_accum(self) -> PosteriorAccum:
        """Zeroed posterior accumulator (window depth ``keep_factor_samples``)."""

    def accum_host(self, accum: PosteriorAccum) -> dict:
        """Host view of the accumulator in original item order (see :func:`accum_host_tree`)."""
        return accum_host_tree(accum)

    @abc.abstractmethod
    def accum_from_host(self, tree: dict) -> PosteriorAccum:
        """Rebuild the accumulator on the device from an :meth:`accum_host` tree."""

    @abc.abstractmethod
    def state_host(self, state) -> dict:
        """Host tree of the Gibbs state: ``{"U", "V", "hyper_U": {"mu", "Lam"},
        "hyper_V": {...}, "sweep"}``, factors in the JAX package's layout."""

    @abc.abstractmethod
    def state_from_host(self, tree: dict):
        """The Gibbs state on the device from a :meth:`state_host` tree."""

    def pred_host(self, pred: PredictionState) -> dict:
        """Host tree of the prediction accumulator: ``{"sum_pred", "num_samples"}``."""
        return {
            "sum_pred": host_snapshot_leaf(pred.sum_pred),
            "num_samples": np.asarray(int(pred.num_samples), np.int32),
        }

    def pred_from_host(self, tree: dict) -> PredictionState:
        """The prediction accumulator on :attr:`home` from a :meth:`pred_host` tree."""
        return convert.prediction_from_tree(tree).to(self.home)

    def posterior_export(self, accum: PosteriorAccum) -> dict:
        """Global posterior summary feeding the predictor.

        ``{"count", "U_samples", "V_samples"}`` plus ``"U_mean"`` /
        ``"V_mean"`` when ``count > 0``: host float32 arrays in original
        item order, chronological sample stacks.
        """
        tree = self.accum_host(accum)
        count = int(tree["count"])
        out: dict = {
            "count": count,
            "U_samples": np.asarray(tree["U_samples"], np.float32),
            "V_samples": np.asarray(tree["V_samples"], np.float32),
        }
        if count:
            n = np.float32(count)
            out["U_mean"] = np.asarray(tree["U_sum"] / n, np.float32)
            out["V_mean"] = np.asarray(tree["V_sum"] / n, np.float32)
        return out

    def checkpoint_leaves(self) -> tuple[tuple[str, tuple], ...]:
        """The ``(name, path)`` leaves of this backend's checkpoints (:func:`checkpoint_leaves`)."""
        return checkpoint_leaves()

    @property
    def prepared(self) -> bool:
        """Whether ``prepare()`` has built this backend's data layout."""
        return self._prepared

    @property
    def home(self) -> torch.device:
        """Where the hyper-parameters, test predictions and metrics live."""
        return self.device

    def init_pred(self) -> PredictionState:
        """Zeroed posterior-mean prediction accumulator for the test set."""
        return PredictionState.init(self.num_test, self.home)

    @property
    @abc.abstractmethod
    def num_test(self) -> int:
        """Number of held-out ratings."""

    @property
    @abc.abstractmethod
    def test_vals(self) -> torch.Tensor:
        """Held-out rating values, ``[num_test]`` float32 (uncentered), on :attr:`home`."""

    @property
    @abc.abstractmethod
    def mean_rating(self) -> float:
        """Training-set mean subtracted before sampling, re-added at predict."""

    @property
    @abc.abstractmethod
    def rating_range(self) -> tuple[float, float]:
        """(lo, hi) clip range for predictions."""


@register_backend("sequential")
class SequentialBackend(Backend):
    """Single-device Algorithm 1 via :mod:`repro_torch.core.gibbs`."""

    def prepare(self, coo: RatingsCOO | ChunkedRatings) -> None:
        """Split, center and bucket on the host, then upload to the device.

        A :class:`ChunkedRatings` stream is materialized first. ``prepare_seconds``
        records the host wall time of the two steps (``"build"``, ``"upload"``).
        """
        t0 = time.perf_counter()
        if isinstance(coo, ChunkedRatings):
            coo = coo.materialize()
        host = build_bpmf_data(
            coo,
            pads=self.cfg.backend.bucket_pads,
            test_fraction=self.cfg.run.test_fraction,
            seed=self.cfg.run.seed,
        )
        t1 = time.perf_counter()
        self.data = posterior.plan_data(host.to(self.device), self.core_cfg)
        self.prior = self.core_cfg.prior(self.device)
        self.prepare_seconds = {"build": t1 - t0, "upload": time.perf_counter() - t1}
        self._prepared = True

    def init_state(self, key: torch.Tensor) -> BPMFState:
        """Prior-predictive factors keyed by item id."""
        return gibbs.init_state(key, self.data.num_users, self.data.num_movies, self.core_cfg)

    def _sweep(self, key, carry):
        """One sweep of :func:`repro_torch.core.gibbs.sweep_step`."""
        state, pred, accum, row = gibbs.sweep_step(key, *carry, self.data, self.core_cfg, self.prior)
        return (state, pred, accum), row

    def sweep(self, key: torch.Tensor, state, pred: PredictionState):
        """One eager sweep of :func:`repro_torch.core.gibbs.gibbs_sweep`."""
        return gibbs.gibbs_sweep(key, state, pred, self.data, self.core_cfg)

    def _devices(self) -> list[torch.device]:
        return [self.device]

    def factors(self, state) -> tuple[np.ndarray, np.ndarray]:
        """(U, V) on the host."""
        return state.U.cpu().numpy(), state.V.cpu().numpy()

    def init_accum(self) -> PosteriorAccum:
        """Zeroed accumulator on the backend's device."""
        return self._accum_shaped(self.device)

    def _accum_shaped(self, device) -> PosteriorAccum:
        return PosteriorAccum.init(
            self.data.num_users, self.data.num_movies,
            self.core_cfg.K, self.cfg.run.keep_factor_samples, device,
        )

    def accum_from_host(self, tree: dict) -> PosteriorAccum:
        """The accumulator on the backend's device from a host tree."""
        return accum_from_host_tree(tree, self._accum_shaped("meta")).to(self.device)

    def state_host(self, state: BPMFState) -> dict:
        """``U [M, K]``, ``V [N, K]``, hyper-parameters and the int32 sweep, on the host."""
        return convert.to_tree(state)

    def state_from_host(self, tree: dict) -> BPMFState:
        """The state on the backend's device."""
        return convert.state_from_tree(tree).to(self.device)

    @property
    def num_test(self) -> int:
        """Number of held-out ratings."""
        return int(self.data.test.rows.shape[0])

    @property
    def test_vals(self) -> torch.Tensor:
        """Held-out rating values (uncentered)."""
        return self.data.test.vals

    @property
    def mean_rating(self) -> float:
        """Training-set mean rating."""
        return float(self.data.mean_rating)

    @property
    def rating_range(self) -> tuple[float, float]:
        """(lo, hi) clip range."""
        return self.data.min_rating, self.data.max_rating


class DistributedBackend(Backend):
    """Shared machinery of the ring backends (paper §IV).

    ``prepare`` builds the ring (:func:`repro_torch.launch.mesh.bpmf_ring`:
    ``BackendConfig.num_shards`` shards over the visible cards, or on the
    CPU, or split over the processes of a job), distributes the data on the
    host and places each local shard's part on its device, with each ring
    step's Gram plan (decided from the autotune cache, and the fused
    layout where the plan is fused). The comm mode is the backend's name
    (``BPMFConfig.core``). State, accumulators and factors are per local
    shard; ``factors`` and ``accum_host`` undo the relabeling.
    """

    def prepare(self, coo: RatingsCOO | ChunkedRatings) -> None:
        """Partition, bucket per ring step, and place every local shard on its device.

        Across processes, or from a :class:`ChunkedRatings` stream, each
        process streams the ratings and builds only its own shards
        (:func:`repro_torch.core.distributed.build_distributed_data_per_host`);
        otherwise one build holds every shard. ``prepare_seconds`` records
        the host wall time of the host build (``"build"``) and of the
        placement with the step plans and their layouts (``"upload"``).

        Raises:
            ValueError: S is not a multiple of the job's process count.
        """
        self.ring = bpmf_ring(self.cfg.backend.num_shards, self.device)
        t0 = time.perf_counter()
        common = dict(
            num_shards=self.ring.num_shards,
            pads=self.cfg.backend.bucket_pads,
            test_fraction=self.cfg.run.test_fraction,
            seed=self.cfg.run.seed,
            strategy=self.cfg.backend.partition_strategy,
        )
        if self.ring.spans_processes or isinstance(coo, ChunkedRatings):
            chunked = coo if isinstance(coo, ChunkedRatings) else coo.chunked()
            host, self.plan = dist.build_distributed_data_per_host(
                chunked, local_shards=self.ring.local_shards, **common)
        else:
            host, self.plan = dist.build_distributed_data(coo, **common)
        t1 = time.perf_counter()
        self.data = dist.place_data(host, self.ring, self.core_cfg)
        self.prior = self.core_cfg.prior(self.ring.home)
        if self.ring.home.type == "cuda":
            torch.cuda.synchronize(self.ring.home)
        self.prepare_seconds = {"build": t1 - t0, "upload": time.perf_counter() - t1}
        self._prepared = True

    @property
    def num_shards(self) -> int:
        """Ring length S (over all processes)."""
        return self.ring.num_shards

    def init_state(self, key: torch.Tensor) -> dist.DistState:
        """Prior-predictive factor shards, rows keyed by original item id."""
        return dist.init_dist_state(key, self.data, self.core_cfg, self.ring)

    def _sweep(self, key, carry):
        """One sweep of :func:`repro_torch.core.distributed.dist_sweep_step`."""
        state, pred, accum, row = dist.dist_sweep_step(
            key, *carry, self.data, self.core_cfg, self.ring, self.prior
        )
        return (state, pred, accum), row

    def sweep(self, key: torch.Tensor, state, pred: PredictionState):
        """One eager sweep of :func:`repro_torch.core.distributed.dist_gibbs_sweep`."""
        return dist.dist_gibbs_sweep(key, state, pred, self.data, self.core_cfg, self.ring, self.prior)

    def _devices(self) -> list[torch.device]:
        return self.ring.distinct_devices()

    def factors(self, state) -> tuple[np.ndarray, np.ndarray]:
        """(U, V) on the host, in original item order."""
        return dist.gather_factors(state, self.plan)

    def init_accum(self) -> tuple[PosteriorAccum, ...]:
        """Zeroed accumulators, one per shard on its device."""
        return dist.init_dist_accum(
            self.data, self.core_cfg, self.ring, self.cfg.run.keep_factor_samples
        )

    def accum_host(self, accum) -> dict:
        """Host view of the per-shard accumulators, in original item order (:func:`accum_host_tree`'s schema).

        The shards are joined on the home device, so only the retained
        samples of the window cross to the host, not all ``keep`` slots.
        Across processes the joined blocks are gathered from every process
        (a collective), and every process gets the whole tree.
        """
        count = int(accum[0].count)

        def whole(name: str, idx: torch.Tensor | None = None) -> np.ndarray:
            parts = [getattr(a, name) if idx is None else getattr(a, name)[idx] for a in accum]
            dim = 0 if idx is None else 1
            local = torch.cat([p.to(self.home) for p in parts], dim=dim)
            if self.ring.spans_processes:
                local = torch.cat(self.ring.all_gather(local), dim=dim)
            return host_snapshot_leaf(local)

        u_order, v_order = self.plan.part_users.perm, self.plan.part_movies.perm
        U_sum, V_sum = _EMPTY_SUM, _EMPTY_SUM
        if count:
            U_sum, V_sum = whole("U_sum")[u_order], whole("V_sum")[v_order]
        slots = _window_slots(count, accum[0].keep, int(accum[0].filled))
        Us, Vs = _EMPTY_STACK, _EMPTY_STACK
        if slots.size:
            idx = torch.from_numpy(slots).to(self.home)
            Us, Vs = whole("U_window", idx)[:, u_order], whole("V_window", idx)[:, v_order]
        return {"U_sum": U_sum, "V_sum": V_sum, "count": np.asarray(count, np.int32),
                "U_samples": Us, "V_samples": Vs}

    def accum_from_host(self, tree: dict) -> tuple[PosteriorAccum, ...]:
        """Per-shard accumulators from a host tree: the rows go to their shard
        slots, and block d of the ``[S * cap, K]`` layout to local shard d's device."""
        S, keep, K = self.num_shards, self.cfg.run.keep_factor_samples, self.core_cfg.K
        cap_u, cap_v = self.data.users.cap, self.data.movies.cap
        whole = accum_from_host_tree(
            tree, PosteriorAccum.init(S * cap_u, S * cap_v, K, keep, "meta"),
            u_scatter=self.plan.part_users.perm, v_scatter=self.plan.part_movies.perm,
        )
        return tuple(
            dataclasses.replace(
                whole,
                U_sum=whole.U_sum[d * cap_u:(d + 1) * cap_u].to(dev),
                V_sum=whole.V_sum[d * cap_v:(d + 1) * cap_v].to(dev),
                count=whole.count.to(dev), filled=whole.filled.to(dev),
                U_window=whole.U_window[:, d * cap_u:(d + 1) * cap_u].to(dev),
                V_window=whole.V_window[:, d * cap_v:(d + 1) * cap_v].to(dev),
            )
            for d, dev in zip(self.ring.local_shards, self.ring.devices)
        )

    def state_host(self, state: dist.DistState) -> dict:
        """The shards' ``[cap, K]`` blocks concatenated in shard order (``[S * cap, K]``).

        Across processes U and V are this process's rows only, as
        :class:`~repro_torch.checkpoint.ShardedHostLeaf` pieces that each
        process writes itself; the replicated leaves are whole.
        """
        tree = convert.to_tree(dataclasses.replace(state, U=(), V=()))
        for name, cap in (("U", self.data.users.cap), ("V", self.data.movies.cap)):
            block = torch.cat([x.to(self.home) for x in getattr(state, name)])
            if self.ring.spans_processes:
                tree[name] = dist.LocalShardedArray(
                    block, self.num_shards * cap, self.ring.shard_offset * cap).host_leaf()
            else:
                tree[name] = host_snapshot_leaf(block)
        return tree

    def state_from_host(self, tree: dict) -> dist.DistState:
        """Split into S blocks; local shard d's block goes to its device, the hyper-parameters to :attr:`home`."""
        host = convert.dist_state_from_tree(tree, self.num_shards)
        local = self.ring.local_shards
        return dataclasses.replace(
            host,
            U=tuple(host.U[d].to(dev) for d, dev in zip(local, self.ring.devices)),
            V=tuple(host.V[d].to(dev) for d, dev in zip(local, self.ring.devices)),
            hyper_U=host.hyper_U.to(self.home), hyper_V=host.hyper_V.to(self.home),
            sweep=host.sweep.to(self.home),
        )

    @property
    def home(self) -> torch.device:
        """The ring's home device (shard 0's)."""
        return self.ring.home

    @property
    def num_test(self) -> int:
        """Number of held-out ratings."""
        return int(self.data.test.rows.shape[0])

    @property
    def test_vals(self) -> torch.Tensor:
        """Held-out rating values (uncentered)."""
        return self.data.test.vals

    @property
    def mean_rating(self) -> float:
        """Training-set mean rating."""
        return float(self.data.mean_rating)

    @property
    def rating_range(self) -> tuple[float, float]:
        """(lo, hi) clip range."""
        return self.data.min_rating, self.data.max_rating


@register_backend("ring")
class RingBackend(DistributedBackend):
    """Paper §IV-C: rotate the opposite shards around the ring, overlapped with the Gram."""


@register_backend("ring_async")
class AsyncRingBackend(DistributedBackend):
    """Depth-d pipelined ring (arXiv:1705.10633; DESIGN.md §7).

    Keeps ``BackendConfig.pipeline_depth`` rotations in flight instead of
    one; the samples are bit-identical to ``"ring"`` at every depth.
    """


@register_backend("allgather")
class AllGatherBackend(DistributedBackend):
    """Synchronous baseline: gather every opposite shard, then update locally."""


@register_backend("posterior_merge")
class PosteriorMergeBackend(Backend):
    """Independent partition chains and a subset-posterior merge (DESIGN.md §12).

    The limited-communication regime of arXiv:1703.00734 / 2004.02561: one
    global train/test split, users partitioned into
    ``BackendConfig.num_partitions`` chains by the ring's nnz cost model,
    and one independent chain of the sequential sampler per partition.
    In one process chain c sits on ring shard c's device (card ``c % n``
    of the n visible cards; with one card every chain shares it). In a job
    of P processes chain c belongs to process ``c % P`` (:attr:`_owner`),
    which alone builds and sweeps it on its device; the other processes
    hold ``None`` in its place. Chains exchange no bytes while they sample;
    their posteriors meet once, at export
    (:func:`repro_torch.core.subset_merge.merge_chain_trees`, by
    ``BackendConfig.merge_method``). Across processes the per-sweep metric
    rows and, at save and export, each chain's host trees come from their
    owners to every process (:meth:`_fetch`, :meth:`_global_rows`), in
    chain order.

    State, prediction and posterior accumulators are tuples of per-chain
    objects (checkpointed per chain, the posterior keyed ``chain_000``,
    ...). Chain c draws from ``fold_in(run_key, c)``, and user rows start
    from the sequential backend's rows of the same original ids.
    """

    exact_parity = False

    def prepare(self, coo: RatingsCOO | ChunkedRatings) -> None:
        """Partition the users, split once, and build and place each local chain's buckets.

        A :class:`ChunkedRatings` stream is materialized first (chains
        split users, not shards). ``prepare_seconds`` records the host wall
        time of the partition, split and per-chain builds (``"build"``)
        and of the placement (``"upload"``).

        Raises:
            ValueError: Fewer chains than processes.
        """
        t0 = time.perf_counter()
        if isinstance(coo, ChunkedRatings):
            coo = coo.materialize()
        bk = self.cfg.backend
        world = process_count()
        P = bk.num_partitions or min(bpmf_ring(0, self.device).num_shards, coo.num_users)
        if P < world:
            raise ValueError(f"num_partitions={P} leaves some of the {world} processes without a chain")
        self.user_sets = subset_merge.partition_users(coo, P, strategy=bk.partition_strategy)
        # one global split and centering, the sequential backend's, so the
        # backends compare inference and not data
        train, test = train_test_split(coo, self.cfg.run.test_fraction, self.cfg.run.seed)
        self._mean = float(train.vals.mean()) if train.nnz else 0.0
        self._range = (float(coo.vals.min()), float(coo.vals.max()))
        train_subs = subset_merge.split_by_users(train, self.user_sets)
        test_subs = subset_merge.split_by_users(test, self.user_sets)
        self._test_counts = [t.nnz for t in test_subs]
        self._test_vals = np.concatenate([np.asarray(t.vals, np.float32) for t in test_subs]) \
            if test_subs else np.zeros(0, np.float32)
        self._owner = [c % world for c in range(P)]
        self._local_chains = [c for c in range(P) if self._owner[c] == process_index()]
        host = {
            c: build_bpmf_data_presplit(
                subset_merge.localize_users(train_subs[c], self.user_sets[c]),
                subset_merge.localize_users(test_subs[c], self.user_sets[c]),
                pads=bk.bucket_pads,
                mean_rating=self._mean,
                min_rating=self._range[0],
                max_rating=self._range[1],
            )
            for c in self._local_chains
        }
        t1 = time.perf_counter()
        if world > 1:
            here = bpmf_ring(0, self.device).home
            self.devices = [here if c in host else None for c in range(P)]
        else:
            self.devices = list(bpmf_ring(P, self.device).devices)
        self.chain_data = [posterior.plan_data(host[c].to(self.devices[c]), self.core_cfg) if c in host else None
                           for c in range(P)]
        priors = {dev: self.core_cfg.prior(dev) for dev in dict.fromkeys(self._local_devices())}
        self.priors = [priors.get(dev) for dev in self.devices]
        if self.home.type == "cuda":
            torch.cuda.synchronize(self.home)
        self.prepare_seconds = {"build": t1 - t0, "upload": time.perf_counter() - t1}
        self._num_users, self._num_movies = coo.num_users, coo.num_movies
        self._prepared = True

    @property
    def num_partitions(self) -> int:
        """Number of chains C."""
        return len(self.user_sets)

    def checkpoint_leaves(self) -> tuple[tuple[str, tuple], ...]:
        """Per-chain state and prediction trees, the posterior keyed by chain."""
        return checkpoint_leaves(self.num_partitions)

    @property
    def home(self) -> torch.device:
        """The first local chain's device: the combined metrics live here."""
        return self.devices[self._local_chains[0]]

    def _local_devices(self) -> list[torch.device]:
        return [self.devices[c] for c in self._local_chains]

    def _fetch(self, host_tree, c: int):
        """Chain ``c``'s host tree (numpy leaves) on every process, from its owner.

        A collective across processes (every process calls it for every
        chain in the same order); the tree itself in one process.
        """
        if process_count() == 1:
            return host_tree
        box = [host_tree]
        torch.distributed.broadcast_object_list(box, src=self._owner[c])
        return box[0]

    def _global_rows(self, local_rows: dict[int, torch.Tensor]) -> list[torch.Tensor]:
        """Every chain's ``[B, 4]`` metric rows on :attr:`home`, in chain order.

        Across processes each process fills its own chains' rows of a
        ``[C, B, 4]`` block, the blocks are gathered, and chain c's rows
        are taken from its owner's block (an exact copy).
        """
        if process_count() == 1:
            return [local_rows[c] for c in range(self.num_partitions)]
        some = next(iter(local_rows.values()))
        block = torch.zeros((self.num_partitions,) + tuple(some.shape), dtype=some.dtype, device=self.home)
        for c, rows in local_rows.items():
            block[c] = rows.to(self.home)
        every = dist.all_gather_blocks(block)
        return [every[self._owner[c]][c] for c in range(self.num_partitions)]

    def init_state(self, key: torch.Tensor) -> tuple[BPMFState | None, ...]:
        """Per-chain prior-predictive states (``None`` for another process's chain).

        U rows are keyed by *original* user id (the sequential init's rows
        of the chain's users), and V is the same in every chain.
        """
        K, dt = self.core_cfg.K, self.core_cfg.sample_dtype
        ku, kv = prng.split(key)
        V = gibbs.init_rows(kv, torch.arange(self._num_movies, device=key.device), K).to(dt)
        states = []
        for c, (uids, dev) in enumerate(zip(self.user_sets, self.devices)):
            if dev is None:
                states.append(None)
                continue
            U = gibbs.init_rows(ku, torch.from_numpy(uids).to(key.device), K).to(dt)
            states.append(BPMFState(
                U=U.to(dev), V=V.to(dev),
                hyper_U=HyperParams.init(K, dt, dev), hyper_V=HyperParams.init(K, dt, dev),
                sweep=counter(0, dev),
            ))
        return tuple(states)

    def _combine_metric_rows(self, per_chain: list[torch.Tensor]) -> torch.Tensor:
        """``C`` per-chain ``[B, 4]`` metric rows to the ``[B, 4]`` global rows, on :attr:`home`.

        Each chain's RMSE covers its own (disjoint) test subset, so the
        global RMSE is the quadratic mean weighted by the subsets' sizes,
        ``sqrt(sum_c T_c rmse_c^2 / T)``, in float64 and summed in chain
        order as the JAX package does; a chain with no test rating reports
        NaN and weighs zero. The sweep column is chain 0's (chains run in
        lock-step); the ``bad`` column adds the chains' flags.
        """
        total = max(float(sum(self._test_counts)), 1.0)
        acc = None
        for T_c, rows in zip(self._test_counts, per_chain):
            term = float(T_c) * torch.nan_to_num(rows[:, :2].to(self.home, torch.float64)).square()
            acc = term if acc is None else acc + term
        sweep = per_chain[0][:, 2:3].to(self.home, torch.float64)
        bad = torch.stack([rows[:, 3:4].to(self.home, torch.float64) for rows in per_chain]).sum(dim=0)
        return torch.cat([torch.sqrt(acc / total), sweep, bad], dim=1).to(torch.float32)

    def _sweep(self, key, carry):
        """One sweep of every local chain, back to back, then the combined metrics row.

        On one card the whole of it, every chain and the combination, is
        one captured graph.
        """
        state, pred, accum = carry
        outs = {
            c: gibbs.sweep_step(
                subset_merge.chain_key(key, c).to(self.devices[c]), state[c], pred[c], accum.chains[c],
                self.chain_data[c], self.core_cfg, self.priors[c],
            )
            for c in self._local_chains
        }
        row = self._combine_metric_rows(self._global_rows({c: o[3][None] for c, o in outs.items()}))[0]
        C = range(self.num_partitions)
        carry = (
            tuple(outs[c][0] if c in outs else None for c in C),
            tuple(outs[c][1] if c in outs else None for c in C),
            MergeAccum(chains=tuple(outs[c][2] if c in outs else None for c in C)),
        )
        return carry, row

    def sweep(self, key: torch.Tensor, state, pred):
        """One eager sweep of every local chain (:func:`repro_torch.core.gibbs.gibbs_sweep`'s body) and the combined metrics.

        ``state`` and ``pred`` are the per-chain tuples; another process's
        chains stay ``None``.
        """
        outs = {
            c: gibbs._sweep_body(subset_merge.chain_key(key, c).to(self.devices[c]), state[c], pred[c],
                                 self.chain_data[c], self.core_cfg, self.priors[c])
            for c in self._local_chains
        }
        row = self._combine_metric_rows(self._global_rows({c: o[2][None] for c, o in outs.items()}))[0]
        C = range(self.num_partitions)
        return (
            tuple(outs[c][0] if c in outs else None for c in C),
            tuple(outs[c][1] if c in outs else None for c in C),
            SweepMetrics(*map(float, row[:3].cpu().numpy())),
        )

    def _devices(self) -> list[torch.device]:
        return self._local_devices()

    def factors(self, state) -> tuple[np.ndarray, np.ndarray]:
        """(U, V) of the current per-chain samples: U rows from their owning
        chain, V the mean of the chains' draws (a collective across processes)."""
        U = np.zeros((self._num_users, self.core_cfg.K), np.float32)
        Vs = []
        for c, (st, uids) in enumerate(zip(state, self.user_sets)):
            mine = None if st is None else (host_snapshot_leaf(st.U), host_snapshot_leaf(st.V))
            U_c, V_c = self._fetch(mine, c)
            U[uids] = U_c.astype(np.float32)
            Vs.append(V_c.astype(np.float32))
        return U, np.mean(np.stack(Vs), axis=0).astype(np.float32)

    def _accum_shaped(self, c: int, device) -> PosteriorAccum:
        return PosteriorAccum.init(
            len(self.user_sets[c]), self._num_movies, self.core_cfg.K,
            self.cfg.run.keep_factor_samples, device,
        )

    def init_accum(self) -> MergeAccum:
        """Zeroed per-chain accumulators, each on its chain's device (``None`` for another process's chain)."""
        return MergeAccum(chains=tuple(
            None if dev is None else self._accum_shaped(c, dev) for c, dev in enumerate(self.devices)))

    def init_pred(self) -> tuple[PredictionState | None, ...]:
        """Per-chain prediction accumulators over each chain's test subset."""
        return tuple(None if dev is None else PredictionState.init(n, dev)
                     for n, dev in zip(self._test_counts, self.devices))

    def accum_host(self, accum: MergeAccum) -> dict:
        """``{"chain_000": tree, ...}``, one :func:`accum_host_tree` per chain (a collective across processes)."""
        return {_chain_name(c): self._fetch(None if a is None else accum_host_tree(a), c)
                for c, a in enumerate(accum.chains)}

    def accum_from_host(self, tree: dict) -> MergeAccum:
        """Per-chain accumulators on their devices from an :meth:`accum_host` tree."""
        return MergeAccum(chains=tuple(
            None if dev is None
            else accum_from_host_tree(tree[_chain_name(c)], self._accum_shaped(c, "meta")).to(dev)
            for c, dev in enumerate(self.devices)
        ))

    def state_host(self, state) -> tuple[dict, ...]:
        """One state tree per chain (chain-local U rows; a collective across processes)."""
        return tuple(self._fetch(None if st is None else convert.to_tree(st), c) for c, st in enumerate(state))

    def state_from_host(self, tree) -> tuple[BPMFState | None, ...]:
        """Per-chain states on their devices; ``tree[c]`` is chain c's tree."""
        return tuple(None if dev is None else convert.state_from_tree(tree[c]).to(dev)
                     for c, dev in enumerate(self.devices))

    def pred_host(self, pred) -> tuple[dict, ...]:
        """One prediction tree per chain (a collective across processes)."""
        parent = super(PosteriorMergeBackend, self)
        return tuple(self._fetch(None if p is None else parent.pred_host(p), c) for c, p in enumerate(pred))

    def pred_from_host(self, tree) -> tuple[PredictionState | None, ...]:
        """Per-chain prediction accumulators on their devices."""
        return tuple(None if dev is None else convert.prediction_from_tree(tree[c]).to(dev)
                     for c, dev in enumerate(self.devices))

    def posterior_export(self, accum: MergeAccum) -> dict:
        """The backend's one communication event: every chain's accumulator
        to the host (on every process), merged
        (:func:`repro_torch.core.subset_merge.merge_chain_trees`)."""
        trees = self.accum_host(accum)
        return subset_merge.merge_chain_trees(
            [trees[_chain_name(c)] for c in range(self.num_partitions)],
            self.user_sets,
            self._num_users,
            method=self.cfg.backend.merge_method,
        )

    @property
    def num_test(self) -> int:
        """Number of held-out ratings, over all chains."""
        return sum(self._test_counts)

    @property
    def test_vals(self) -> torch.Tensor:
        """Held-out rating values of every chain's subset, in chain order (uncentered)."""
        return torch.from_numpy(self._test_vals).to(self.home)

    @property
    def mean_rating(self) -> float:
        """Global training-set mean rating."""
        return self._mean

    @property
    def rating_range(self) -> tuple[float, float]:
        """(lo, hi) clip range of all ratings."""
        return self._range


# --------------------------------------------------------------------------
# Legacy run loop (kept for repro_torch.core.gibbs.run)
# --------------------------------------------------------------------------


def run_sequential_prepared(
    key: torch.Tensor,
    data,
    core_cfg,
    callback=None,
) -> tuple[BPMFState, PredictionState, list[SweepMetrics]]:
    """The JAX package's pre-engine ``core.gibbs.run`` loop over built ``BPMFData``.

    ``core_cfg.num_sweeps`` blocks of one sweep through
    :func:`repro_torch.core.gibbs.gibbs_sweep_block` (eager, on ``data``'s
    device), so its samples equal an engine run's bit for bit at any block
    size; ``callback(state, metrics)`` after each sweep.
    """
    device = data.mean_rating.device
    k_init, k_run = prng.split(key)
    state = gibbs.init_state(k_init, data.num_users, data.num_movies, core_cfg)
    pred = PredictionState.init(data.test.rows.shape[0], device)
    accum = PosteriorAccum.init(data.num_users, data.num_movies, core_cfg.K, 0, device)
    prior = core_cfg.prior(device)
    history: list[SweepMetrics] = []
    for _ in range(core_cfg.num_sweeps):
        state, pred, accum, rows = gibbs.gibbs_sweep_block(k_run, state, pred, accum, data, core_cfg, 1, prior)
        metrics = SweepMetrics(*map(float, rows[0, :3].cpu().numpy()))
        history.append(metrics)
        if callback is not None:
            callback(state, metrics)
    return state, pred, history
