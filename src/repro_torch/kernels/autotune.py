"""Measured per-shape dispatch of the Gram ops on Hopper (the port of ``repro.kernels.autotune``).

Which Gram implementation wins for a ring step or a bucket depends on its
shape and on the card. This module owns that choice:

* :func:`decide` resolves a :class:`ShapeKey` to a :class:`Decision`: an
  exact cache hit first, :func:`heuristic` otherwise. The backends call it
  when they build their data, once per bucket and per (side, step, shard)
  of a ring, never inside a captured sweep (``ops.plan_step``,
  ``core/posterior.py:plan_side``).
* :func:`heuristic` never times anything. On a cold cache it gives the
  dispatch the port had before this module: on a CUDA key the fused kernel
  at ``pc = ops.FUSED_PC`` for a ring step and the per-bucket kernel with
  the ``piece_width`` rule for a bucket; off the card ``"xla"``, the plain
  version, as the JAX package's "not on TPU" branch does.
* :func:`measure_step` times every candidate for one step shape through
  the real dispatch path (``ops.bpmf_gram_step``) and records the winner.
  Run by ``benchmarks_torch/fig2_item_update.py``.
* :class:`AutotuneCache` persists the decisions as JSON in
  ``experiments/autotune/gram_cuda.json`` (the directory can be overridden
  with ``REPRO_TORCH_AUTOTUNE_DIR``). The JAX package's ``gram.json`` is
  never read or written here.

The decision space on Hopper:

* ``"pallas_fused"``: the fused ring-step kernel over the flattened chunk
  layout, with chunk width ``pc`` (candidates :data:`PC_CANDIDATES`);
* ``"pallas"``: the per-bucket kernel plus ``index_add_``, with the piece
  width ``piece`` (powers of two from ``MIN_PIECE_RATINGS`` to
  ``PIECE_RATINGS``; ``None`` is the ``piece_width`` rule);
* ``"xla"``: the plain PyTorch version, a decision for CPU keys only.
  ``ops.bpmf_gram`` refuses it on a CUDA tensor, and no CUDA key ever gets
  it: :meth:`AutotuneCache.lookup` ignores such an entry.

The JAX package's ``tb`` and ``ns_chunk`` and its VMEM model
(``_VMEM_BUDGET``, ``pick_tiling``, ``chunked_tiling``,
``vmem_bytes_estimate``) have no counterpart: the kernels gather X from
device memory and never hold a shard resident. K above ``MAX_K`` raises on
a CUDA key; there is no fallback.

Cache schema (``gram_cuda.json``)::

    {"version": 1,
     "entries": {"<key>": {"impl": "pallas_fused" | "pallas" | "xla",
                           "pc": 128, "piece": null,
                           "timings_us": {"pallas_fused_pc128": 12.3, ...},
                           "card": "NVIDIA H100 80GB HBM3, 700.00 W",
                           "source": "measured" | "recorded"}}}

Each entry records the card it was measured on (nvidia-smi's name and
power limit): a decision measured on one card says nothing of another.
Unknown versions and malformed files are ignored (heuristic fallback).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.balance import CostModel
from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.utils import device_line, logger, resolve_device, round_up

_CACHE_VERSION = 1
CACHE_FILE = "gram_cuda.json"
IMPLS = ("pallas_fused", "pallas", "xla")
# Chunk width of the fused layout. The JAX package sizes it from the TPU's
# VMEM budget; on Hopper the kernel stages 64 gathered [x | val] rows in
# shared memory at a time, and 128 = two such tiles keeps a chunk's
# neighbor ids and values in one 512-byte line each. It costs padding only
# in the layout, not in the kernel, which reads cnt[c] rows: a bucket with
# P < pc pads its rows to pc slots (8 bytes each). FUSED_PC is the width
# without a measurement; measure_step also tries one and four tiles.
FUSED_PC = 128
PC_CANDIDATES = (64, 128, 256)
PIECE_CANDIDATES = tuple(
    1 << i for i in range(gram_kernel.MIN_PIECE_RATINGS.bit_length() - 1,
                          gram_kernel.PIECE_RATINGS.bit_length())
)

_REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))


def _dtype_name(compute_dtype: torch.dtype) -> str:
    return str(compute_dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """Everything that changes which Gram implementation wins.

    ``kind`` is ``"bucket"`` (one ``[B, P]`` bucket, per-row output) or
    ``"step"`` (all buckets of one ring step, added into ``[cap, K, K]``).
    For step keys ``B`` is the total row count over the step's buckets and
    ``P`` the largest pad. ``backend`` is ``"cuda"`` or ``"cpu"``.
    """

    kind: str  # "bucket" | "step"
    B: int
    P: int
    Ns: int
    K: int
    dtype: str
    backend: str
    cap: int = 0  # step keys only: rows of the running sums

    def encode(self) -> str:
        """Stable string form used as the JSON cache key (the JAX package's format)."""
        s = f"{self.kind}_B{self.B}_P{self.P}_Ns{self.Ns}_K{self.K}_{self.dtype}_{self.backend}"
        return f"{s}_cap{self.cap}" if self.kind == "step" else s


@dataclasses.dataclass(frozen=True)
class Decision:
    """Resolved implementation for one :class:`ShapeKey`.

    ``impl`` is ``"pallas_fused"`` (one fused launch per step, chunk width
    ``pc``), ``"pallas"`` (the per-bucket kernel, piece width ``piece``;
    ``None`` = the ``piece_width`` rule) or ``"xla"`` (the plain version,
    CPU only).
    """

    impl: str
    pc: int | None = None
    piece: int | None = None


def bucket_key(B: int, P: int, Ns: int, K: int, compute_dtype: torch.dtype = torch.float32,
               backend: str = "cuda") -> ShapeKey:
    """Key of one per-bucket ``bpmf_gram`` dispatch."""
    return ShapeKey("bucket", B, P, Ns, K, _dtype_name(compute_dtype), backend)


def step_key(bucket_shapes: Sequence[tuple[int, int]], Ns: int, K: int, cap: int,
             compute_dtype: torch.dtype = torch.float32, backend: str = "cuda") -> ShapeKey:
    """Key of a whole ring step (``bucket_shapes``: each bucket's ``(B, P)``)."""
    B = sum(b for b, _ in bucket_shapes)
    P = max((p for _, p in bucket_shapes), default=0)
    return ShapeKey("step", B, P, Ns, K, _dtype_name(compute_dtype), backend, cap)


def workload_step_keys(data, K: int, compute_dtype: torch.dtype = torch.float32,
                       backend: str = "cuda") -> list[tuple[ShapeKey, list[tuple[int, int]]]]:
    """The engine's step keys for every (side, ring step, local shard) of a ring layout.

    ``ops.bpmf_gram_step`` sees a shard's bucket shapes at a step, ``Ns`` =
    the opposite side's shard capacity and ``cap`` = the updated side's.
    This derives the same keys from a ``DistBPMFData`` (the port's,
    host- or device-side), so entries recorded for them engage when the
    engine builds that layout. Shards share their bucket shapes at a step,
    so the keys of one (side, step) are equal.

    Returns:
        ``(key, bucket_shapes)`` per (side, step, local shard): the users
        side first, then steps, then shards; duplicates are not removed.
    """
    out: list[tuple[ShapeKey, list[tuple[int, int]]]] = []
    for side, opp in ((data.users, data.movies), (data.movies, data.users)):
        for per_step in side.steps:
            for buckets in per_step:
                shapes = [(int(b.B), int(b.P)) for b in buckets]
                out.append((step_key(shapes, opp.cap, K, side.cap, compute_dtype, backend), shapes))
    return out


# --------------------------------------------------------------------------
# Persistent cache
# --------------------------------------------------------------------------


def default_cache_dir() -> str:
    """``$REPRO_TORCH_AUTOTUNE_DIR`` or ``<repo>/experiments/autotune``."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE_DIR") or os.path.join(_REPO, "experiments", "autotune")


class AutotuneCache:
    """JSON-backed ``ShapeKey -> Decision`` store (see the module docstring)."""

    def __init__(self, path: str | None = None):
        self.path = path or os.path.join(default_cache_dir(), CACHE_FILE)
        self._entries: dict[str, dict] | None = None

    def entries(self) -> dict[str, dict]:
        """The entries, loaded at first use; a missing, malformed or old file loads as empty."""
        if self._entries is None:
            self._entries = {}
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                if isinstance(raw, dict) and raw.get("version") == _CACHE_VERSION \
                        and isinstance(raw.get("entries"), dict):
                    self._entries = dict(raw["entries"])
            except (OSError, ValueError):
                pass
        return self._entries

    def lookup(self, key: ShapeKey) -> Decision | None:
        """The exact key's decision, or ``None`` (the caller falls back to :func:`heuristic`).

        An entry that a dispatch of this key cannot take is ignored: an
        unknown ``impl``, ``"xla"`` on a CUDA key, or a fused decision
        on a bucket key.
        """
        e = self.entries().get(key.encode())
        if not isinstance(e, dict) or e.get("impl") not in IMPLS:
            return None
        if (e["impl"] == "xla" and key.backend == "cuda") or (e["impl"] == "pallas_fused" and key.kind != "step"):
            return None
        return Decision(e["impl"], e.get("pc"), e.get("piece"))

    def record(self, key: ShapeKey, decision: Decision, timings_us: dict[str, float] | None = None,
               source: str = "recorded", card: str | None = None, rejected: Sequence[str] = ()) -> None:
        """Insert or overwrite one entry and write the file at once.

        ``card`` names what the decision was measured on (default: the
        key's backend); ``rejected`` the candidates left out for missing
        the plain version's band.
        """
        entry: dict[str, Any] = {"impl": decision.impl, "pc": decision.pc, "piece": decision.piece,
                                 "source": source, "card": card or key.backend}
        if timings_us:
            entry["timings_us"] = {k: float(v) for k, v in timings_us.items()}
        if rejected:
            entry["rejected"] = sorted(rejected)
        self.entries()[key.encode()] = entry
        self.save()

    def save(self) -> None:
        """Write the cache file (creating its directory), through a temporary name."""
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _CACHE_VERSION, "entries": self.entries()}, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


_CACHE: AutotuneCache | None = None


def get_cache() -> AutotuneCache:
    """The process-wide cache (its path resolved at first use)."""
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache()
    return _CACHE


def set_cache(cache: AutotuneCache | None) -> None:
    """Replace the process-wide cache (``None`` resolves the path again at next use)."""
    global _CACHE
    _CACHE = cache


def load_fig2_cost_model(path: str | None = None) -> CostModel:
    """The :class:`~repro_torch.core.balance.CostModel` fitted by the port's fig2 benchmark, or the defaults.

    Reads ``experiments/bench_torch/fig2_item_update.json`` (never the JAX
    package's file, whose fit is of another machine) and falls back to
    ``CostModel()`` when the file is missing or malformed. The partitioner
    takes it as ``cost_model``; :func:`heuristic` does not consult it,
    since the choice it steers in the JAX package (its plain version
    against a kernel) does not exist on the card.
    """
    path = path or os.path.join(_REPO, "experiments", "bench_torch", "fig2_item_update.json")
    try:
        with open(path) as f:
            cm = json.load(f)["cost_model"]
        return CostModel(fixed=float(cm["fixed_us"]), per_rating=float(cm["per_rating_us"]))
    except (OSError, ValueError, KeyError, TypeError):
        return CostModel()


def heuristic(key: ShapeKey) -> Decision:
    """The decision without a cache entry; never times anything.

    Off the card ``"xla"``. On a CUDA key the port's dispatch without
    measurements: the fused kernel at ``pc = FUSED_PC`` for a step key, the
    per-bucket kernel with the ``piece_width`` rule for a bucket key.

    Raises:
        ValueError: K above the kernels' ``MAX_K`` on a CUDA key.
    """
    if key.backend != "cuda":
        return Decision("xla")
    if not 1 <= key.K <= gram_kernel.MAX_K:
        raise ValueError(f"the Gram kernels take 1 <= K <= {gram_kernel.MAX_K}, got K={key.K}")
    if key.kind == "step":
        return Decision("pallas_fused", pc=FUSED_PC)
    return Decision("pallas")


def decide(key: ShapeKey, cache: AutotuneCache | None = None) -> Decision:
    """A cache hit, else :func:`heuristic`."""
    hit = (cache or get_cache()).lookup(key)
    return hit if hit is not None else heuristic(key)


# --------------------------------------------------------------------------
# Measured sweep (the fig2 benchmark's workhorse)
# --------------------------------------------------------------------------


def candidates(backend: str) -> dict[str, Decision]:
    """Every decision :func:`measure_step` compares on ``backend``, by timing label."""
    out = {f"pallas_fused_pc{pc}": Decision("pallas_fused", pc=pc) for pc in PC_CANDIDATES}
    out["pallas"] = Decision("pallas")
    if backend == "cuda":  # off the card every piece width runs the same plain version
        out.update({f"pallas_piece{w}": Decision("pallas", piece=w) for w in PIECE_CANDIDATES})
    else:
        out["xla"] = Decision("xla")
    return out


def synthetic_step(bucket_shapes: Sequence[tuple[int, int]], Ns: int, K: int, cap: int,
                   device: torch.device, seed: int = 0):
    """Random, reproducible step data of a :func:`step_key` shape: ``(X, buckets)``.

    The JAX package's ``_synthetic_step``: row b of a ``(B, P)`` bucket has
    ``nnz`` uniform in ``[1, P]`` real neighbors, and the buckets' rows
    take consecutive destination rows modulo ``cap``.
    """
    from repro_torch.core.types import Bucket

    rng = np.random.default_rng(seed)
    buckets, slot = [], 0
    for B, P in bucket_shapes:
        nnz = rng.integers(1, P + 1, B).astype(np.int32)
        nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
        val = rng.normal(size=(B, P)).astype(np.float32)
        val[np.arange(P)[None, :] >= nnz[:, None]] = 0.0
        item_ids = ((slot + np.arange(B)) % cap).astype(np.int32)
        slot += B
        buckets.append(Bucket(*(torch.from_numpy(a).to(device) for a in (item_ids, nbr, val, nnz))))
    X = torch.from_numpy(rng.normal(size=(Ns, K)).astype(np.float32)).to(device)
    return X, tuple(buckets)


def step_band(G, g, Gw, gw, buckets, alpha: float) -> float:
    """How far ``(G, g)`` lies from the plain ``(Gw, gw)`` of one step from zero sums, in allowances.

    The bands of the card tests and ``chip_smoke.py``: entry (i, j) of a
    row may be off by ``16 eps sqrt(n) sqrt(Gw_ii Gw_jj)`` and g by
    ``16 eps sqrt(n) sqrt(Gw_ii alpha sum val^2)``, where n is the most
    ratings one row has in the step. At most 1.0 is within the band; a
    non-finite output is ``inf``.
    """
    if not (torch.isfinite(G).all() and torch.isfinite(g).all()):
        return math.inf
    count = torch.zeros(Gw.shape[0], dtype=torch.float64, device=Gw.device)
    v2 = torch.zeros_like(count)
    for b in buckets:
        live = b.item_ids >= 0
        rows = b.item_ids[live].long()
        count.index_add_(0, rows, b.nnz[live].double())
        v2.index_add_(0, rows, (b.val[live].double() ** 2).sum(1))
    tol = 16 * torch.finfo(torch.float32).eps * math.sqrt(max(float(count.max()), 1.0))
    d = torch.diagonal(Gw, dim1=1, dim2=2).clamp_min(0).double()
    scale_G = tol * (d[:, :, None] * d[:, None, :]).sqrt() + 1e-30
    scale_g = tol * (d * alpha * v2[:, None]).sqrt() + 1e-30
    return max(float(((G - Gw).abs() / scale_G).max()), float(((g - gw).abs() / scale_g).max()))


def _replayed(fn: Callable[[], Any], device: torch.device) -> Callable[[], None]:
    """``fn`` captured once as a CUDA graph: a callable that replays it.

    The ring runs its steps inside a captured sweep, so a step is timed as
    a replay, without the host's launch costs. The Gram wrappers count a
    launch at the call, which under capture is once per capture: the
    capture's counts are taken off and added back at each replay, as
    ``core/sweep_graph.py`` does.
    """
    from repro_torch.core.sweep_graph import LAUNCH_COUNTERS, launch_counts

    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    torch.cuda.synchronize(device)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    torch.cuda.synchronize(device)
    per_replay = {name: getattr(gram_kernel, name) - before[name] for name in LAUNCH_COUNTERS}
    for name, n in before.items():
        setattr(gram_kernel, name, n)

    def replay() -> None:
        graph.replay()
        for name, n in per_replay.items():
            setattr(gram_kernel, name, getattr(gram_kernel, name) + n)

    return replay  # holds the graph, and so its memory pool


def time_us(fns: dict[str, Callable[[], Any]], device: torch.device, iters: int) -> dict[str, float]:
    """Median microseconds per call of each function, the functions called round-robin.

    On a CUDA device each function is captured as a CUDA graph and each
    replay timed by CUDA events; on the CPU each call by the host clock.
    Round-robin order spreads drift of the machine over every candidate.
    """
    samples: dict[str, list[float]] = {label: [] for label in fns}
    if device.type == "cuda":
        runs = {label: _replayed(fn, device) for label, fn in fns.items()}
        for _ in range(max(iters, 1)):
            for label, run in runs.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                samples[label].append(1e3 * start.elapsed_time(end))
    else:
        for fn in fns.values():
            fn()  # warm-up
        for _ in range(max(iters, 1)):
            for label, fn in fns.items():
                t0 = time.perf_counter()
                fn()
                samples[label].append(1e6 * (time.perf_counter() - t0))
    return {label: float(np.median(ts)) for label, ts in samples.items()}


def measure_step(
    bucket_shapes: Sequence[tuple[int, int]],
    Ns: int,
    K: int,
    cap: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
    alpha: float = 2.0,
    iters: int = 5,
    labels: Sequence[str] | None = None,
    cache: AutotuneCache | None = None,
    device: str | torch.device | None = None,
) -> tuple[Decision, dict[str, float]]:
    """Time the candidates of one step shape and record the fastest into the cache.

    Builds :func:`synthetic_step` data and runs every candidate
    (:func:`candidates`) through the real dispatch path,
    ``ops.bpmf_gram_step`` with the candidate's :class:`~repro_torch.kernels.ops.StepPlan`.
    A candidate is timed only after its output, from zero sums, lies within
    :func:`step_band` of the plain version's (the fused kernel's plain
    version, which contracts in float64); one that does not is left out and
    named in the log and in the entry's ``"rejected"``. Then the candidates
    run round-robin and the median of each decides (:func:`time_us`).

    Args:
        bucket_shapes: Each bucket's ``(B, P)``.
        Ns: Rows of the opposite shard.
        K: Latent rank.
        cap: Rows of the running sums (default: the total B, rounded up to 8).
        compute_dtype: Gram input rounding.
        alpha: Rating noise precision.
        iters: Timed calls per candidate.
        labels: A subset of :func:`candidates`' labels (default: all).
        cache: Cache to record into (default: :func:`get_cache`).
        device: Where to measure (default: the card).

    Returns:
        The winning :class:`Decision` and every admitted candidate's median
        µs. The winner is recorded unless a measured entry for the same key
        compared more candidates (a narrow re-run never overwrites a fuller
        one).

    Raises:
        RuntimeError: No candidate matched the plain version.
    """
    from repro_torch.kernels import ops

    device = resolve_device(device)
    total_B = sum(b for b, _ in bucket_shapes)
    cap = cap or round_up(max(total_B, 1), 8)
    key = step_key(bucket_shapes, Ns, K, cap, compute_dtype, device.type)
    X, buckets = synthetic_step(bucket_shapes, Ns, K, cap, device)
    pool = candidates(device.type)
    chosen = {label: pool[label] for label in (labels or pool)}

    def zeros():
        return (torch.zeros(cap, K, K, dtype=torch.float32, device=device),
                torch.zeros(cap, K, dtype=torch.float32, device=device))

    want = gram_kernel.bpmf_gram_fused_plain(*zeros(), X, *ops.flatten_step(buckets, FUSED_PC, ops.FUSED_TB),
                                             alpha, compute_dtype)
    fns, rejected = {}, {}
    for label, dec in chosen.items():
        plan = ops.StepPlan.for_decision(dec, buckets)
        G, g = ops.bpmf_gram_step(*zeros(), X, buckets, alpha=alpha, compute_dtype=compute_dtype, plan=plan)
        band = step_band(G, g, *want, buckets, alpha)
        if band > 1.0:
            rejected[label] = band
            continue
        G, g = zeros()
        fns[label] = (lambda G=G, g=g, plan=plan: ops.bpmf_gram_step(
            G, g, X, buckets, alpha=alpha, compute_dtype=compute_dtype, plan=plan))
    if rejected:
        logger.warning("measure_step %s: left out, outside the plain version's band: %s", key.encode(), rejected)
    if not fns:
        raise RuntimeError(f"no candidate of {key.encode()} matched the plain version: {rejected}")
    timings = time_us(fns, device, iters)
    best_label = min(timings, key=timings.get)
    best = chosen[best_label]
    store = cache or get_cache()
    prev = store.entries().get(key.encode())
    if not (isinstance(prev, dict) and prev.get("source") == "measured"
            and len(prev.get("timings_us", {})) > len(timings)):
        store.record(key, best, timings_us=timings, source="measured", card=device_line(device),
                     rejected=list(rejected))
    return best, timings
