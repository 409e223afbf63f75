"""``PosteriorPredictor`` — posterior-mean serving on one device.

Loads an exported artifact (or an engine's in-memory posterior) and answers
rating queries without touching the sampler:

* :meth:`PosteriorPredictor.predict` — batched ``(user, movie)`` point
  predictions from the posterior-mean factors, optionally with the
  predictive std over the retained per-sweep samples;
* :meth:`PosteriorPredictor.top_k` — per-user catalog scoring + top-k.

The factors are small next to query traffic, so they sit whole on one
device, and ``top_k`` scans the whole catalog there (the JAX package's
replicated mode), or, item-sharded, scans ``V`` split along the item axis
over a list of serve devices and merges the shards' candidates on the host
(:mod:`repro_torch.serve.sharded_topk`; :func:`serve_devices` puts shard i
on card ``i % n``, so on one card every shard shares it).

Every score is summed over K in one fixed order, ``k = 0, 1, ..., K - 1``,
by one elementwise product and one add per ``k``, and the predictive std
over the samples likewise. An elementwise kernel treats each entry alike
whatever the tensor's size, whereas a matrix product or a reduction kernel
may pick another algorithm, and so another sum order, for another batch
size. So an answer has the same bits whether its request runs alone or
coalesced with others (the server's micro-batches). Ties in ``top_k`` go
to the lower item id, the rule of :func:`repro_torch.serve.sharded_topk.merge_topk`;
``torch.topk`` promises no order among ties, so the scores go through a
stable descending sort instead.

Each replicated ``top_k`` call leaves a :class:`repro_torch.trace.CallRecord`
in ``PosteriorPredictor.calls`` (the last :data:`repro_torch.trace.CALL_RECORDS`):
the milliseconds of its scores with the clamp, its sort and its host copy.
On the CPU they are the host spans ``repro_torch: predictor.score``,
``predictor.sort`` and ``predictor.copy``. On a card they are four CUDA
events a call (:class:`_CallTimer`, one per thread, two sets by turns):
a call's events are read during the thread's next call, once that call's
score kernels are queued, or when ``calls`` is read, so no read waits on
the host's path between a call's copy and the next call's kernels.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque

import numpy as np
import torch

from repro_torch import trace
from repro_torch.serve.artifact import ArtifactMeta, load_artifact
from repro_torch.serve.sharded_topk import build_local_topk, merge_topk, shard_items
from repro_torch.utils import resolve_device

_TOPK_MODES = ("auto", "replicated", "sharded")
_AUTO_SHARD_MIN_ITEMS = 1024  # topk_mode="auto": shard catalogs at least this big


def serve_devices(num_shards: int = 0, device: torch.device | str | None = None) -> list[torch.device]:
    """The devices of an item-sharded top-k (the port of ``serve_mesh``): shard i on card ``i % n``.

    Args:
        num_shards: Item shards S; 0 means one per visible card (one on the
            CPU).
        device: ``None`` or ``"cuda"`` spreads the shards over the visible
            cards, ``"cuda:i"`` keeps them on card i, ``"cpu"`` on the CPU.

    Raises:
        RuntimeError: CUDA asked for and no card is visible.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (num_shards or 1)
    cards = [dev] if dev.index is not None else [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(num_shards or len(cards))]


def _dot_k(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k] * b[..., k]`` (broadcasting), in the fixed order k = 0, 1, ..."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def _catalog_scores(u: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` dot products of the users ``u [B, K]`` with every item of ``Vt [K, N]``, as :func:`_dot_k` sums."""
    acc = u[:, 0:1] * Vt[0]
    for k in range(1, u.shape[-1]):
        acc = acc + u[:, k:k + 1] * Vt[k]
    return acc


def _std0(x: torch.Tensor) -> torch.Tensor:
    """Population std over dim 0, summed in the order s = 0, 1, ..."""
    n = x.shape[0]
    mean = x[0]
    for s in range(1, n):
        mean = mean + x[s]
    mean = mean / n
    var = (x[0] - mean) ** 2
    for s in range(1, n):
        var = var + (x[s] - mean) ** 2
    return torch.sqrt(var / n)


class _CallTimer:
    """One thread's CUDA events for its top-k calls: start, after the scores, after the sort, after the copy.

    Two sets of four, by turns: a call records into one while the other
    holds the previous call's, which :meth:`take` reads (its last event was
    recorded after that call's host copy returned, so it is complete or
    nearly). The events go on the stream that was current when the thread
    first called; a call made on another stream keeps no record, and the
    next call uses that stream.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.current_stream(device)
        self.sets = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(2)]
        self.turn = 0
        self.valid = True
        self.pending: tuple[int, int, list[torch.cuda.Event]] | None = None
        self.lock = threading.Lock()

    def mark(self, i: int) -> None:
        if i == 0:  # the set's first record waits for a read of it on another thread
            with self.lock:
                self.sets[self.turn][0].record(self.stream)
        else:
            self.sets[self.turn][i].record(self.stream)

    def check_stream(self) -> None:
        """Off the host's critical path: whether this call's kernels run on the events' stream."""
        stream = torch.cuda.current_stream(self.device)
        if stream != self.stream:
            self.stream, self.valid = stream, False

    def finish(self, call: int, users: int) -> None:
        """This call's events are recorded: keep them for :meth:`take`; the next call takes the other set."""
        if self.valid:
            with self.lock:
                self.pending = (call, users, self.sets[self.turn])
            self.turn ^= 1
        self.valid = True

    def take(self) -> trace.CallRecord | None:
        """The record of the call whose events are kept, if any."""
        with self.lock:
            pending, self.pending = self.pending, None
            if pending is None:
                return None
            call, users, events = pending
            events[3].synchronize()
            return trace.CallRecord(call, users, "device", *(a.elapsed_time(b) for a, b in zip(events, events[1:])))


class PosteriorPredictor:
    """Answer rating queries from a BPMF posterior summary.

    Construction paths: :meth:`load` (from an artifact on disk, the serving
    process) and :meth:`from_engine` (from a live engine's posterior, no
    disk round trip; what ``BPMFEngine.predict`` delegates to).
    """

    def __init__(
        self,
        meta: ArtifactMeta,
        arrays: dict[str, np.ndarray],
        device: torch.device | str | None = None,
        topk_mode: str = "auto",
        item_devices: list[torch.device] | None = None,
    ):
        """Place the posterior summary on ``device``.

        Args:
            meta: Shapes, clip range and mean rating.
            arrays: ``U_mean``/``V_mean``/``U_samples``/``V_samples`` host
                arrays in the shapes ``meta`` promises.
            device: ``None`` or ``"cuda"`` serves from the GPU; ``"cpu"``
                from the CPU.
            topk_mode: Default ``top_k`` execution: ``"replicated"`` (the
                catalog scan on ``device``), ``"sharded"`` (the item-sharded
                scan over ``item_devices`` and the host merge) or ``"auto"``
                (sharded when there is more than one item shard and the
                catalog has at least 1,024 items). ``top_k(...,
                sharded=...)`` overrides it per call.
            item_devices: One device per item shard
                (:func:`serve_devices`); ``None`` means one per visible card
                (one on the CPU).

        Raises:
            ValueError: An unknown ``topk_mode``.
            RuntimeError: No CUDA device and no CPU request.
        """
        if topk_mode not in _TOPK_MODES:
            raise ValueError(f"topk_mode must be auto|replicated|sharded, got {topk_mode!r}")
        self.meta = meta
        self.topk_mode = topk_mode
        self.device = resolve_device(device)
        self.item_devices = list(item_devices) if item_devices is not None else serve_devices(0, self.device)
        self._local_topk = None
        if self.device.type == "cuda":
            # float32 products throughout, in a serving process too
            torch.backends.cuda.matmul.allow_tf32 = False

        def put(name: str) -> torch.Tensor:
            return torch.from_numpy(np.asarray(arrays[name], np.float32)).to(self.device)

        self._U, self._V = put("U_mean"), put("V_mean")
        self._Vt = self._V.T.contiguous()  # [K, N]: row k is contiguous for the catalog scan
        self._Us, self._Vs = put("U_samples"), put("V_samples")
        self._mean = torch.tensor(meta.mean_rating, dtype=torch.float32, device=self.device)
        # one record per replicated top-k call, the newest last
        self._calls: deque[trace.CallRecord] = deque(maxlen=trace.CALL_RECORDS)
        self._call_index = itertools.count()
        self._per_thread = threading.local()  # each thread's _CallTimer on a card
        self._timers: list[_CallTimer] = []
        self._timers_lock = threading.Lock()

    @classmethod
    def load(
        cls, directory: str, device: torch.device | str | None = None, topk_mode: str = "auto",
        item_devices: list[torch.device] | None = None,
    ) -> "PosteriorPredictor":
        """Load a predictor from an artifact directory (either package's export).

        Args:
            directory: Artifact directory.
            device: ``None`` or ``"cuda"`` for the GPU, ``"cpu"`` for the CPU.
            topk_mode, item_devices: See :meth:`__init__`.

        Raises:
            ArtifactError: Typed load failure (:mod:`repro_torch.serve.artifact`).
        """
        meta, arrays = load_artifact(directory)
        return cls(meta, arrays, device, topk_mode=topk_mode, item_devices=item_devices)

    @classmethod
    def from_engine(cls, engine) -> "PosteriorPredictor":
        """A predictor over a live engine's current posterior summary, on its device.

        Bit for bit what a save and :meth:`load` of the engine's export gives.
        """
        meta, arrays = engine._artifact_payload()
        return cls(meta, arrays, engine.device)

    @property
    def num_kept_samples(self) -> int:
        """Retained per-sweep factor samples (0 disables predictive std)."""
        return int(self._Us.shape[0])

    def _queries(self, ids, limit: int, what: str) -> torch.Tensor:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= limit):
            raise ValueError(
                f"{what} ids must be in [0, {limit}), got range [{ids.min()}, {ids.max()}]"
            )
        return torch.from_numpy(ids).to(self.device)

    def predict(self, rows, cols, return_std: bool = False):
        """Batched point predictions for ``(user, movie)`` pairs.

        Args:
            rows: ``[B]`` user ids (original numbering).
            cols: ``[B]`` movie ids (original numbering).
            return_std: Also return the predictive std over the retained
                factor samples.

        Returns:
            ``[B]`` float32 predictions clipped to the training range, or
            ``(preds, std)`` when ``return_std``.

        Raises:
            ValueError: Mismatched batch shapes, out-of-range ids, or
                ``return_std`` with no retained samples.
        """
        r = self._queries(rows, self.meta.num_users, "user")
        c = self._queries(cols, self.meta.num_movies, "movie")
        if r.shape != c.shape:
            raise ValueError(f"rows/cols batch mismatch: {tuple(r.shape)} vs {tuple(c.shape)}")
        if return_std and self.num_kept_samples == 0:
            raise ValueError(
                "predictive std needs retained factor samples; this artifact was exported "
                "with num_kept_samples=0 (RunConfig.keep_factor_samples)"
            )
        lo, hi = self.meta.min_rating, self.meta.max_rating
        preds = (_dot_k(self._U[r], self._V[c]) + self._mean).clamp(lo, hi)
        if not return_std:
            return preds.cpu().numpy()
        per_sample = (_dot_k(self._Us[:, r], self._Vs[:, c]) + self._mean).clamp(lo, hi)
        return preds.cpu().numpy(), _std0(per_sample).cpu().numpy()

    def _use_sharded_topk(self, sharded: bool | None) -> bool:
        if sharded is not None:
            return bool(sharded)
        if self.topk_mode == "auto":
            return len(self.item_devices) > 1 and self.meta.num_movies >= _AUTO_SHARD_MIN_ITEMS
        return self.topk_mode == "sharded"

    def _top_k_sharded(self, users: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Each item shard's top-k on its device, merged on the host (:mod:`repro_torch.serve.sharded_topk`)."""
        if self._local_topk is None:
            shards = shard_items(self._V, self.item_devices)
            self._local_topk = build_local_topk(shards, self.meta.num_movies, _catalog_scores)
        lo, hi = self.meta.min_rating, self.meta.max_rating
        cand_ids, cand_vals = self._local_topk(self._U[users], self._mean, k, lo, hi)
        return merge_topk(cand_ids, cand_vals, k)

    def top_k(self, user, k: int, sharded: bool | None = None):
        """Highest-scoring movies for one user (or a batch of users).

        Args:
            user: A user id, or a ``[B]`` array of user ids.
            k: Number of movies to return (clamped to the catalog size).
            sharded: Force the item-sharded (``True``) or the replicated
                (``False``) scan; ``None`` follows ``topk_mode``. Both give
                the same ids and scores, bit for bit.

        Returns:
            ``(ids, scores)`` — ``[k]`` arrays for a scalar ``user``, ``[B, k]``
            for a batch. Scores are clipped predicted ratings; ties go to the
            lower item id.

        Raises:
            ValueError: Out-of-range user ids or ``k < 1``.
        """
        if k < 1:
            raise ValueError(f"top_k needs k >= 1, got {k}")
        k = min(int(k), self.meta.num_movies)
        scalar = np.ndim(user) == 0
        users = self._queries(np.atleast_1d(np.asarray(user)), self.meta.num_users, "user")
        if self._use_sharded_topk(sharded):
            ids, vals = self._top_k_sharded(users, k)
        else:
            ids, vals = self._top_k_replicated(users, k)
        return (ids[0], vals[0]) if scalar else (ids, vals)

    @property
    def calls(self) -> deque[trace.CallRecord]:
        """One :class:`repro_torch.trace.CallRecord` per replicated top-k call (the newest last, at most
        :data:`repro_torch.trace.CALL_RECORDS`); reading it reads the events still kept."""
        for timer in list(self._timers):
            record = timer.take()
            if record is not None:
                self._calls.append(record)
        return self._calls

    def _timer(self) -> _CallTimer | None:
        """This thread's :class:`_CallTimer` on a card (made once), ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        timer = getattr(self._per_thread, "timer", None)
        if timer is None:
            timer = self._per_thread.timer = _CallTimer(self.device)
            with self._timers_lock:
                self._timers.append(timer)
        return timer

    def _top_k_replicated(self, users: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
        """The catalog scan on :attr:`device`, its scores, sort and host copy timed into :attr:`calls`."""
        call = next(self._call_index)
        timer = self._timer()
        lo, hi = self.meta.min_rating, self.meta.max_rating
        if timer:
            timer.mark(0)
        with trace.span("predictor.score", call=call) as score:
            scores = (_catalog_scores(self._U[users], self._Vt) + self._mean).clamp(lo, hi)
            if timer:
                timer.mark(1)
                # the card works on the scores: read the previous call's events now
                previous = timer.take()
                if previous is not None:
                    self._calls.append(previous)
                timer.check_stream()
        with trace.span("predictor.sort", call=call) as sort:
            vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
            if timer:
                timer.mark(2)
        with trace.span("predictor.copy", call=call) as copy:
            ids = ids[:, :k].to(torch.int32).cpu().numpy()
            vals = vals[:, :k].cpu().numpy()
            if timer:
                timer.mark(3)
        if timer:
            timer.finish(call, len(users))
        else:
            self._calls.append(trace.CallRecord(call, len(users), "host",
                                                *(1e3 * s.seconds for s in (score, sort, copy))))
        return ids, vals


class PredictorHandle:
    """Atomically swappable reference to the live :class:`PosteriorPredictor`.

    The server's hot-swap primitive: request handlers read the current
    predictor once per coalesced batch, and :meth:`swap` replaces it with
    one reference assignment (atomic under the interpreter lock), so every
    batch runs against one posterior and no request sees a half-loaded
    artifact (the new predictor is built before the swap).
    """

    def __init__(self, predictor: PosteriorPredictor):
        """Wrap the initial predictor at generation 0."""
        self._current: tuple[PosteriorPredictor, int] = (predictor, 0)

    @property
    def generation(self) -> int:
        """Completed swaps (0 = the artifact the server started with)."""
        return self._current[1]

    def get(self) -> PosteriorPredictor:
        """The live predictor (one atomic read: call once per batch)."""
        return self._current[0]

    def get_with_generation(self) -> tuple[PosteriorPredictor, int]:
        """Consistent ``(predictor, generation)`` pair in one atomic read."""
        return self._current

    def swap(self, predictor: PosteriorPredictor) -> int:
        """Atomically publish a new, fully built predictor; returns the new generation."""
        gen = self._current[1] + 1
        self._current = (predictor, gen)
        return gen
