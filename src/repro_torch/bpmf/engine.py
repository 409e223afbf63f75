"""``BPMFEngine`` — fit, sample, predict, save, restore and export through one object::

    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset

    coo = load_dataset("synthetic", num_users=400, num_movies=300, nnz=12_000)
    engine = BPMFEngine(BPMFConfig().replace(K=16, num_sweeps=25)).fit(coo)
    print(engine.rmse)

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no CPU request it raises. On a GPU every Gram product of the sweep
goes through the hand-written CUDA kernel.

The sampler key derives from ``RunConfig.seed`` and per-sweep keys from
``(key, sweep)``, exactly as in the JAX package, so the same seed draws the
same normals in both, and a run restored from a checkpoint continues with
the randomness of an uninterrupted one. Sweeps run in blocks of
``RunConfig.sweeps_per_block``; on a GPU each block is the backend's
captured sweep replayed (:mod:`repro_torch.core.sweep_graph`), with no
host read inside. Blocks shrink to land on ``checkpoint_every``
boundaries, where the engine saves.

With ``RunConfig.pipeline_blocks = d > 1`` the loop is pipelined, as the
JAX package's is: up to ``d`` blocks are dispatched ahead of the metrics
drain. Each block's metrics start their copy to a pinned host buffer when
the block is dispatched, and the drain waits on that copy's event: the one
read of the block. Dispatch stops at ``checkpoint_every`` boundaries, and
``save``, ``export`` and ``restore`` drain the queue first. Samples,
metrics, checkpoints and artifacts are bit for bit the same at every
block size and depth.

Checkpoints and serving artifacts are the JAX package's files, leaf for
leaf: a checkpoint either package writes restores in the other, and so
does an artifact.

In a multi-process job (:mod:`repro_torch.launch.hostdevices`) every
process builds an engine with the same config and calls the same methods
in the same order: the sweeps, ``save``, ``restore``, ``factors`` and
``export`` are collectives. Each process holds its own shards or chains;
the metrics, the factors and the exported artifact are the same on every
process, and process 0 alone writes the artifact.

Each block read back leaves a :class:`repro_torch.trace.BlockRecord` in
``BPMFEngine.blocks`` (the last :data:`repro_torch.trace.BLOCK_RECORDS`):
its first sweep, and the phase clock of its last sweep. On a card that
clock is the captured graph's events, which the graph reads when the next
block is dispatched, while the card works on that block's plain replays
(or when ``blocks`` is read). A block still running when the next one
reaches its events (two or more blocks in flight) is unsampled.
``_dispatch`` and ``_drain_one`` are the host spans
``repro_torch: engine.dispatch`` and ``engine.drain``.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np
import torch

from repro_torch import trace
from repro_torch.bpmf.backends import Backend, get_backend
from repro_torch.bpmf.config import BPMFConfig
from repro_torch.checkpoint import CheckpointManager, CheckpointSchemaError
from repro_torch.core import prng
from repro_torch.core.gibbs import SweepMetrics
from repro_torch.data.sparse import ChunkedRatings, RatingsCOO
from repro_torch.launch.hostdevices import process_count, process_index
from repro_torch.serve.artifact import ArtifactMeta, save_artifact
from repro_torch.serve.predictor import PosteriorPredictor
from repro_torch.utils import resolve_device

def _flatten(tree: dict, table) -> dict[str, np.ndarray]:
    """The checkpoint leaves of a host tree, in the order of ``table``
    (:meth:`Backend.checkpoint_leaves`)."""
    out = {}
    for name, path in table:
        node = tree
        for part in path:
            node = node[part]
        out[name] = node
    return out


def _unflatten(leaves: dict[str, np.ndarray], table) -> dict:
    """The host tree of the leaves read (those of a subset of ``table``).

    A tuple index on a path becomes an int dict key, which the backends'
    ``*_from_host`` hooks index as they index a tuple.
    """
    tree: dict = {}
    for name, path in table:
        if name in leaves:
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaves[name]
    return tree


class BPMFEngine:
    """Fit / sample / predict / save / restore / export over a pluggable backend."""

    def __init__(self, cfg: BPMFConfig | None = None, device: str | torch.device | None = None):
        """Build an engine (and its backend) from a config.

        Args:
            cfg: Full engine config; ``None`` means all defaults.
            device: ``None`` or ``"cuda"`` runs on the GPU; ``"cpu"`` runs
                the plain PyTorch versions on the CPU.

        Raises:
            RuntimeError: No CUDA device and no CPU request.
            ValueError: A backend name not in the registry.
        """
        self.cfg = cfg or BPMFConfig()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the hyper-parameter statistics X.T @ X are plain float32
            # products; TF32 would cost them ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
        self.backend: Backend = get_backend(self.cfg, self.device)
        self.history: list[SweepMetrics] = []
        self._state = None
        self._pred = None
        self._accum = None
        self._sweeps_done = 0
        self._data_fingerprint: tuple[int, int, int] | None = None
        self._ckpt: CheckpointManager | None = None
        self._predictor: PosteriorPredictor | None = None
        self._predictor_sweep = -1
        # bytes of the metrics read back from the device, summed over the run
        self.host_metric_bytes = 0
        # seconds the host spent waiting for those reads, summed over the
        # run (the wait the pipelined dispatch queue exists to hide)
        self.host_blocked_s = 0.0
        # dispatched blocks whose metrics are not read yet: (rows, event,
        # first sweep, phase clock); rows is a host tensor, filled once the
        # event has completed
        self._inflight: deque[tuple[torch.Tensor, torch.cuda.Event | None, int, object]] = deque()
        # the blocks read back: (first sweep, sweeps, phase clock)
        self._blocks: deque[tuple[int, int, object]] = deque(maxlen=trace.BLOCK_RECORDS)
        keys = prng.split(prng.key(self.cfg.run.seed, self.device))
        self._k_init, self._k_run = keys[0], keys[1]

    def prepare(self, data: RatingsCOO | ChunkedRatings) -> "BPMFEngine":
        """Host-side layout (split, center, bucket), uploaded to the device. Idempotent.

        A :class:`ChunkedRatings` stream goes to the backend as it is: the
        ring backends build only this process's shards from it, the others
        materialize it.

        Raises:
            ValueError: ``data`` differs (by shape/nnz) from the dataset
                this engine was prepared for.
        """
        fingerprint = (data.num_users, data.num_movies, data.nnz)
        if self.backend.prepared:
            if fingerprint != self._data_fingerprint:
                raise ValueError(
                    f"engine already prepared for R {self._data_fingerprint}; "
                    f"got different data {fingerprint} — build a new BPMFEngine"
                )
            return self
        self.backend.prepare(data)
        self._data_fingerprint = fingerprint
        return self

    def _ensure_state(self) -> None:
        if not self.backend.prepared:
            raise RuntimeError("no data: call fit(data) / sample(data) / prepare(data) first")
        if self._state is None:
            self._state = self.backend.init_state(self._k_init)
            self._pred = self.backend.init_pred()
            self._accum = self.backend.init_accum()
            self._sweeps_done = 0

    def _manager(self) -> CheckpointManager:
        if self._ckpt is None:
            if not self.cfg.run.checkpoint_dir:
                raise ValueError("RunConfig.checkpoint_dir is not set")
            self._ckpt = CheckpointManager(
                self.cfg.run.checkpoint_dir,
                keep=self.cfg.run.keep_checkpoints,
                async_writes=self.cfg.run.async_checkpoint_writes,
            )
        return self._ckpt

    def _next_block_len(self) -> int:
        """Sweeps in the next block: ``sweeps_per_block``, shrunk so blocks
        land exactly on ``checkpoint_every`` boundaries and the final sweep
        (the partition never changes the samples)."""
        run = self.cfg.run
        n = min(run.sweeps_per_block, run.num_sweeps - self._sweeps_done)
        if run.checkpoint_every:
            n = min(n, run.checkpoint_every - self._sweeps_done % run.checkpoint_every)
        return max(n, 1)

    def _dispatch(self, n: int) -> None:
        """Issue a block of ``n`` sweeps and start its metrics copy to the host."""
        first = self._sweeps_done + 1
        with trace.span("engine.dispatch", sweep=first):
            self._state, self._pred, self._accum, rows = self.backend.sweep_block(
                self._k_run, self._state, self._pred, self._accum, n
            )
            event = None
            if rows.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(rows.device))
                rows = host
            self._inflight.append((rows, event, first, self.backend.phase_clock()))
            self._sweeps_done += n

    def _drain_one(self) -> None:
        """Read the oldest dispatched block's metrics into ``history``.

        The block's one host read: the wait on the event of the copy started
        at dispatch. A sweep whose row flags a non-finite hyper-parameter
        draw raises here.

        Raises:
            FloatingPointError: A sweep drew a non-finite Wishart precision
                (a gamma entry that no round of ``prng.GAMMA_ROUNDS``
                accepted, or a failed factorization).
        """
        rows, event, first, clock = self._inflight.popleft()
        with trace.span("engine.drain", sweep=first):
            with trace.span("engine.metrics_wait") as wait:
                if event is not None:
                    event.synchronize()
                rows = rows.numpy()
            self.host_blocked_s += wait.seconds
            self.host_metric_bytes += int(rows.nbytes)
            self._blocks.append((first, len(rows), clock))
        bad = [int(r[2]) for r in rows if r[3] != 0]
        if bad:
            raise FloatingPointError(
                f"sweeps {bad} drew a non-finite hyper-parameter precision (a gamma draw "
                f"with no accepted proposal in {prng.GAMMA_ROUNDS} rounds, or a failed factorization)"
            )
        self.history.extend(SweepMetrics(float(r[0]), float(r[1]), float(r[2])) for r in rows)

    @property
    def blocks(self) -> list[trace.BlockRecord]:
        """One :class:`repro_torch.trace.BlockRecord` per block read back (the newest last, at most
        :data:`repro_torch.trace.BLOCK_RECORDS`)."""
        return [trace.BlockRecord(first, n, *(clock.reading() if clock is not None else (None,) * 4))
                for first, n, clock in self._blocks]

    def _drain_inflight(self) -> None:
        """Read every dispatched block's metrics: the barrier of ``save``,
        ``export``, ``restore``, checkpoint boundaries and the run's end."""
        while self._inflight:
            self._drain_one()

    def sample(self, data: RatingsCOO | ChunkedRatings | None = None) -> Iterator[SweepMetrics]:
        """Stream per-sweep metrics from the current sweep to ``num_sweeps``.

        Resumable: after ``restore()`` the iterator continues where the
        checkpoint left off, drawing the randomness of an uninterrupted run.
        Sweeps run in blocks of ``RunConfig.sweeps_per_block``, and a
        block's metrics are read from the device once. With
        ``RunConfig.pipeline_blocks = d > 1`` up to ``d`` blocks are
        dispatched before the oldest one's metrics are read; the queue
        drains at ``checkpoint_every`` boundaries, where the engine saves
        before yielding, and at the end. The metrics of a block come
        together; abandoning the iterator leaves the engine at the end of
        the last dispatched block (``save``, ``export`` or the next
        ``sample`` drains the rest).

        Yields:
            One :class:`SweepMetrics` (sample / posterior-mean RMSE, sweep
            index) per completed sweep, as host floats.
        """
        if data is not None:
            self.prepare(data)
        self._ensure_state()
        run = self.cfg.run
        every = run.checkpoint_every
        depth = run.pipeline_blocks
        yielded = len(self.history)
        while self._sweeps_done < run.num_sweeps or self._inflight:
            # dispatch up to `depth` blocks ahead of the drain, stopping at a
            # checkpoint boundary so that save() snapshots that sweep's carry
            while self._sweeps_done < run.num_sweeps and len(self._inflight) < depth:
                self._dispatch(self._next_block_len())
                if every and self._sweeps_done % every == 0:
                    break
            at_ckpt = every and self._sweeps_done % every == 0
            final = self._sweeps_done >= run.num_sweeps
            keep = 0 if (at_ckpt or final) else depth - 1
            while len(self._inflight) > keep:
                self._drain_one()
            if at_ckpt:
                self.save()
            block = self.history[yielded:]
            yielded = len(self.history)
            yield from block

    def fit(self, data: RatingsCOO | ChunkedRatings | None = None, resume: bool = False) -> "BPMFEngine":
        """Run (or finish) all sweeps.

        Args:
            data: Ratings to ``prepare()`` first, if not already prepared.
            resume: Restore the latest checkpoint from
                ``RunConfig.checkpoint_dir`` (if any) before continuing.

        Returns:
            ``self``, with ``history`` / ``rmse`` / ``factors()`` populated.
        """
        if data is not None:
            self.prepare(data)
        if resume and self.cfg.run.checkpoint_dir and self._manager().latest() is not None:
            self.restore()
        for _ in self.sample():
            pass
        return self

    @property
    def rmse(self) -> float:
        """Posterior-mean test RMSE after the last completed sweep."""
        if not self.history:
            raise RuntimeError("no sweeps run yet")
        return float(self.history[-1].rmse_avg)

    @property
    def num_sweeps_done(self) -> int:
        """Sweeps dispatched so far (``restore()`` positions this at the checkpoint step).

        At ``pipeline_blocks > 1`` the metrics of the last blocks may still
        be in flight; ``save``, ``export`` and the end of ``sample`` drain them.
        """
        return self._sweeps_done

    @property
    def state(self):
        """The Gibbs state (``None`` before the first sweep)."""
        return self._state

    def factors(self) -> tuple[np.ndarray, np.ndarray]:
        """(U, V) of the current posterior sample, original item order."""
        self._ensure_state()
        return self.backend.factors(self._state)

    def predict(self, rows, cols, return_std: bool = False):
        """Posterior-mean predictions for arbitrary (user, movie) pairs.

        Uses the posterior-mean factors once post-burn-in samples exist;
        before that, the current sample's.

        Returns:
            ``[N]`` predicted ratings clipped to the training range, or
            ``(preds, std)`` when ``return_std``.
        """
        return self.predictor().predict(rows, cols, return_std=return_std)

    def predictor(self) -> PosteriorPredictor:
        """In-process predictor over the current posterior summary (cached per sweep)."""
        self._ensure_state()
        if self._predictor is None or self._predictor_sweep != self._sweeps_done:
            self._predictor = PosteriorPredictor.from_engine(self)
            self._predictor_sweep = self._sweeps_done
        return self._predictor

    def _artifact_payload(self) -> tuple[ArtifactMeta, dict[str, np.ndarray]]:
        """(meta, arrays) of the current posterior, in the JAX package's artifact schema."""
        self._ensure_state()
        summary = self.backend.posterior_export(self._accum)
        count = int(summary["count"])
        if count:
            U_mean, V_mean = summary["U_mean"], summary["V_mean"]
        else:
            U, V = self.factors()
            U_mean, V_mean = np.asarray(U, np.float32), np.asarray(V, np.float32)
        Us, Vs = summary["U_samples"], summary["V_samples"]
        if Us.shape[0] == 0:  # canonical empty shapes
            Us = np.zeros((0,) + U_mean.shape, np.float32)
            Vs = np.zeros((0,) + V_mean.shape, np.float32)
        lo, hi = self.backend.rating_range
        meta = ArtifactMeta(
            num_users=int(U_mean.shape[0]),
            num_movies=int(V_mean.shape[0]),
            K=int(U_mean.shape[1]),
            mean_rating=float(self.backend.mean_rating),
            min_rating=float(lo),
            max_rating=float(hi),
            num_mean_samples=count,
            num_kept_samples=int(Us.shape[0]),
            backend=self.cfg.backend.name,
            num_sweeps_done=self._sweeps_done,
            seed=self.cfg.run.seed,
        )
        return meta, {"U_mean": U_mean, "V_mean": V_mean, "U_samples": Us, "V_samples": Vs}

    def export(self, directory: str) -> str:
        """Write the versioned serving artifact of the current posterior.

        The JAX package's artifact (schema version 1): posterior-mean
        factors, the retained per-sweep samples, the mean rating, the clip
        range and the run's metadata, for
        :meth:`repro_torch.serve.PosteriorPredictor.load` or either
        package's serving CLIs to load without re-running MCMC. Blocks in
        flight drain first, and checkpoint writes still pending on the async
        writer commit first. In a multi-process job the payload is gathered
        by every process, process 0 writes it, and a barrier keeps the others
        from reading a half-written artifact.

        Args:
            directory: Artifact directory (replaced if it already holds one).

        Returns:
            The artifact directory.
        """
        self._drain_inflight()
        if self._ckpt is not None:
            self._ckpt.wait()
        meta, arrays = self._artifact_payload()
        if process_count() == 1:
            return save_artifact(directory, meta, arrays)
        if process_index() == 0:
            save_artifact(directory, meta, arrays)
        torch.distributed.barrier()
        return directory

    def save(self, step: int | None = None) -> int:
        """Checkpoint the state, the prediction accumulator, the posterior and the metric history.

        Blocks in flight drain first. Host copies of every leaf are taken before this returns (a CUDA
        tensor is copied on its device's current stream); with
        ``RunConfig.async_checkpoint_writes`` (the default) the files are
        written on the manager's background thread. The commit is atomic
        (tmp-dir rename, then ``LATEST`` replaced), so a crash mid-write
        never leaves a torn checkpoint visible. The file set, names, shapes
        and dtypes are the JAX package's; a ring saves its factor shards
        concatenated in shard order (``[S * cap, K]``).

        Args:
            step: Step to label the checkpoint with (default: the current sweep).

        Returns:
            The step the checkpoint was written at.
        """
        self._ensure_state()
        self._drain_inflight()
        step = self._sweeps_done if step is None else step
        hist = np.asarray(
            [[m.rmse_sample, m.rmse_avg, m.sweep] for m in self.history[:step]], np.float32
        ).reshape(-1, 3)
        tree = {
            "state": self.backend.state_host(self._state),
            "pred": self.backend.pred_host(self._pred),
            "history": hist,
            "posterior": self.backend.accum_host(self._accum),
        }
        self._manager().save(step, _flatten(tree, self.backend.checkpoint_leaves()))
        return step

    def restore(self, data: RatingsCOO | ChunkedRatings | None = None, step: int | None = None) -> int:
        """Load a checkpoint and position the run loop at its sweep count.

        Blocks in flight drain first. The backend must be prepared (pass ``data`` here or call
        ``prepare`` first). Metric history up to the checkpointed sweep is
        restored too, so ``rmse`` and ``history`` are complete even in a
        fresh process. A checkpoint without a ``posterior`` subtree (written
        before the JAX package's serving subsystem) still restores; the
        posterior accumulator then starts empty, so a later ``export()``
        reflects only the sweeps run after the resume.

        Args:
            data: Ratings to ``prepare()`` first, if not already prepared.
            step: Checkpoint step to load (default: latest).

        Returns:
            The restored sweep count.

        Raises:
            FileNotFoundError: No checkpoint at ``step`` (or none at all).
            CheckpointError: A damaged checkpoint, or one without the state.
        """
        if data is not None:
            self.prepare(data)
        if not self.backend.prepared:
            raise RuntimeError("no data: call restore(data) or prepare(data) first")
        self._drain_inflight()
        mgr = self._manager()
        step = mgr.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.cfg.run.checkpoint_dir}")
        table = self.backend.checkpoint_leaves()
        try:
            tree = _unflatten(mgr.restore([name for name, _ in table], step=step), table)
            accum = self.backend.accum_from_host(tree["posterior"])
        except CheckpointSchemaError:
            # no posterior subtree: restore the rest, start the accumulator
            # empty (a genuinely damaged checkpoint raises from this restore)
            rest = [name for name, path in table if path[0] != "posterior"]
            tree = _unflatten(mgr.restore(rest, step=step), table)
            accum = self.backend.init_accum()
        self._state = self.backend.state_from_host(tree["state"])
        self._pred = self.backend.pred_from_host(tree["pred"])
        self._accum = accum
        self._predictor, self._predictor_sweep = None, -1
        self._sweeps_done = step
        self.history = [SweepMetrics(float(r[0]), float(r[1]), float(r[2])) for r in tree["history"]]
        return step
