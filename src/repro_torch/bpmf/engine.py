"""``BPMFEngine`` — fit, sample and predict through one object::

    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset

    coo = load_dataset("synthetic", num_users=400, num_movies=300, nnz=12_000)
    engine = BPMFEngine(BPMFConfig().replace(K=16, num_sweeps=25)).fit(coo)
    print(engine.rmse)

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no CPU request it raises. On a GPU every Gram product of the sweep
goes through the hand-written CUDA kernel.

The sampler key derives from ``RunConfig.seed`` and per-sweep keys from
``(key, sweep)``, exactly as in the JAX package, so the same seed draws the
same normals in both. Sweeps run in blocks of ``RunConfig.sweeps_per_block``
with one host read of the block's metrics. ``save`` / ``restore`` /
``export`` come with the checkpoint slice (ROADMAP Queue 1 items 5 and 6).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.bpmf.backends import Backend, get_backend
from repro_torch.bpmf.config import BPMFConfig
from repro_torch.core import prng
from repro_torch.core.gibbs import SweepMetrics
from repro_torch.data.sparse import RatingsCOO
from repro_torch.serve.artifact import ArtifactMeta
from repro_torch.serve.predictor import PosteriorPredictor
from repro_torch.utils import resolve_device

_CHECKPOINT_ITEM = "ROADMAP Queue 1 items 5 and 6 (checkpoints, export and serving)"


class BPMFEngine:
    """Fit / sample / predict over a pluggable backend, on one device."""

    def __init__(self, cfg: BPMFConfig | None = None, device: str | torch.device | None = None):
        """Build an engine (and its backend) from a config.

        Args:
            cfg: Full engine config; ``None`` means all defaults.
            device: ``None`` or ``"cuda"`` runs on the GPU; ``"cpu"`` runs
                the plain PyTorch versions on the CPU.

        Raises:
            RuntimeError: No CUDA device and no CPU request.
            NotImplementedError: A checkpoint setting or a backend this port
                does not have yet.
        """
        self.cfg = cfg or BPMFConfig()
        if self.cfg.run.checkpoint_dir or self.cfg.run.checkpoint_every:
            raise NotImplementedError(f"checkpointing is not ported yet: {_CHECKPOINT_ITEM}")
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
        self._predictor: PosteriorPredictor | None = None
        self._predictor_sweep = -1
        keys = prng.split(prng.key(self.cfg.run.seed, self.device))
        self._k_init, self._k_run = keys[0], keys[1]

    def prepare(self, data: RatingsCOO) -> "BPMFEngine":
        """Host-side layout (split, center, bucket), uploaded to the device. Idempotent.

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

    def sample(self, data: RatingsCOO | None = None) -> Iterator[SweepMetrics]:
        """Stream per-sweep metrics from the current sweep to ``num_sweeps``.

        Sweeps run in blocks of ``RunConfig.sweeps_per_block``; a block's
        metrics are read from the device once, after the block.

        Yields:
            One :class:`SweepMetrics` (sample / posterior-mean RMSE, sweep
            index) per completed sweep, as host floats.
        """
        if data is not None:
            self.prepare(data)
        self._ensure_state()
        run = self.cfg.run
        while self._sweeps_done < run.num_sweeps:
            n = min(run.sweeps_per_block, run.num_sweeps - self._sweeps_done)
            self._state, self._pred, self._accum, rows = self.backend.sweep_block(
                self._k_run, self._state, self._pred, self._accum, n
            )
            self._sweeps_done += n
            block = [SweepMetrics(*map(float, r)) for r in rows.cpu().numpy()]
            self.history.extend(block)
            yield from block

    def fit(self, data: RatingsCOO | None = None) -> "BPMFEngine":
        """Run (or finish) all sweeps; returns ``self``."""
        for _ in self.sample(data):
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
        """Sweeps run so far."""
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

    def save(self, step: int | None = None) -> int:
        """Not ported yet (ROADMAP Queue 1 item 5)."""
        raise NotImplementedError(f"save is not ported yet: {_CHECKPOINT_ITEM}")

    def restore(self, data: RatingsCOO | None = None, step: int | None = None) -> int:
        """Not ported yet (ROADMAP Queue 1 item 5)."""
        raise NotImplementedError(f"restore is not ported yet: {_CHECKPOINT_ITEM}")

    def export(self, directory: str) -> str:
        """Not ported yet (ROADMAP Queue 1 item 6)."""
        raise NotImplementedError(f"export is not ported yet: {_CHECKPOINT_ITEM}")
