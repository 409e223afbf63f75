"""Engine configuration: the model / run / backend split.

The same three dataclasses as ``repro.bpmf.config``, with the same fields
and checks, so a configuration carries over:

  * :class:`ModelConfig`   — the statistical model (paper §III)
  * :class:`RunConfig`     — schedule, data split, checkpointing
  * :class:`BackendConfig` — execution: backend name, kernels, bucketing
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core import types as core_types

_GRAM_IMPLS = ("auto", "pallas_fused", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The BPMF model itself (paper §III): rank, noise and prior.

    Attributes:
        K: Latent rank of the factorization ``R ~ U @ V.T``.
        alpha: Rating noise precision (likelihood ``N(r | u·v, 1/alpha)``).
        beta0: Normal-Wishart prior strength on the factor means.
        sample_dtype: dtype of the stored factor samples.
        compute_dtype: dtype the Gram inputs are rounded to (float32 or
            bfloat16; the products are summed in float32 either way).
    """

    K: int = 32
    alpha: float = 2.0
    beta0: float = 2.0
    sample_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Schedule, data split and checkpoint policy for one fit.

    Attributes:
        num_sweeps: Total Gibbs sweeps for :meth:`BPMFEngine.fit`.
        burn_in: Sweeps discarded before the posterior-mean accumulator
            starts averaging predictions.
        seed: Seeds both the train/test split and the sampler key.
        sweeps_per_block: Gibbs sweeps run between two host reads of the
            metrics; samples are identical at every value.
        pipeline_blocks: Depth of the block dispatch queue: blocks
            dispatched before the oldest one's metrics are read (1 = read
            each block before the next; same samples at every depth).
        async_checkpoint_writes: Write checkpoints on the manager's
            background thread: ``save()`` takes host copies and returns
            without waiting for the files. ``False`` saves synchronously.
        test_fraction: Held-out fraction for RMSE tracking.
        checkpoint_dir: Where :meth:`BPMFEngine.save` writes; ``None``
            disables checkpointing.
        checkpoint_every: Sweeps between auto-saves; 0 = explicit
            ``save()`` only. Blocks shrink to land on these boundaries.
        keep_checkpoints: Retention window (older steps are pruned).
        keep_factor_samples: Most recent post-burn-in ``(U, V)`` samples
            kept for the predictive std; 0 keeps only the running mean.
    """

    num_sweeps: int = 50
    burn_in: int = 8
    seed: int = 0
    sweeps_per_block: int = 8
    pipeline_blocks: int = 1
    async_checkpoint_writes: bool = True
    test_fraction: float = 0.1
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    keep_factor_samples: int = 8

    def __post_init__(self) -> None:
        if self.keep_factor_samples < 0:
            raise ValueError(
                f"RunConfig.keep_factor_samples must be >= 0, got {self.keep_factor_samples}"
            )
        if self.sweeps_per_block < 1:
            raise ValueError(
                f"RunConfig.sweeps_per_block must be >= 1, got {self.sweeps_per_block}"
            )
        if self.pipeline_blocks < 1:
            raise ValueError(
                f"RunConfig.pipeline_blocks must be >= 1, got {self.pipeline_blocks}"
            )
        if self.checkpoint_every < 0:
            raise ValueError(
                f"RunConfig.checkpoint_every must be >= 0, got {self.checkpoint_every}"
            )
        if self.keep_checkpoints < 0:
            raise ValueError(
                f"RunConfig.keep_checkpoints must be >= 0, got {self.keep_checkpoints}"
            )


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Execution backend selection.

    Attributes:
        name: Backend registry key: ``"sequential"``, ``"ring"``,
            ``"ring_async"``, ``"allgather"`` or ``"posterior_merge"``.
        num_shards: Ring length S of the distributed backends (0 = one
            shard per visible card, or one on the CPU). Shard d sits on
            card ``d % n``; shards that share a card run there in turn.
        pipeline_depth: ``ring_async`` rotations kept in flight (d >= 1).
        gram_impl: Gram dispatch, in the JAX package's spellings:
            ``"auto"``, ``"pallas"`` and ``"pallas_fused"`` launch the CUDA
            kernel on a GPU (its plain version on the CPU); ``"xla"`` names
            the plain PyTorch version, which runs on the CPU only.
        use_pallas: **Deprecated** boolean forerunner of ``gram_impl``
            (``True -> "pallas"``, ``False -> "xla"``); it warns.
        bucket_pads: Neighbor-count pad classes of the bucketed layout.
        partition_strategy: Load balancing of items onto shards
            (``"lpt"``, ``"block"`` or ``"naive"``); ``posterior_merge``
            partitions its users by it.
        num_partitions: ``posterior_merge`` only: independent partition
            chains (0 = one per visible card, one on the CPU). Chain c
            sits on card ``c % n``.
        merge_method: ``posterior_merge`` only: ``"precision"``
            (precision-weighted product of the subset Gaussians) or
            ``"pool"`` (uniform weights).
        donate_blocks: Block carry donation: ``"auto"`` or ``"on"`` hand
            the captured sweep's static buffers back as the new carry, and
            the next block overwrites them (the reference's donated buffers
            are consumed the same way); ``"off"`` hands back copies, so a
            carry kept from an earlier block is never overwritten. The
            eager loop (CPU) allocates new factors every sweep either way,
            and every path updates the posterior accumulator in place.
    """

    name: str = "sequential"
    num_shards: int = 0
    pipeline_depth: int = 1
    gram_impl: str = "auto"
    use_pallas: bool | None = None
    bucket_pads: tuple[int, ...] = (8, 32, 128, 512, 2048)
    partition_strategy: str = "lpt"
    num_partitions: int = 0
    merge_method: str = "precision"
    donate_blocks: str = "auto"

    def __post_init__(self) -> None:
        if self.donate_blocks not in ("auto", "on", "off"):
            raise ValueError(
                f'BackendConfig.donate_blocks must be "auto", "on" or "off", '
                f"got {self.donate_blocks!r}"
            )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"BackendConfig.pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.num_partitions < 0:
            raise ValueError(
                f"BackendConfig.num_partitions must be >= 0, got {self.num_partitions}"
            )
        if self.merge_method not in ("precision", "pool"):
            raise ValueError(
                f'BackendConfig.merge_method must be "precision" or "pool", '
                f"got {self.merge_method!r}"
            )
        if self.use_pallas is not None:
            if self.gram_impl != "auto":
                raise ValueError(
                    f"BackendConfig: both gram_impl={self.gram_impl!r} and the "
                    f"deprecated use_pallas={self.use_pallas} were given — drop use_pallas"
                )
            warnings.warn(
                'BackendConfig.use_pallas is deprecated; use gram_impl="auto" | '
                '"pallas" | "xla" instead',
                DeprecationWarning,
                stacklevel=3,
            )
            object.__setattr__(self, "gram_impl", "pallas" if self.use_pallas else "xla")
            object.__setattr__(self, "use_pallas", None)
        if self.gram_impl not in _GRAM_IMPLS:
            raise ValueError(
                f"BackendConfig.gram_impl must be one of {_GRAM_IMPLS}, got {self.gram_impl!r}"
            )


@dataclasses.dataclass(frozen=True)
class BPMFConfig:
    """Everything :class:`repro_torch.bpmf.BPMFEngine` needs, in one object."""

    model: ModelConfig = ModelConfig()
    run: RunConfig = RunConfig()
    backend: BackendConfig = BackendConfig()

    def core(self) -> core_types.BPMFConfig:
        """Lower to the flat config of :mod:`repro_torch.core`.

        Backend names that are also comm modes (``ring`` / ``ring_async`` /
        ``allgather``) pass through as ``comm_mode``; any other name lowers
        to ``"ring"``, which the sequential sampler ignores.
        """
        comm_modes = ("ring", "ring_async", "allgather")
        comm_mode = self.backend.name if self.backend.name in comm_modes else "ring"
        return core_types.BPMFConfig(
            K=self.model.K,
            alpha=self.model.alpha,
            num_sweeps=self.run.num_sweeps,
            burn_in=self.run.burn_in,
            beta0=self.model.beta0,
            sample_dtype=self.model.sample_dtype,
            compute_dtype=self.model.compute_dtype,
            gram_impl=self.backend.gram_impl,
            comm_mode=comm_mode,
            pipeline_depth=self.backend.pipeline_depth,
        )

    def replace(self, **kw: Any) -> "BPMFConfig":
        """``dataclasses.replace`` that also reaches one level down.

        Keys matching a sub-config field are routed there, so
        ``cfg.replace(K=8, num_sweeps=10)`` works without spelling out the
        nesting.

        Raises:
            TypeError: If a key matches no field anywhere.
        """
        subs = {"model": self.model, "run": self.run, "backend": self.backend}
        updates: dict[str, dict[str, Any]] = {k: {} for k in subs}
        top: dict[str, Any] = {}
        for key, val in kw.items():
            if key in subs:
                top[key] = val
                continue
            for sub_name, sub in subs.items():
                if any(f.name == key for f in dataclasses.fields(sub)):
                    updates[sub_name][key] = val
                    break
            else:
                raise TypeError(f"unknown BPMFConfig field: {key!r}")
        for sub_name, up in updates.items():
            if up:
                top[sub_name] = dataclasses.replace(subs[sub_name], **up)
        return dataclasses.replace(self, **top)
