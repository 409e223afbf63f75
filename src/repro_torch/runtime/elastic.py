"""Elastic training runtime: failure injection, restart policy, straggler watchdog.

The port's own copy of ``repro.runtime.elastic`` (plain Python, no JAX):

* :class:`FailureInjector` raises :class:`NodeFailure` at configured sweeps,
  standing in for a cluster health check. ``python -m
  repro_torch.launch.bpmf`` exposes it as ``--inject-failure``, so that a
  launcher test can kill one process of a live job deterministically.
* :class:`RestartPolicy` decides how a job comes back after a process dies:
  one fewer process, the same ring shard count S. The checkpointed carries
  are laid out over S shards, and S fixes the samples, so a restart splits
  the same S over the survivors and each reads its rows from the
  checkpoint's shard files (``python -m repro_torch.launch.multiproc
  --elastic``).
* :class:`StepTimer` is the straggler watchdog: it flags sweeps slower
  than a multiple of the rolling median, so an orchestrator can evict a
  slow host between checkpoints. ``python -m repro_torch.launch.bpmf``
  records every sweep through one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils import logger


class NodeFailure(RuntimeError):
    """Simulated loss of one or more devices or hosts."""

    def __init__(self, lost_devices: int):
        super().__init__(f"lost {lost_devices} devices")
        self.lost_devices = lost_devices


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: ``{step: devices_lost}``; each entry fires once."""

    schedule: dict[int, int]

    def check(self, step: int) -> None:
        """Raise :class:`NodeFailure` if ``step`` is scheduled (and unschedule it)."""
        if step in self.schedule:
            lost = self.schedule.pop(step)
            raise NodeFailure(lost)


@dataclasses.dataclass
class RestartPolicy:
    """How a job that lost a process restarts at a smaller size.

    ``total_devices`` is the invariant, the ring's shard count S: the
    checkpointed carries and the data partition are laid out over S
    shards, so a restart keeps S and splits it over fewer processes.
    """

    total_devices: int
    min_processes: int = 1
    max_restarts: int = 2
    restarts_done: int = 0

    def next_layout(self, num_processes: int) -> tuple[int, int] | None:
        """Layout after losing a process: ``(processes, shards_per_process)``.

        The largest process count below ``num_processes`` (and at least
        ``min_processes``) that divides ``total_devices``. ``None`` when the
        restart budget is spent or no such count exists: the job then fails
        for real.
        """
        if self.restarts_done >= self.max_restarts:
            return None
        for procs in range(num_processes - 1, self.min_processes - 1, -1):
            if procs >= 1 and self.total_devices % procs == 0:
                self.restarts_done += 1
                logger.warning(
                    "elastic restart %d/%d: %d -> %d processes x %d devices",
                    self.restarts_done, self.max_restarts,
                    num_processes, procs, self.total_devices // procs,
                )
                return procs, self.total_devices // procs
        return None


class StepTimer:
    """Rolling step-time statistics; flags stragglers (slower than ``threshold`` x the median)."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times: list[float] = []
        self.window = window
        self.threshold = threshold
        self.straggler_steps: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        """Add one step's seconds; True (and the step logged) when it straggled."""
        self.times.append(seconds)
        self.times = self.times[-self.window:]
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and seconds > self.threshold * med
        if slow:
            self.straggler_steps.append(step)
            logger.warning("step %d straggled: %.3fs vs median %.3fs", step, seconds, med)
        return slow
