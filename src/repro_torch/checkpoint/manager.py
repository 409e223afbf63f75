"""Checkpoint manager: retention, background writes, restore policy.

``save`` takes host copies of every leaf on the caller's thread (for a
CUDA tensor: a copy on the current stream, finished before ``save``
returns), so the sweep that follows may update the tensors in place. With
``async_writes`` the files are then written by one worker thread.
``wait()`` joins outstanding writes; retention prunes beyond ``keep``;
every live manager is drained at interpreter exit (an ``atexit`` hook over
a weak set), so a process that ends right after an async ``save()`` still
commits it. In a multi-process job ``save`` writes on the caller's thread:
the commit protocol's barriers must come in program order with the job's
other collectives, which a background writer would deadlock against.
Commits are atomic either way (tmp-dir rename, then ``LATEST`` replaced),
so a crash mid-write never exposes a torn checkpoint.

Reads (``latest``, ``all_steps``, ``restore``) first join the pending
writes of every live manager of the same directory in the process, not
only their own: an engine dropped right after an async ``save()`` keeps its
manager alive until the write commits (the queued write holds it), and a
fresh engine that restores then reads that checkpoint instead of racing it.
"""
from __future__ import annotations

import atexit
import os
import shutil
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterable, Mapping, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import (
    ShardedHostLeaf,
    _step_dir,
    host_snapshot_leaf,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch.hostdevices import process_count, process_index
from repro_torch.utils import logger

# live managers with a worker pool, drained by the atexit hook below; weak
# references so a dropped manager (and its pool) can still be collected
_LIVE_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _drain_managers_at_exit() -> None:
    """Join every live manager's pending writes at interpreter exit."""
    for mgr in list(_LIVE_MANAGERS):
        try:
            mgr.wait()
        except Exception:  # the exit path must not raise
            logger.exception("checkpoint drain at exit failed for %s", mgr.directory)


def _join_writes(directory: str) -> None:
    """Wait for every live manager's pending writes into ``directory``."""
    target = os.path.realpath(directory)
    for mgr in list(_LIVE_MANAGERS):
        if os.path.realpath(mgr.directory) == target:
            mgr.wait()


class CheckpointManager:
    """Save, retain and restore the checkpoints of one directory.

    Args:
        directory: Checkpoint root (created here).
        keep: Committed steps kept; older ones are pruned after each
            commit (0 keeps all).
        async_writes: Write on a one-thread executor; ``save`` returns once
            the host copies are taken.
    """

    def __init__(self, directory: str, keep: int = 3, async_writes: bool = True):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1) if async_writes else None
        self._pending: list[Future] = []
        if self._pool is not None:
            _LIVE_MANAGERS.add(self)
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, leaves: Mapping[str, Any]) -> None:
        """Snapshot now; write in the background (if async).

        Args:
            step: Step number of the checkpoint.
            leaves: Leaf name -> tensor, numpy array or
                :class:`~repro_torch.checkpoint.ShardedHostLeaf`, in
                manifest order.
        """
        host = {name: host_snapshot_leaf(leaf) for name, leaf in leaves.items()}
        if self._pool is None or process_count() > 1:
            save_checkpoint(self.directory, step, host)
            self._retain()
        else:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(self._pool.submit(self._write, step, host))

    def _write(self, step: int, host: dict[str, np.ndarray | ShardedHostLeaf]) -> None:
        try:
            save_checkpoint(self.directory, step, host)
            self._retain()
        except Exception:  # logged, not raised into the pool
            logger.exception("async checkpoint write for step %d failed", step)

    def wait(self) -> None:
        """Block until every pending write has committed."""
        for f in self._pending:
            f.result()
        self._pending.clear()

    def restore(self, target: Iterable[str], step: Optional[int] = None) -> dict[str, np.ndarray]:
        """:func:`restore_checkpoint` after the process's pending writes to the directory commit."""
        _join_writes(self.directory)
        return restore_checkpoint(self.directory, target, step)

    def latest(self) -> Optional[int]:
        """The latest committed step (after pending writes commit), or ``None``."""
        _join_writes(self.directory)
        return latest_step(self.directory)

    def all_steps(self) -> list[int]:
        """Committed steps on disk, ascending (after pending writes commit)."""
        _join_writes(self.directory)
        return self._list_steps()

    def _list_steps(self) -> list[int]:
        """Committed steps on disk right now; safe on the writer thread."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def _retain(self) -> None:
        if process_index() != 0:
            return  # one pruner; the other processes may still read these directories
        steps = self._list_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def close(self) -> None:
        """Wait for pending writes and stop the worker thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
