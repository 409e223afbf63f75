"""One sweep of a backend as a CUDA graph over static carries: the port's ``jax.jit``.

The JAX package runs a block of sweeps as one compiled program
(``repro/core/gibbs.py:_gibbs_sweep_block``, ``jax.jit`` over ``lax.scan``)
and, with donation, writes the carry in place. Here a backend's sweep
(``step(key, carry) -> (carry, row)``) is captured once as a
``torch.cuda.CUDAGraph``. Every tensor of the carry (the state, the
prediction accumulator and the posterior accumulator, counters included)
has a static buffer that the graph owns: the captured sweep reads them,
and its last nodes copy the new carry back into them. A block of ``n``
sweeps is ``n`` replays, each followed by a copy of the sweep's metrics
row into the block's ``[n, 4]`` device buffer; the host reads nothing.

What capture needs, and what this class does about it:

* Everything a sweep uses is built before the capture. One warm-up sweep
  runs eagerly on a side stream on the static buffers, which builds the
  kernel library (nvcc cannot run inside a capture) and the cuBLAS and
  cuSOLVER handles and workspaces. The warm-up advances those buffers,
  which does not matter: every :meth:`run` first refills them.
* Nothing in a sweep reads the device from the host or copies host data to
  the device (the counters are device tensors, the constants Python
  floats, the error checks the ``_ex`` forms). A capture that fails
  raises; nothing falls back to the eager loop.
* :meth:`run` copies each tensor of the caller's carry into its static
  buffer unless it already is that buffer. So a carry restored from a
  checkpoint, or freshly initialized, is what the next replay reads, and
  a graph never replays over a carry that is not the caller's.
* ``donate=True`` (``BackendConfig.donate_blocks`` ``"auto"``/``"on"``)
  returns the static buffers themselves: the next block overwrites them,
  as the reference's donated buffers are consumed. ``donate=False``
  returns copies, so a carry the caller keeps from an earlier block is
  never overwritten.
* The Gram wrappers count a launch when Python calls them, which under
  capture is once per capture and not once per replay. The capture's
  counts are taken off the counters (no kernel ran) and added back at
  every replay, so the counters keep meaning "launches issued on the
  card".

The allocations of the captured sweep (the new factors, the Gram kernels'
outputs and scratch) come from the graph's private memory pool and stay
reserved while the graph lives.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.core.types import map_tensors, tensors
from repro_torch.kernels import bpmf_gram as gram_kernel

# the Gram wrappers' counters of kernels issued on the card
LAUNCH_COUNTERS = ("LAUNCHES", "REDUCE_LAUNCHES", "FUSED_LAUNCHES", "FUSED_REDUCE_LAUNCHES")
WARMUP_SWEEPS = 1


def launch_counts() -> dict[str, int]:
    """The Gram wrappers' launch counters now."""
    return {name: getattr(gram_kernel, name) for name in LAUNCH_COUNTERS}


def _copy_into(dst_tree: Any, src_tree: Any) -> None:
    for dst, src in zip(tensors(dst_tree), tensors(src_tree), strict=True):
        if dst is not src:
            dst.copy_(src)


class SweepGraph:
    """A backend's sweep, captured once on its device and replayed per sweep.

    Args:
        step: One sweep, ``step(key, carry) -> (carry, row)``, issuing
            device work only; ``row`` is the sweep's ``[4]`` metrics row.
        key: The run key (copied into a static buffer at every :meth:`run`).
        carry: A carry of the shapes every later :meth:`run` passes; its
            values are not used (the first run copies its own in).

    Raises:
        RuntimeError: The capture failed (a host read or an unsafe call in
            the sweep, or a kernel that does not build).
    """

    def __init__(self, step: Callable, key: torch.Tensor, carry: Any):
        self.device = key.device
        elsewhere = {str(t.device) for t in tensors(carry) if t.device != self.device}
        if elsewhere:
            raise ValueError(f"the carry has tensors on {sorted(elsewhere)}, the graph's device is {self.device}")
        self.key = key.clone()
        self.carry = map_tensors(carry, torch.clone)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            for _ in range(WARMUP_SWEEPS):
                step(self.key, self.carry)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0

        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            out, row = step(self.key, self.carry)
            for dst, src in zip(tensors(self.carry), tensors(out), strict=True):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise RuntimeError(
                        f"the sweep changed a carry tensor from {dst.dtype} {tuple(dst.shape)} "
                        f"to {src.dtype} {tuple(src.shape)}"
                    )
            _copy_into(self.carry, out)
            self.row = row
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        after = launch_counts()
        # capture ran no kernel: take its counts off, add them at each replay
        self.launches_per_replay = {name: after[name] - before[name] for name in LAUNCH_COUNTERS}
        for name, n in before.items():
            setattr(gram_kernel, name, n)
        self.replays = 0

    def run(self, key: torch.Tensor, carry: Any, n: int, donate: bool = True) -> tuple[Any, torch.Tensor]:
        """``n`` sweeps from ``carry``: ``(carry, rows)``, with ``rows`` ``[n, 4]`` on the device.

        Nothing is read back to the host. With ``donate`` the returned
        carry is the graph's static buffers, which the next run overwrites;
        without it, copies of them.
        """
        self.key.copy_(key)
        _copy_into(self.carry, carry)
        rows = torch.empty((n,) + tuple(self.row.shape), dtype=self.row.dtype, device=self.device)
        for i in range(n):
            self.graph.replay()
            rows[i].copy_(self.row)
            for name, k in self.launches_per_replay.items():
                setattr(gram_kernel, name, getattr(gram_kernel, name) + k)
        self.replays += n
        return (self.carry if donate else map_tensors(self.carry, torch.clone)), rows
