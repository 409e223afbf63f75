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
* The sweep's phase clock (:mod:`repro_torch.trace`) is captured with it:
  each phase mark is a CUDA timing event recorded into the graph (no
  kernel). An event-record node costs a replay ~5 µs on an H100 (0.9% of
  an ML20M sweep at 66 of them), so the events live in a second capture of
  the same sweep (:attr:`timed`, sharing the first one's memory pool), and
  only a block's last sweep replays it. Each :meth:`run` leaves a
  :class:`repro_torch.trace.TimedReplay` in :attr:`phases`, which also
  times the run's last plain replay by a pair of events on the stream
  around it (where a replay is queued before it: three or more sweeps). Events hold only their latest replay: before the timed
  capture replays again, :meth:`run` settles the previous run's reading,
  after it has queued the plain replays, so the host reads while the card
  works. ``phase_events=False`` leaves the second capture out, which
  exists to measure what it costs. The timed capture replays once before
  the first run (a first replay can run slow); ``timed_capture_seconds``
  holds it and that replay, ``capture_seconds`` the plain capture alone.
* The Gram wrappers and ``prng`` count a launch when Python calls them,
  and ``posterior`` a factorization, which under capture is once per
  capture and not once per replay. The captures' counts are taken off the
  counters (no kernel ran) and added back at every replay, the timed
  capture's first one included, so the counters keep meaning "launches
  made on the card" (``WORK_COUNTERS``).

The allocations of the captured sweep (the new factors, the Gram kernels'
outputs and scratch) come from the graph's private memory pool and stay
reserved while the graph lives.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import trace
from repro_torch.core import posterior, prng
from repro_torch.core.types import map_tensors, tensors
from repro_torch.kernels import bpmf_gram as gram_kernel

# the Gram wrappers' counters of kernels issued on the card
LAUNCH_COUNTERS = ("LAUNCHES", "REDUCE_LAUNCHES", "FUSED_LAUNCHES", "FUSED_REDUCE_LAUNCHES")
# other modules' counters of a sweep's device work: (module, counter, the graph's count per replay)
WORK_COUNTERS = (
    (prng, "LAUNCHES", "prng_launches_per_replay"),  # the threefry kernels (core/prng.py)
    (posterior, "FACTORS", "factors_per_replay"),  # batched factorizations
    (posterior, "FACTOR_ROWS", "factor_rows_per_replay"),  # the matrices they factor
)
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
        phase_events: Capture the sweep a second time with the phase
            clock's events (the default); ``False`` only to measure their
            cost.

    Raises:
        RuntimeError: The capture failed (a host read or an unsafe call in
            the sweep, or a kernel that does not build).
    """

    def __init__(self, step: Callable, key: torch.Tensor, carry: Any, phase_events: bool = True):
        self.device = key.device
        elsewhere = {str(t.device) for t in tensors(carry) if t.device != self.device}
        if elsewhere:
            raise ValueError(f"the carry has tensors on {sorted(elsewhere)}, the graph's device is {self.device}")
        self.key = key.clone()
        self.carry = map_tensors(carry, torch.clone)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with trace.span("sweep_graph.warmup") as warmup:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_SWEEPS):
                    step(self.key, self.carry)
            current.wait_stream(side)
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = warmup.seconds

        before = launch_counts()
        work_before = [getattr(module, name) for module, name, _ in WORK_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with trace.span("sweep_graph.capture") as capture:
            self.row, _ = self._capture(self.graph, step, trace.SilentPhases())
        self.capture_seconds = capture.seconds
        once = launch_counts()
        # one sweep's count of each work counter, kept per replay as the Gram launches are
        for (module, name, per_replay), n in zip(WORK_COUNTERS, work_before):
            setattr(self, per_replay, getattr(module, name) - n)
        # the capture with the phase events: (graph, metrics row, clock), replayed for a block's last sweep
        self.timed: tuple[torch.cuda.CUDAGraph, torch.Tensor, trace.DevicePhases] | None = None
        self.timed_capture_seconds = 0.0
        if phase_events:
            with trace.span("sweep_graph.timed_capture") as timed_capture:
                graph = torch.cuda.CUDAGraph()
                row, clock = self._capture(graph, step, None, pool=self.graph.pool())
                self.timed = (graph, row, clock)
                # a capture's first replay can run slow on the card (~3 ms over in its first
                # phase, under the profiler): it runs once here, on the static buffers, as the
                # warm-up does (every run refills them)
                graph.replay()
                torch.cuda.synchronize(self.device)
            self.timed_capture_seconds = timed_capture.seconds
        # capture ran no kernel: take its counts off, add them at each replay (that first one here too)
        self.launches_per_replay = {name: once[name] - before[name] for name in LAUNCH_COUNTERS}
        for name, n in before.items():
            setattr(gram_kernel, name, n + (self.timed is not None) * self.launches_per_replay[name])
        for (module, name, per_replay), n in zip(WORK_COUNTERS, work_before):
            setattr(module, name, n + (self.timed is not None) * getattr(self, per_replay))
        # sweeps run before the first run, and counted as launched: the warm-up, the timed first replay
        self.setup_sweeps = WARMUP_SWEEPS + (self.timed is not None)
        self.replays = 0
        self.runs = 0
        # the latest run's replay of the timed capture (None without it)
        self.phases: trace.TimedReplay | None = None

    def _capture(self, graph: torch.cuda.CUDAGraph, step: Callable, clock, pool=None):
        """Capture one sweep of ``step`` over the static buffers into ``graph``: ``(metrics row, clock)``.

        ``clock`` is the phase clock of the capture; ``None`` makes a
        :class:`repro_torch.trace.DevicePhases` inside it, whose first event
        marks the sweep's start.
        """
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            if clock is None:
                clock = trace.DevicePhases(self.device)
            with trace.sweep(clock):
                out, row = step(self.key, self.carry)
                for dst, src in zip(tensors(self.carry), tensors(out), strict=True):
                    if dst.shape != src.shape or dst.dtype != src.dtype:
                        raise RuntimeError(
                            f"the sweep changed a carry tensor from {dst.dtype} {tuple(dst.shape)} "
                            f"to {src.dtype} {tuple(src.shape)}"
                        )
                _copy_into(self.carry, out)
        return row, clock

    def run(self, key: torch.Tensor, carry: Any, n: int, donate: bool = True) -> tuple[Any, torch.Tensor]:
        """``n`` sweeps from ``carry``: ``(carry, rows)``, with ``rows`` ``[n, 4]`` on the device.

        Nothing is read back to the host. With ``donate`` the returned
        carry is the graph's static buffers, which the next run overwrites;
        without it, copies of them. With the timed capture, the last sweep
        replays it and :attr:`phases` is that replay's
        :class:`repro_torch.trace.TimedReplay`; the previous run's is
        settled first.
        """
        with trace.span("sweep_graph.carry_in"):
            self.key.copy_(key)
            _copy_into(self.carry, carry)
        rows = torch.empty((n,) + tuple(self.row.shape), dtype=self.row.dtype, device=self.device)
        # the last plain replay, timed where another replay is queued before it (an idle card
        # would start the pair's clock before the host had launched the graph)
        plain = None
        if self.timed is not None and n > 2:
            plain = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for i in range(n):
            graph, row = self.graph, self.row
            if self.timed is not None and i == n - 1:
                graph, row, clock = self.timed
                if self.phases is not None:
                    self.phases.settle()  # the card is still busy with this run's plain replays
                self.phases = trace.TimedReplay(clock, plain)
            bracket = plain if i == n - 2 else None
            with trace.span("sweep_graph.launch", replay=self.replays + i):
                if bracket is not None:
                    bracket[0].record()
                graph.replay()
                if bracket is not None:
                    bracket[1].record()
            with trace.span("sweep_graph.row_copy"):
                rows[i].copy_(row)
            for name, k in self.launches_per_replay.items():
                setattr(gram_kernel, name, getattr(gram_kernel, name) + k)
            for module, name, per_replay in WORK_COUNTERS:
                setattr(module, name, getattr(module, name) + getattr(self, per_replay))
        self.replays += n
        self.runs += 1
        return (self.carry if donate else map_tensors(self.carry, torch.clone)), rows
