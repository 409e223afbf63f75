"""The port's own timing: host spans on the profiler's clock, and the phase clock of a Gibbs sweep.

**Host spans.** ``with span("engine.dispatch", sweep=9) as s:`` times its
body on the host, keeps the seconds (``s.seconds``) and adds them to the
process's total for the span's name (:func:`totals`). While a
``torch.profiler`` is recording, the span also opens a ``record_function``
named ``repro_torch: engine.dispatch`` (its ids as the arguments), so the
program's spans sit on the clock of the device trace's kernels. Without a
profiler a span costs one flag check and two clock reads. The program's
timers are filled from spans: ``Backend.prepare_seconds``,
``SweepGraph.warmup_seconds``, ``capture_seconds`` and
``timed_capture_seconds``, ``BPMFEngine.host_blocked_s``,
``Ring.host_seconds``.

**The phase clock.** A sweep's code marks where each of its phases starts
(:func:`phase`, one of :data:`PHASES`). A phase lasts until the next mark,
so the phases are exclusive and cover the sweep, and a phase that recurs
(per bucket: gram, solve, noise, solve) sums its intervals. Inside a
:func:`sweep` context the marks go to the context's clock:

* :class:`HostPhases`, the default, for eager sweeps: each phase is a host
  span named ``repro_torch: sweep.<phase>``;
* :class:`DevicePhases`, for a sweep being captured as a CUDA graph: each
  mark is a CUDA timing event recorded into the graph (an event-record
  node, no kernel), and after a replay :meth:`DevicePhases.read` gives that
  replay's phase milliseconds on the device's clock. Events in a graph
  hold only their latest replay, so each replay of them gets a
  :class:`TimedReplay`, which the graph settles before it replays them
  again.

Outside a sweep context a mark does nothing; an inner context defers to
the outer one's clock. The engine keeps a :class:`BlockRecord` per block
(``BPMFEngine.blocks``) and the predictor a :class:`CallRecord` per top-k
call (``PosteriorPredictor.calls``); README.md says how to read both.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

PREFIX = "repro_torch: "
# a sweep's phases, in the order a sequential sweep first enters them
PHASES = ("hyper", "gram", "solve", "noise", "predict", "accum")
# records kept by an engine (one per block) and by a predictor (one per call)
BLOCK_RECORDS = 4096
CALL_RECORDS = 4096

_lock = threading.Lock()
_totals: dict[str, list] = {}
_local = threading.local()


def profiling() -> bool:
    """Whether a torch profiler is recording in this process: the one check a span makes."""
    return torch.autograd._profiler_enabled()


def _add(name: str, seconds: float) -> None:
    with _lock:
        entry = _totals.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds


def totals() -> dict[str, tuple[int, float]]:
    """Every span name timed in this process so far: ``(count, seconds)``."""
    with _lock:
        return {name: (n, s) for name, (n, s) in _totals.items()}


def reset_totals() -> None:
    """Forget the totals (to time a window)."""
    with _lock:
        _totals.clear()


def _enter(name: str, ids: dict | None = None):
    if not profiling():
        return None
    rf = record_function(PREFIX + name, ", ".join(f"{k}={v}" for k, v in ids.items()) if ids else None)
    rf.__enter__()
    return rf


class Span:
    """A timed host span (see :func:`span`); ``seconds`` holds its time once it has ended."""

    __slots__ = ("name", "ids", "seconds", "_t0", "_rf")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids, self.seconds = name, ids, 0.0

    def __enter__(self) -> "Span":
        self._rf = _enter(self.name, self.ids)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        _add(self.name, self.seconds)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None


def span(name: str, **ids) -> Span:
    """A host span ``<layer>.<name>``, e.g. ``span("engine.dispatch", sweep=9)``; use it in ``with``."""
    return Span(name, ids)


class HostPhases:
    """An eager sweep's clock: each phase a host span ``repro_torch: sweep.<phase>``."""

    clock = "host"

    def __init__(self):
        self.ms = dict.fromkeys(PHASES, 0.0)
        self.current: str | None = None
        self._start = self._t = time.perf_counter()
        self._wall = 0.0
        self._rf = None

    def _end_phase(self, now: float) -> None:
        if self.current is not None:
            self.ms[self.current] += 1e3 * (now - self._t)
            _add("sweep." + self.current, now - self._t)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def mark(self, name: str) -> None:
        """Phase ``name`` starts here (a mark of the phase already running does nothing)."""
        if name == self.current:
            return
        now = time.perf_counter()
        self._end_phase(now)
        self.current, self._t = name, now
        self._rf = _enter("sweep." + name)

    def close(self) -> None:
        """The sweep ends here."""
        now = time.perf_counter()
        self._end_phase(now)
        self.current = None
        self._wall = 1e3 * (now - self._start)

    def reading(self) -> tuple[str, dict[str, float], float, None]:
        """``("host", milliseconds per phase, milliseconds from the context's start to its close, None)``."""
        return self.clock, dict(self.ms), self._wall, None


class DevicePhases:
    """A captured sweep's clock: each mark a CUDA timing event recorded into the graph.

    Built inside the capture: its first event marks the sweep's start. The
    events are ``external``, so capture turns each into an event-record
    node, which adds no kernel.
    """

    clock = "device"

    def __init__(self, device: torch.device):
        self.device = device
        self.current: str | None = None
        self.marks: list[tuple[str | None, torch.cuda.Event]] = []
        self._record(None)

    def _record(self, label: str | None) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record(torch.cuda.current_stream(self.device))
        self.marks.append((label, event))

    def mark(self, name: str) -> None:
        """Phase ``name`` starts here (a mark of the phase already running does nothing)."""
        if name != self.current:
            self.current = name
            self._record(name)

    def close(self) -> None:
        """The sweep ends here: the last event."""
        self.current = None
        self._record(None)

    def done(self) -> bool:
        """Whether the latest replay of the events has completed on the device."""
        return self.marks[-1][1].query()

    def read(self) -> tuple[dict[str, float], float]:
        """The latest replay's ``(device milliseconds per phase, first event to last)``.

        Call it only once that replay has completed on the device.
        """
        ms = dict.fromkeys(PHASES, 0.0)
        for (label, a), (_, b) in zip(self.marks, self.marks[1:]):
            if label is not None:
                ms[label] += a.elapsed_time(b)
        return ms, self.marks[0][1].elapsed_time(self.marks[-1][1])


class TimedReplay:
    """One replay of a capture with the phase events, and a plain replay of the same run before it.

    ``plain`` is a pair of timing events recorded on the stream around that
    plain replay, or ``None`` (a run of fewer than three sweeps). The graph's events hold
    only their latest replay, so the graph calls :meth:`settle` before it
    replays them again: that keeps this replay's reading if the replay has
    completed on the device, and leaves it unsampled if not (a later block
    was dispatched before this one ended).
    """

    def __init__(self, clock: DevicePhases, plain: tuple[torch.cuda.Event, torch.cuda.Event] | None):
        self._clock, self._plain = clock, plain
        self._reading: tuple | None = None

    def settle(self) -> None:
        """Take the reading now if the replay has completed; once settled, the events are let go."""
        if self._clock is None:
            return
        if self._clock.done():
            ms, wall = self._clock.read()
            plain = self._plain[0].elapsed_time(self._plain[1]) if self._plain else None
            self._reading = ("device", ms, wall, plain)
        self._clock = self._plain = None

    def reading(self) -> tuple[str | None, dict[str, float] | None, float | None, float | None]:
        """``("device", ms per phase, first event to last, the plain replay's ms)``; all ``None`` if unsampled.

        Settles first: call it once the replay's block has been read back.
        """
        self.settle()
        return self._reading or (None, None, None, None)


class SilentPhases:
    """A clock that keeps nothing: a capture without phase events."""

    clock = None

    def mark(self, name: str) -> None:
        """Nothing."""

    def close(self) -> None:
        """Nothing."""


class _Sweep:
    def __init__(self, clock):
        self.clock, self.own = clock, False

    def __enter__(self):
        outer = getattr(_local, "clock", None)
        if outer is not None:
            return outer
        self.own = True
        if self.clock is None:
            self.clock = HostPhases()
        _local.clock = self.clock
        return self.clock

    def __exit__(self, *exc) -> None:
        if self.own:
            _local.clock = None
            self.clock.close()


def sweep(clock=None):
    """One sweep's context: marks inside it go to ``clock`` (a :class:`HostPhases` when ``None``).

    Yields the clock in effect; inside another sweep context, the outer one's.
    """
    return _Sweep(clock)


def phase(name: str) -> None:
    """Phase ``name`` of the current sweep starts here; nothing outside a sweep context."""
    clock = getattr(_local, "clock", None)
    if clock is not None:
        clock.mark(name)


class BlockRecord(NamedTuple):
    """One block of sweeps as the engine read it back.

    ``clock`` is ``"device"`` (the captured graph's events), ``"host"`` (an
    eager sweep's spans: on a card, the time to issue its work) or ``None``
    (not sampled: a later block replayed the graph's events before this
    block's had completed). The phases and the wall (first event to last)
    are those of the block's last sweep, which replays the capture with the
    events. ``plain_ms`` is the device time of the sweep before it, a
    replay of the capture without them, timed by a pair of events on the
    stream around it (``None`` on the host's clock, or in a block of fewer
    than three sweeps).
    """

    first_sweep: int
    sweeps: int
    clock: str | None
    phase_ms: dict[str, float] | None
    wall_ms: float | None
    plain_ms: float | None


class CallRecord(NamedTuple):
    """One replicated top-k call: milliseconds of the scores (with the clamp), the sort and the host copy.

    ``clock`` is ``"device"`` (CUDA events) or ``"host"`` (the spans, on the CPU).
    """

    call: int
    users: int
    clock: str
    score_ms: float
    sort_ms: float
    copy_ms: float
