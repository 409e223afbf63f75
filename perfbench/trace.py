"""The traced window: ``torch.profiler`` over the measured loop, reduced to device and host timelines.

The harness opens named host spans around its calls into the program
(:func:`span`: block dispatch, metrics read, top-k call, harness loop);
the profiler records them with the host's operator and runtime calls, and
the card's kernels, copies and fills. :class:`Trace` keeps what fell inside
the window and answers:

* the device's busy seconds (the union of its operations' intervals) and
  the window's length;
* kernels by name, and their summed device time;
* the idle gaps (the window minus that union), each labelled by the
  harness span and the innermost host call open when the gap began;
* the breakdown the result line carries: the ten device operations that
  took the most time, and the ten longest idle gaps.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "perfbench: "
WINDOW = SPAN_PREFIX + "window"
# device operations that move or fill memory, not kernels
_MEMORY_OPS = ("Memcpy", "Memset")
_NAME_CHARS = 160
_TOP = 10


def span(label: str):
    """A host span of the harness, seen in the trace as ``perfbench: <label>``."""
    return record_function(SPAN_PREFIX + label)


@dataclasses.dataclass
class Trace:
    """What the profiler saw inside the window; times in nanoseconds on the profiler's clock."""

    start: int
    end: int
    device: list[tuple[str, int, int]]  # (name, start, end), sorted by start
    host: list[tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def kernels(self, *parts: str) -> list[tuple[str, int, int]]:
        """Kernels (not copies or fills) whose names contain any of ``parts`` (all kernels if none)."""
        return [op for op in self.device
                if not op[0].startswith(_MEMORY_OPS) and (not parts or any(p in op[0] for p in parts))]

    def _busy(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-9

    def gaps(self) -> list[tuple[int, int]]:
        out, t = [], self.start
        for a, b in self._busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: int) -> str:
        """The harness span and the innermost other host call open at ``t``."""
        open_ = [(b - a, name) for name, a, b in self.host if a <= t < b]
        spans = sorted(x for x in open_ if x[1].startswith(SPAN_PREFIX) and x[1] != WINDOW)
        calls = sorted(x for x in open_ if not x[1].startswith(SPAN_PREFIX))
        where = spans[0][1][len(SPAN_PREFIX):] if spans else "harness loop"
        return f"{where}: {calls[0][1]}"[:_NAME_CHARS] if calls else where

    def breakdown(self) -> dict:
        totals: dict[str, int] = {}
        for name, a, b in self.device:
            totals[name] = totals.get(name, 0) + (b - a)
        ops = sorted(totals.items(), key=lambda x: -x[1])[:_TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:_TOP]
        return {
            "device_ops": [[name[:_NAME_CHARS], ns * 1e-9] for name, ns in ops],
            "idle_gaps": [[self.host_at(a), (b - a) * 1e-9] for a, b in gaps],
        }


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body as the window; yields a list that holds the :class:`Trace` once the body is done."""
    out: list[Trace] = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == WINDOW)
    start, end = window.start_ns(), window.end_ns()
    dev, host = [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b < start or a > end:
            continue
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((e.name(), a, b))
        elif not (e.is_user_annotation() or e.name().startswith(SPAN_PREFIX)):
            # a host span's shadow on the device's timeline is no operation
            dev.append((e.name(), a, b))
    dev.sort(key=lambda op: op[1])
    out.append(Trace(start, end, dev, host))
