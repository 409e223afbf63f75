"""Adaptive micro-batcher: coalesce concurrent requests under a deadline.

Concurrent ``predict``/``top_k`` requests are coalesced into one
predictor call per compatible group
(:meth:`repro_torch.serve.schema.PredictRequest.batch_key`), so arriving
singletons share one round of device launches instead of paying one each.

Policy (the JAX package's, DESIGN.md §11): the first queued request arms a
deadline of ``deadline_ms``; the dispatcher drains everything that arrives
before it fires, dispatching early when the coalesced size reaches
``max_batch``. The deadline is *adaptive*: when the
recent dispatch occupancy (EMA of requests per cycle) is ~1, traffic is
sparse and waiting only adds latency, so the batcher dispatches the moment
the queue is empty; under concurrency the EMA rises and the batcher waits
out the full deadline to fill batches. Requests are never dropped — even a
failing group run resolves every member ticket with an error response, and
``stop()`` flushes the queue before exiting.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from repro_torch.serve.schema import Request

_IDLE_EMA_MAX = 1.25  # EMA occupancy below this = sparse traffic, skip the wait
_EMA_ALPHA = 0.2


class Ticket:
    """One submitted request's completion handle (internal future)."""

    __slots__ = ("request", "_event", "result", "error")

    def __init__(self, request: Request):
        """Wrap a request for queueing.

        Args:
            request: The parsed request awaiting a coalesced dispatch.
        """
        self.request = request
        self._event = threading.Event()
        self.result = None
        self.error: BaseException | None = None

    def resolve(self, result=None, error: BaseException | None = None) -> None:
        """Complete the ticket and wake its waiter.

        Args:
            result: Per-request slice of the group result.
            error: Exception if the group run (or shutdown) failed.
        """
        self.result = result
        self.error = error
        self._event.set()

    def wait(self, timeout: float | None = None):
        """Block until resolved; re-raise a group error in the caller.

        Args:
            timeout: Seconds to wait (``None`` = forever).

        Returns:
            The per-request result.

        Raises:
            TimeoutError: The dispatcher did not resolve in time.
            BaseException: Whatever the group run raised, re-raised here.
        """
        if not self._event.wait(timeout):
            raise TimeoutError("micro-batch dispatch timed out")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Deadline-based request coalescer in front of a predictor.

    Args:
        run_group: ``run_group(key, requests) -> [result, ...]`` — execute
            one coalesced group (all requests share ``batch_key() == key``)
            and return one result per request, in order. Called on the
            dispatcher thread; reads its predictor reference once per call,
            which is what makes artifact hot-swap batch-atomic.
        deadline_ms: Max added latency a request can pay waiting for
            co-travellers (the coalescing window).
        max_batch: Coalesced query-row cap per cycle — reaching it
            dispatches immediately.
        adaptive: Skip the deadline wait while the occupancy EMA says
            traffic is sparse. ``False`` always waits the full deadline
            (deterministic coalescing, used by the bitwise tests).
    """

    def __init__(
        self,
        run_group: Callable[[tuple, Sequence[Request]], Sequence[object]],
        deadline_ms: float = 2.0,
        max_batch: int = 1024,
        adaptive: bool = True,
    ):
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_group = run_group
        self._deadline_s = deadline_ms / 1e3
        self._max_batch = max_batch
        self._adaptive = adaptive
        self._lock = threading.Condition()
        self._queue: list[Ticket] = []
        self._stopped = False
        self._ema_occupancy = 0.0
        self._stats = {
            "requests": 0, "rows": 0, "cycles": 0, "group_calls": 0,
            "coalesced_requests": 0, "max_cycle_requests": 0,
        }
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="micro-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Ticket:
        """Queue a request for the next coalesced dispatch.

        Args:
            request: Parsed request (:mod:`repro_torch.serve.schema`).

        Returns:
            A :class:`Ticket`; call :meth:`Ticket.wait` for the result.

        Raises:
            RuntimeError: The batcher has been stopped.
        """
        ticket = Ticket(request)
        with self._lock:
            if self._stopped:
                raise RuntimeError("micro-batcher is stopped")
            self._queue.append(ticket)
            self._lock.notify_all()
        return ticket

    def stop(self) -> None:
        """Stop the dispatcher, flushing (never dropping) queued requests."""
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        self._thread.join(timeout=30)

    def stats(self) -> dict:
        """Occupancy counters for monitoring / the load benchmark.

        Returns:
            Dict with ``requests`` (submitted), ``rows`` (query rows),
            ``cycles`` (dispatch cycles), ``group_calls`` (predictor
            calls), ``coalesced_requests`` (requests that shared a cycle
            with at least one other), ``max_cycle_requests``, ``occupancy``
            (requests per cycle) and the adaptive ``ema_occupancy``.
        """
        with self._lock:
            s = dict(self._stats)
            s["ema_occupancy"] = self._ema_occupancy
        s["occupancy"] = s["requests"] / s["cycles"] if s["cycles"] else 0.0
        return s

    # ------------------------------------------------------------------
    def _take_batch(self) -> list[Ticket]:
        """Block for the first request, then coalesce until deadline/full."""
        with self._lock:
            while not self._queue and not self._stopped:
                self._lock.wait()
            if not self._queue:
                return []
            deadline = time.monotonic() + self._deadline_s
            batch: list[Ticket] = []
            rows = 0
            while True:
                while self._queue and rows < self._max_batch:
                    t = self._queue.pop(0)
                    batch.append(t)
                    rows += t.request.size
                if rows >= self._max_batch or self._stopped:
                    break
                if self._adaptive and self._ema_occupancy < _IDLE_EMA_MAX:
                    break  # sparse traffic: don't pay the deadline for nothing
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
                if not self._queue:
                    # woken by timeout (or spurious): re-check the clock
                    if deadline - time.monotonic() <= 0:
                        break
            self._ema_occupancy = (
                (1 - _EMA_ALPHA) * self._ema_occupancy + _EMA_ALPHA * len(batch)
            )
            self._stats["cycles"] += 1
            self._stats["requests"] += len(batch)
            self._stats["rows"] += rows
            if len(batch) > 1:
                self._stats["coalesced_requests"] += len(batch)
            self._stats["max_cycle_requests"] = max(
                self._stats["max_cycle_requests"], len(batch)
            )
            return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._lock:
                    if self._stopped and not self._queue:
                        return
                continue
            groups: dict[tuple, list[Ticket]] = {}
            for t in batch:  # insertion order preserved within each group
                groups.setdefault(t.request.batch_key(), []).append(t)
            for key, tickets in groups.items():
                with self._lock:
                    self._stats["group_calls"] += 1
                try:
                    results = self._run_group(key, [t.request for t in tickets])
                    if len(results) != len(tickets):
                        raise RuntimeError(
                            f"run_group returned {len(results)} results for "
                            f"{len(tickets)} requests"
                        )
                except BaseException as e:  # resolve EVERY ticket, never drop
                    for t in tickets:
                        t.resolve(error=e)
                else:
                    for t, r in zip(tickets, results):
                        t.resolve(result=r)
