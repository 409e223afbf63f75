"""Persistent BPMF serving server: HTTP front, micro-batched device back.

The JAX package's server (DESIGN.md §11) over the port's predictor, on
one device: a threaded HTTP server that fields concurrent
``predict``/``top_k`` requests over one
:class:`repro_torch.serve.predictor.PosteriorPredictor`, with

* **adaptive micro-batching** — concurrent requests coalesce into one
  predictor call per group under a latency deadline
  (:mod:`repro_torch.serve.batcher`); a coalesced answer has the bits of
  the same request run alone (the predictor's fixed sum order);
* **zero-downtime hot-swap** — a watcher thread polls the artifact
  directory, validates any fresh export by *fully loading* it (typed
  ``ArtifactError`` failures keep the old posterior serving), warms it,
  and atomically swaps the live predictor between batches
  (:class:`repro_torch.serve.predictor.PredictorHandle`); in-flight
  batches drain on the posterior they started with.

Catalog top-k is the scan on the serving device (``topk_mode``
``"replicated"``) or the item-sharded scan with one item shard per visible
card (``"sharded"``; ``"auto"`` picks it for several cards and a catalog
of at least 1,024 items), with the same answers.

Endpoints (JSON over HTTP/1.1, schema in :mod:`repro_torch.serve.schema`):

* ``POST /query`` — one request object per call; 400 + ``{"error": ...}``
  on invalid requests, 200 + the response object otherwise.
* ``GET /healthz`` — liveness + artifact metadata + swap ``generation``.
* ``GET /stats`` — micro-batcher occupancy counters + swap state.

Start via :class:`BPMFServer` in-process or
``python -m repro_torch.launch.serve_server`` from the CLI; query with
:class:`repro_torch.serve.client.ServeClient` or
``python -m repro_torch.launch.serve --server host:port``.
"""
from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serve import schema
from repro_torch.serve.artifact import ArtifactError
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.predictor import PosteriorPredictor, PredictorHandle
from repro_torch.utils import resolve_device

_MAX_BODY_BYTES = 8 << 20  # refuse absurd request bodies before json.loads


def _artifact_signature(directory: str) -> tuple | None:
    """Cheap change signature of an artifact dir: mtime_ns + size of the
    metadata file (written last by an atomic export) *and* of the array
    manifest — so a re-export that has already replaced the arrays but not
    yet committed fresh metadata still changes the signature, and a load
    that raced it is rejected by the post-load signature re-check."""
    try:
        meta = os.stat(os.path.join(directory, "artifact.json"))
        man = os.stat(os.path.join(directory, "step_00000000", "manifest.json"))
        return (meta.st_mtime_ns, meta.st_size, man.st_mtime_ns, man.st_size)
    except OSError:
        return None


class BPMFServer:
    """Persistent serving server over an exported posterior artifact.

    Args:
        artifact: Artifact directory written by ``BPMFEngine.export()``.
        host: Bind address (default loopback).
        port: Bind port; 0 picks an ephemeral port (see :attr:`address`).
        deadline_ms: Micro-batch coalescing deadline — the max latency a
            request pays waiting for co-travellers.
        max_batch: Coalesced query-row cap per dispatch cycle.
        adaptive: Skip the deadline wait while traffic is sparse
            (:class:`repro_torch.serve.batcher.MicroBatcher`).
        topk_mode: ``top_k`` execution mode passed to the predictor
            (``auto`` / ``replicated`` / ``sharded``).
        watch: Poll ``artifact`` for fresh exports and hot-swap them in.
        poll_interval_s: Watcher poll cadence.
        device: ``None`` or ``"cuda"`` serves from the GPU; ``"cpu"``
            from the CPU.

    Raises:
        ArtifactError: The initial artifact fails to load.
        RuntimeError: No CUDA device and no CPU request.
    """

    def __init__(
        self,
        artifact: str,
        host: str = "127.0.0.1",
        port: int = 0,
        deadline_ms: float = 2.0,
        max_batch: int = 1024,
        adaptive: bool = True,
        topk_mode: str = "auto",
        watch: bool = True,
        poll_interval_s: float = 1.0,
        device=None,
    ):
        self._artifact_dir = artifact
        self._device = resolve_device(device)
        self._topk_mode = topk_mode
        self._signature = _artifact_signature(artifact)
        predictor = PosteriorPredictor.load(artifact, device=self._device, topk_mode=topk_mode)
        self.handle = PredictorHandle(predictor)
        self._warmup(predictor)
        self.batcher = MicroBatcher(
            self._run_group, deadline_ms=deadline_ms, max_batch=max_batch,
            adaptive=adaptive,
        )
        self._watch = watch
        self._poll_interval_s = poll_interval_s
        self._stop_event = threading.Event()
        self._watcher: threading.Thread | None = None
        self._swap_failures = 0
        self._http = _make_http_server(self, host, port)
        self._http_thread: threading.Thread | None = None
        self._started = False

    # ------------------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        """Bound ``(host, port)`` — resolved even when ``port=0`` was asked."""
        return self._http.server_address[:2]

    @property
    def generation(self) -> int:
        """Artifact swaps completed since startup."""
        return self.handle.generation

    def start(self) -> tuple[str, int]:
        """Start the HTTP listener (and watcher) threads; non-blocking.

        Returns:
            The bound ``(host, port)``.
        """
        if self._started:
            return self.address
        self._started = True
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="bpmf-serve-http", daemon=True
        )
        self._http_thread.start()
        if self._watch:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="bpmf-serve-watch", daemon=True
            )
            self._watcher.start()
        return self.address

    def serve_forever(self) -> None:
        """Blocking variant of :meth:`start` (returns after :meth:`shutdown`)."""
        self.start()
        self._stop_event.wait()

    def shutdown(self) -> None:
        """Clean shutdown: stop accepting, drain in-flight requests, stop
        the watcher. Idempotent."""
        if self._stop_event.is_set():
            return
        self._stop_event.set()
        self._http.shutdown()  # stop accepting; running handlers finish
        if self._http_thread is not None:
            self._http_thread.join(timeout=30)
        self._http.server_close()
        self.batcher.stop()  # flushes the queue — nothing is dropped
        if self._watcher is not None:
            self._watcher.join(timeout=30)

    def __enter__(self) -> "BPMFServer":
        """Context-manager start."""
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        """Context-manager clean shutdown."""
        self.shutdown()

    # ------------------------------------------------------------------
    # request execution (dispatcher thread)
    # ------------------------------------------------------------------
    def _run_group(self, key: tuple, requests: list) -> list[dict]:
        """Execute one coalesced group; the single handle read per batch is
        what makes hot-swap batch-atomic."""
        predictor = self.handle.get()
        if key[0] == "predict":
            rows = np.concatenate([r.rows for r in requests])
            cols = np.concatenate([r.cols for r in requests])
            out = predictor.predict(rows, cols, return_std=key[1])
            preds, std = out if key[1] else (out, None)
            results, off = [], 0
            for r in requests:
                sl = slice(off, off + r.size)
                resp = {"predictions": preds[sl].tolist()}
                if std is not None:
                    resp["std"] = std[sl].tolist()
                results.append(resp)
                off += r.size
            return results
        users = np.concatenate([r.users for r in requests])
        ids, scores = predictor.top_k(users, key[1])
        results, off = [], 0
        for r in requests:
            sl = slice(off, off + r.size)
            if r.scalar:
                results.append({
                    "user": int(r.users[0]), "items": ids[off].tolist(),
                    "scores": scores[off].tolist(),
                })
            else:
                results.append({
                    "users": r.users.tolist(), "items": ids[sl].tolist(),
                    "scores": scores[sl].tolist(),
                })
            off += r.size
        return results

    def handle_request(self, payload: object, timeout: float = 60.0) -> tuple[int, dict]:
        """Parse + dispatch one decoded request body.

        Args:
            payload: Decoded JSON request.
            timeout: Seconds to wait for the coalesced dispatch.

        Returns:
            ``(http_status, response_dict)``.
        """
        try:
            req = schema.parse_request(payload)
        except schema.RequestError as e:
            return 400, schema.error_response(e)
        try:
            result = self.batcher.submit(req).wait(timeout=timeout)
            return 200, result
        except (ValueError, KeyError, TypeError) as e:
            # predictor-side validation (out-of-range ids, std w/o samples)
            return 400, schema.error_response(e)
        except Exception as e:  # never leak a traceback to the wire
            return 500, schema.error_response(e)

    # ------------------------------------------------------------------
    # hot-swap watcher
    # ------------------------------------------------------------------
    def _warmup(self, predictor: PosteriorPredictor) -> None:
        """Run one query of each kind, so the first real query (and the
        first query after a swap) pays no first-call cost."""
        meta = predictor.meta
        predictor.predict([0], [0])
        predictor.top_k(0, min(10, meta.num_movies))

    def _try_swap(self) -> bool:
        """Validate + swap a fresh export; on any failure keep serving the
        old posterior. Returns True when a swap happened."""
        sig = _artifact_signature(self._artifact_dir)
        if sig is None or sig == self._signature:
            return False
        try:
            fresh = PosteriorPredictor.load(
                self._artifact_dir, device=self._device, topk_mode=self._topk_mode
            )
            self._warmup(fresh)
        except ArtifactError as e:
            # half-written / torn export: keep the live posterior, retry
            # next poll (the exporter commits metadata last, so this clears)
            self._swap_failures += 1
            print(f"[bpmf-serve] swap rejected: {e}", file=sys.stderr)
            return False
        if _artifact_signature(self._artifact_dir) != sig:
            return False  # exporter still writing — pick it up next poll
        self._signature = sig
        gen = self.handle.swap(fresh)
        meta = fresh.meta
        print(
            f"[bpmf-serve] hot-swapped artifact (generation {gen}): "
            f"{meta.num_sweeps_done} sweeps, {meta.num_mean_samples} samples "
            f"averaged, backend={meta.backend}",
            file=sys.stderr,
        )
        return True

    def _watch_loop(self) -> None:
        while not self._stop_event.wait(self._poll_interval_s):
            try:
                self._try_swap()
            except Exception as e:  # watcher must never die
                self._swap_failures += 1
                print(f"[bpmf-serve] watcher error: {e}", file=sys.stderr)

    def poll_artifact_now(self) -> bool:
        """Force one watcher poll (tests / manual reload without waiting).

        Returns:
            True when a fresh artifact was validated and swapped in.
        """
        return self._try_swap()

    # ------------------------------------------------------------------
    def health(self) -> dict:
        """Liveness payload served at ``GET /healthz``."""
        predictor, gen = self.handle.get_with_generation()
        meta = predictor.meta
        return {
            "status": "ok",
            "generation": gen,
            "swap_failures": self._swap_failures,
            "artifact": {
                "num_users": meta.num_users, "num_movies": meta.num_movies,
                "K": meta.K, "backend": meta.backend,
                "num_sweeps_done": meta.num_sweeps_done,
                "num_mean_samples": meta.num_mean_samples,
            },
        }

    def stats(self) -> dict:
        """Batcher occupancy + swap counters served at ``GET /stats``."""
        return {
            "generation": self.handle.generation,
            "swap_failures": self._swap_failures,
            "topk_mode": self._topk_mode,
            "batcher": self.batcher.stats(),
        }


def _make_http_server(server: BPMFServer, host: str, port: int) -> ThreadingHTTPServer:
    """Build the threaded HTTP front bound to ``server``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # response status/headers/body are separate writes: without
        # TCP_NODELAY, Nagle + delayed ACK adds ~40ms per response
        disable_nagle_algorithm = True

        def _send(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path in ("/healthz", "/health"):
                self._send(200, server.health())
            elif self.path == "/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802 (http.server API)
            if self.path not in ("/query", "/"):
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0 or length > _MAX_BODY_BYTES:
                self._send(400, {"error": "missing or oversized Content-Length"})
                return
            try:
                payload = json.loads(self.rfile.read(length))
            except ValueError as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            status, resp = server.handle_request(payload)
            self._send(status, resp)

        def log_message(self, fmt, *args):  # quiet: one line per request is noise
            pass

    return ThreadingHTTPServer((host, port), Handler)
