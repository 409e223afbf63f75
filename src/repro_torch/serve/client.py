"""Thin stdlib HTTP client for the persistent serving server.

``ServeClient`` speaks the shared request/response schema
(:mod:`repro_torch.serve.schema`) against a :class:`repro_torch.serve.server.BPMFServer`
(either package's) — used by ``python -m repro_torch.launch.serve --server
host:port`` (the same CLI drives the in-process predictor or a remote
server), ``chip_smoke.py``'s serving phase, and the tests. One persistent
keep-alive connection per client instance; instances are NOT thread-safe —
give each client thread its own.
"""
from __future__ import annotations

import http.client
import json
import socket

import numpy as np


class ServeConnectionError(ConnectionError):
    """The server could not be reached or returned a non-JSON payload."""


class ServeRequestError(ValueError):
    """The server answered with an ``{"error": ...}`` response."""


def parse_address(address: str) -> tuple[str, int]:
    """Parse ``host:port`` (optionally ``http://host:port``) into a pair.

    Args:
        address: Server address string.

    Returns:
        ``(host, port)``.

    Raises:
        ValueError: No parsable ``host:port`` in ``address``.
    """
    addr = address.strip()
    if addr.startswith("http://"):
        addr = addr[len("http://"):]
    addr = addr.rstrip("/")
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"server address must be host:port, got {address!r}")
    return host or "127.0.0.1", int(port)


class ServeClient:
    """Client for one serving server.

    Args:
        address: ``host:port`` (or ``http://host:port``) of a running
            :class:`repro_torch.serve.server.BPMFServer`.
        timeout: Per-request socket timeout in seconds.
    """

    def __init__(self, address: str, timeout: float = 60.0):
        self._host, self._port = parse_address(address)
        self._timeout = timeout
        self._conn: http.client.HTTPConnection | None = None

    def close(self) -> None:
        """Close the underlying connection (reopened lazily on next use)."""
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _roundtrip(self, method: str, path: str, body: dict | None) -> dict:
        payload = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if payload else {}
        for attempt in (0, 1):  # one retry on a stale keep-alive connection
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self._timeout
                )
                try:
                    # headers and body go out in separate writes; without
                    # TCP_NODELAY, Nagle + delayed ACK stalls the body ~40ms
                    self._conn.connect()
                    self._conn.sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError as e:
                    self.close()
                    raise ServeConnectionError(
                        f"cannot reach server at {self._host}:{self._port}: {e}"
                    ) from e
            try:
                self._conn.request(method, path, body=payload, headers=headers)
                resp = self._conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException) as e:
                self.close()
                if attempt:
                    raise ServeConnectionError(
                        f"cannot reach server at {self._host}:{self._port}: {e}"
                    ) from e
                continue
            try:
                return json.loads(raw)
            except ValueError as e:
                self.close()
                raise ServeConnectionError(
                    f"non-JSON response (HTTP {resp.status}): {raw[:200]!r}"
                ) from e
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------
    def request(self, payload: dict) -> dict:
        """POST one raw schema request and return the raw response dict.

        Args:
            payload: JSON-able request (``{"rows": ..., "cols": ...}`` or
                ``{"user"/"users": ..., "k": ...}``).

        Returns:
            The response dict — may contain ``"error"`` (the transport
            succeeded; the request was rejected).

        Raises:
            ServeConnectionError: Transport-level failure.
        """
        return self._roundtrip("POST", "/query", payload)

    def _checked(self, payload: dict) -> dict:
        resp = self.request(payload)
        if "error" in resp:
            raise ServeRequestError(resp["error"])
        return resp

    def predict(
        self, rows, cols, return_std: bool = False
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """Remote ``predict`` mirroring the predictor API.

        Args:
            rows: ``[B]`` user ids.
            cols: ``[B]`` movie ids.
            return_std: Also return the predictive std.

        Returns:
            ``[B]`` float32 predictions, or ``(preds, std)``.

        Raises:
            ServeRequestError: The server rejected the request.
            ServeConnectionError: Transport-level failure.
        """
        req = {"rows": np.asarray(rows).tolist(), "cols": np.asarray(cols).tolist()}
        if return_std:
            req["std"] = True
        resp = self._checked(req)
        preds = np.asarray(resp["predictions"], np.float32)
        if return_std:
            return preds, np.asarray(resp["std"], np.float32)
        return preds

    def top_k(self, user, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Remote ``top_k`` mirroring the predictor API.

        Args:
            user: A user id, or a ``[B]`` array of user ids.
            k: Movies to return per user.

        Returns:
            ``(ids, scores)`` — ``[k]`` for a scalar user, ``[B, k]`` for
            a batch.

        Raises:
            ServeRequestError: The server rejected the request.
            ServeConnectionError: Transport-level failure.
        """
        if np.ndim(user) == 0:
            resp = self._checked({"user": int(user), "k": int(k)})
        else:
            resp = self._checked({"users": np.asarray(user).tolist(), "k": int(k)})
        return (np.asarray(resp["items"], np.int32),
                np.asarray(resp["scores"], np.float32))

    def health(self) -> dict:
        """``GET /healthz`` — liveness, artifact metadata, swap generation."""
        return self._roundtrip("GET", "/healthz", None)

    def stats(self) -> dict:
        """``GET /stats`` — batcher occupancy counters + swap state."""
        return self._roundtrip("GET", "/stats", None)
