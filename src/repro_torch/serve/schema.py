"""Shared serving request/response schema (CLI, JSONL loop, server, client).

The JAX package's wire format, unchanged, so either package's client
speaks to either package's server.

One wire format for every serving entry point: the one-shot CLI, the stdin
JSONL loop, the persistent HTTP server (:mod:`repro_torch.serve.server`) and its
client helpers (:mod:`repro_torch.serve.client`) all parse requests with
:func:`parse_request` and execute them with :func:`run_request` — validation
lives here exactly once.

Request objects (JSON on the wire):

* ``{"rows": [...], "cols": [...], "std": bool?}`` — batched point
  predictions (:class:`PredictRequest`),
* ``{"user": id, "k": n}`` or ``{"users": [...], "k": n}`` — catalog top-k
  (:class:`TopKRequest`).

Responses are plain JSON objects: ``{"predictions": [...], "std"?: [...]}``
for predictions, ``{"user"/"users": ..., "items": ..., "scores": ...}`` for
top-k, ``{"error": "..."}`` on failure. Floats round-trip exactly through
JSON (f32 → f64 repr), so a response compared against an in-process
predictor call is a *bitwise* comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class RequestError(ValueError):
    """A structurally invalid serving request (unknown shape, bad types)."""


@dataclasses.dataclass(frozen=True)
class PredictRequest:
    """Batched ``(user, movie)`` point-prediction request.

    Attributes:
        rows: ``[B]`` int32 user ids.
        cols: ``[B]`` int32 movie ids.
        std: Also return the predictive std over retained samples.
    """

    rows: np.ndarray
    cols: np.ndarray
    std: bool = False

    @property
    def size(self) -> int:
        """Query rows this request contributes to a coalesced batch."""
        return int(self.rows.size)

    def batch_key(self) -> tuple:
        """Coalescing group key — requests with equal keys may share one
        predictor call."""
        return ("predict", self.std)


@dataclasses.dataclass(frozen=True)
class TopKRequest:
    """Catalog top-k request for one user or a batch of users.

    Attributes:
        users: ``[B]`` int32 user ids (``B == 1`` for the scalar form).
        k: Movies to return per user.
        scalar: Request used the scalar ``{"user": id}`` form; the response
            mirrors it (``user``/flat lists instead of ``users``/nested).
    """

    users: np.ndarray
    k: int
    scalar: bool = False

    @property
    def size(self) -> int:
        """Query rows this request contributes to a coalesced batch."""
        return int(self.users.size)

    def batch_key(self) -> tuple:
        """Coalescing group key (top-k batches must share ``k``)."""
        return ("top_k", self.k)


Request = PredictRequest | TopKRequest
"""Union of the parsed request types."""


def _ids(obj: object, what: str) -> np.ndarray:
    if isinstance(obj, (int, np.integer)):
        obj = [obj]
    if not isinstance(obj, (list, tuple, np.ndarray)):
        raise RequestError(f"{what} must be an id list, got {type(obj).__name__}")
    try:
        arr = np.asarray(obj, dtype=np.int64).reshape(-1)
    except (TypeError, ValueError, OverflowError) as e:
        raise RequestError(f"{what} must hold integer ids: {e}") from None
    return arr.astype(np.int32)


def parse_request(obj: object) -> Request:
    """Validate a decoded JSON request into a typed request object.

    Structural validation only (shapes/types); id-range checks against a
    specific catalog happen inside the predictor and surface as
    ``ValueError`` at execution time.

    Args:
        obj: Decoded JSON value (one stdin JSONL line / one HTTP body).

    Returns:
        A :class:`PredictRequest` or :class:`TopKRequest`.

    Raises:
        RequestError: Not a dict, neither request shape, mismatched
            rows/cols lengths, non-integer ids, or a non-positive ``k``.
    """
    if not isinstance(obj, dict):
        raise RequestError(f"request must be a JSON object, got {type(obj).__name__}")
    if "rows" in obj or "cols" in obj:
        rows = _ids(obj.get("rows", ()), "rows")
        cols = _ids(obj.get("cols", ()), "cols")
        if rows.shape != cols.shape:
            raise RequestError(
                f"rows/cols batch mismatch: {rows.size} vs {cols.size}"
            )
        if rows.size == 0:
            raise RequestError("empty prediction batch")
        return PredictRequest(rows=rows, cols=cols, std=bool(obj.get("std", False)))
    if "user" in obj or "users" in obj:
        scalar = "user" in obj
        if scalar and "users" in obj:
            raise RequestError("request must use either 'user' or 'users', not both")
        users = _ids(obj["user"] if scalar else obj["users"], "users")
        if scalar and users.size != 1:
            raise RequestError("'user' must be a single id (use 'users' for a batch)")
        if users.size == 0:
            raise RequestError("empty users batch")
        k = obj.get("k", 10)
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool) or k < 1:
            raise RequestError(f"k must be a positive integer, got {k!r}")
        return TopKRequest(users=users, k=int(k), scalar=scalar)
    raise RequestError("request needs either rows/cols or user/users")


def run_request(predictor, req: Request) -> dict:
    """Execute one parsed request in isolation against a predictor.

    The reference (non-coalesced) execution path: the one-shot CLI and the
    JSONL loop call this directly, and the server's micro-batcher is tested
    bitwise against it.

    Args:
        predictor: A :class:`repro_torch.serve.PosteriorPredictor` (or the
            engine's in-process predictor).
        req: Parsed request.

    Returns:
        The JSON-able response dict.

    Raises:
        ValueError: Out-of-range ids / std-without-samples (predictor-side
            validation).
    """
    if isinstance(req, PredictRequest):
        out = predictor.predict(req.rows, req.cols, return_std=req.std)
        if req.std:
            preds, std = out
            return {"predictions": preds.tolist(), "std": std.tolist()}
        return {"predictions": out.tolist()}
    ids, scores = predictor.top_k(req.users, req.k)
    if req.scalar:
        return {"user": int(req.users[0]), "items": ids[0].tolist(),
                "scores": scores[0].tolist()}
    return {"users": req.users.tolist(), "items": ids.tolist(),
            "scores": scores.tolist()}


def error_response(exc: BaseException) -> dict:
    """Uniform ``{"error": ...}`` response for a failed request.

    Args:
        exc: The exception that aborted the request.

    Returns:
        A JSON-able error dict (``RequestError`` renders without the class
        name; other exceptions keep it for debuggability).
    """
    if isinstance(exc, RequestError):
        return {"error": str(exc)}
    return {"error": f"{type(exc).__name__}: {exc}"}
