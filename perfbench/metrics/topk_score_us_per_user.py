"""Device microseconds per user of the top-k's scores and clamp, over the window's calls.

Reads the predictor's call records (``PosteriorPredictor.calls``,
``repro_torch.trace.CallRecord``, CUDA events around each part of a call):
the newest ``run.counts["calls"]`` records. ``None`` where no such record
is found.
"""
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "predictor"
MOVES = "topk_users_per_s"


def us_per_user(run, field: str):
    """Summed device milliseconds of ``field`` over the window's calls, in microseconds per user."""
    calls = getattr(run.program.get("predictor"), "calls", None)
    n = run.counts.get("calls")
    if not calls or not n:
        return None
    window = [c for c in list(calls)[-n:] if c.clock == "device"]
    users = sum(c.users for c in window)
    return 1e3 * sum(getattr(c, field) for c in window) / users if users else None


def read(run):
    return us_per_user(run, "score_ms")
