"""The row draws' share of their roofline: the least time the card needs for a sweep's row draws over
the phase clock's ``solve`` milliseconds.

A sweep draws every row of both sides once. A row's draw needs
:func:`perfbench.work.row_draw_flops` flops and 4 (K^2 + 2K) bytes: its
K x K precision and its linear term read once, its draw written once
(:func:`need`). The ``solve`` phase (``replay_ms.phase_ms``) holds G +
Lambda, the factorizations, both solves and the scatter; the noise draw is
a phase of its own. ``None`` without phase records, and where the captured
sweep factored fewer matrices than the two sides have rows (the graph's
``factor_rows_per_replay``, which a program without the counter lacks), so
a sweep that skipped rows cannot read high.
"""
from perfbench import bench, work

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "Gibbs sweep"
MOVES = "sweep_ms"


def need(rows: int, K: int) -> tuple[float, float]:
    """(bytes, flops) of drawing ``rows`` rows at rank ``K`` from their Gram terms."""
    return 4.0 * (K * K + 2 * K) * rows, rows * work.row_draw_flops(K)


def read(run):
    s = run.shapes
    if "K" not in s:
        return None
    rows = s["num_users"] + s["num_movies"]
    graph = getattr(getattr(run.program.get("engine"), "backend", None), "graph", None)
    factored = getattr(graph, "factor_rows_per_replay", None)
    if factored is None or factored < rows:
        return None
    solve_ms = bench.metric_reader("replay_ms").phase_ms(run, "solve")
    bound = work.roofline_s(*need(rows, s["K"]), run.device_kind)
    if not solve_ms or bound is None:
        return None
    return 100.0 * bound * 1e3 / solve_ms
