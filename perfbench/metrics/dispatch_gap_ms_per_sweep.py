"""Host-clock time per sweep outside the captured sweep's device wall: launches, block dispatch, metrics read.

The window's host seconds per sweep less ``replay_ms``, so the two add up
to the window's milliseconds per sweep.
"""
from perfbench import bench

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "sweep_ms"


def read(run):
    replay = bench.metric_reader("replay_ms").read(run)
    sweeps = run.counts.get("sweeps")
    return 1e3 * run.window_s / sweeps - replay if replay is not None and sweeps else None
