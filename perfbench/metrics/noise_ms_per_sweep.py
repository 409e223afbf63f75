"""The ``noise`` phase of a captured sweep on the device's clock: the per-item N(0, I) draws of the row updates (``posterior.item_noise``).

Mean over the window's sampled sweeps (see ``replay_ms``).
"""
from perfbench import bench

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Gibbs sweep"
MOVES = "sweep_ms"


def read(run):
    return bench.metric_reader("replay_ms").phase_ms(run, "noise")
