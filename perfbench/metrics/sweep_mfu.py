"""A sweep's share of the card's float32 peak: the flops the sweep needs at the cell's shapes over its time.

The flops are :func:`perfbench.work.sweep_flops` (Gram products, each
row's Cholesky, solves and noise, the hyper-parameter statistics, the test
predictions); the time is the traced window's host-clock seconds per sweep.
"""
from perfbench import work

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "Gibbs sweep"
MOVES = "sweep_ms"


def read(run):
    sweeps = run.counts.get("sweeps")
    peak = work.peak(run.device_kind, "f32_flops")
    if not sweeps or peak is None or "n_train" not in run.shapes:
        return None
    s = run.shapes
    flops = work.sweep_flops(s["n_train"], s["n_test"], s["num_users"], s["num_movies"], s["K"])
    return 100.0 * flops * sweeps / (run.window_s * peak)
