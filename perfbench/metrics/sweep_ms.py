"""Wall time of a Gibbs sweep: the window's host-clock seconds over the sweeps it completed.

A sweep counts once its block's metrics have been read back; the window is
whole blocks, so the time covers every sweep's dispatch, device work and
read.
"""
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    sweeps = run.counts.get("sweeps")
    return 1e3 * run.window_s / sweeps if sweeps else None
