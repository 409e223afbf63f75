"""Device kernels per sweep in the traced window (copies and fills not counted)."""
UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "sweep program"
MOVES = "sweep_ms"


def read(run):
    sweeps = run.counts.get("sweeps")
    if run.trace is None or not sweeps:
        return None
    return len(run.trace.kernels()) / sweeps
