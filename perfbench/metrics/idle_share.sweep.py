"""The card's idle share of the traced sweep window: one less the union of its operations over the window."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "sweep_ms"


def read(run):
    if run.kind != "gibbs" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
