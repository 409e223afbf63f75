"""Device time of the bucketed Gram kernels (``bpmf_gram`` and its reduce pass) per sweep, traced."""
NAMES = ("bpmf_gram_kernel", "bpmf_gram_reduce_kernel")
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Gram kernels"
MOVES = "sweep_ms"


def device_s_per_sweep(run, names):
    """Summed device seconds of kernels whose names contain one of ``names``, per traced sweep."""
    sweeps = run.counts.get("sweeps")
    if run.trace is None or not sweeps:
        return None
    ns = sum(b - a for _, a, b in run.trace.kernels(*names))
    return ns * 1e-9 / sweeps if ns else None


def read(run):
    s = device_s_per_sweep(run, NAMES)
    return 1e3 * s if s else None
