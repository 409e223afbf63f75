"""The card's peak allocated memory over set-up and window (``torch.cuda.max_memory_allocated``), in 1e9 bytes.

Read before the comparison runs, so the reference never sets it.
"""
UNIT = "GB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.peak_bytes / 1e9
