"""The program's host build of the data layout: split, centring, bucketing or the ring's partition.

``Backend.prepare_seconds["build"]``, a span the program times itself.
"""
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "data layout"
MOVES = "setup_s"


def read(run):
    engine = run.program.get("engine")
    seconds = getattr(getattr(engine, "backend", None), "prepare_seconds", None)
    return seconds.get("build") if seconds else None
