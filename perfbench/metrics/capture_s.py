"""The sweep program's set-up: the eager warm-up sweep and the CUDA graph capture.

``SweepGraph.warmup_seconds + capture_seconds``, spans the program times itself.
"""
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sweep program"
MOVES = "setup_s"


def read(run):
    graph = getattr(getattr(run.program.get("engine"), "backend", None), "graph", None)
    return graph.warmup_seconds + graph.capture_seconds if graph is not None else None
