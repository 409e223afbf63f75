"""The bucketed Gram kernels' share of their roofline: the least time the card needs for a sweep's
Gram products (:func:`perfbench.work.sweep_gram_need`, float32 peak and HBM bandwidth) over the
kernels' traced device time per sweep."""
from perfbench import bench, work

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Gram kernels"
MOVES = "sweep_ms"


def roofline_share(run, names):
    per_sweep = bench.metric_reader("gram_ms_per_sweep").device_s_per_sweep(run, names)
    if not per_sweep or "n_train" not in run.shapes:
        return None
    s = run.shapes
    bound = work.roofline_s(*work.sweep_gram_need(s["n_train"], s["num_users"], s["num_movies"], s["K"]),
                            run.device_kind)
    return 100.0 * bound / per_sweep if bound is not None else None


def read(run):
    return roofline_share(run, bench.metric_reader("gram_ms_per_sweep").NAMES)
