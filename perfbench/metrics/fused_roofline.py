"""The ring's fused Gram kernels' (``bpmf_gram_fused`` and its reduce pass) share of their roofline.

The same bound as ``gram_roofline``: a sweep's Gram products as the
inputs need them, over the fused kernels' traced device time per sweep.
"""
from perfbench import bench

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Gram kernels"
MOVES = "sweep_ms"
NAMES = ("bpmf_gram_fused",)


def read(run):
    return bench.metric_reader("gram_roofline").roofline_share(run, NAMES)
