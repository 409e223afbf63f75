"""Device microseconds per user of the top-k's stable sort, over the window's calls (see ``topk_score_us_per_user``)."""
from perfbench import bench

UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "predictor"
MOVES = "topk_users_per_s"


def read(run):
    return bench.metric_reader("topk_score_us_per_user").us_per_user(run, "sort_ms")
