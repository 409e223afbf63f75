"""The top-k calls' share of the card's float32 peak: ``2 B N K`` flops a call over its traced time."""
from perfbench import work

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "predictor"
MOVES = "topk_users_per_s"


def read(run):
    users = run.counts.get("users")
    peak = work.peak(run.device_kind, "f32_flops")
    if run.kind != "topk" or not users or peak is None:
        return None
    s = run.shapes
    return 100.0 * work.topk_flops(users, s["num_movies"], s["K"]) / (run.window_s * peak)
