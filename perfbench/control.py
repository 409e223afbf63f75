"""Readings that set a cell's limits: the program's numbers on many seeds, and the control's.

    python3 perfbench/control.py --workload ml20m.gibbs --program-seeds 1,2,3 --control-seeds 1,2,3

Not part of a benchmark run. For each program seed it sets the cell up as
a run does (the ratings or posterior from the seed, the program's build,
the checked sweeps, or a short window of top-k calls at the cell's batch)
and prints the comparison's numbers; for each control seed it puts the
reference, computed in TF32 (float32 with every matrix product's inputs
cut to TF32's 10-bit mantissa), in the program's place and prints the same
numbers against the float64 reference. One JSON line per reading, on
standard output and appended to ``--out``.

The lower end of a limit is the largest program reading over a dozen
seeds or more; the upper end the smallest control reading.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def gibbs_readings(ctx, program: bool, control: bool) -> dict:
    from perfbench.reference import bpmf as ref
    from perfbench.windows import gibbs

    import torch

    out = {}
    ratings = None
    if program:
        ratings, engine, sweeps, prog = gibbs.start(ctx)
        del engine, sweeps
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    else:
        from perfbench import datagen

        ratings = datagen.ratings(ctx.cell.config["data"], ctx.seed)
    want = gibbs.reference(ctx, ratings)
    if program:
        out["program"] = gibbs.compare(prog, want)
    if control:
        out["control"] = gibbs.compare(gibbs.reference(ctx, ratings, ref.CONTROL), want)
    return out


def topk_readings(ctx, program: bool, control: bool) -> dict:
    from perfbench.reference import bpmf as ref_bpmf
    from perfbench.reference import topk as ref
    from perfbench.windows import topk

    predictor, batches, factors = topk.start(ctx)
    t = ctx.cell.traffic
    results = []
    for i in range(t["check_calls"] + 1):
        b = i % len(batches)
        results.append((b, *predictor.top_k(batches[b], t["k"])))
    del predictor
    lo, hi = t["rating_range"]
    out = {}
    if program:
        out["program"] = topk.compare(ctx, results, batches, factors)
    if control:
        out["control"] = topk.compare(
            ctx, results, batches, factors,
            ranked=lambda U, V: ref.rank(U, V, t["mean_rating"], lo, hi, t["k"], ref_bpmf.CONTROL),
        )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from perfbench import bench

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.load_cell(args.workload)
    readings = {"gibbs": gibbs_readings, "topk": topk_readings}[cell.traffic["window"]]
    prog = [int(s) for s in args.program_seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in sorted(set(prog) | set(ctrl), key=(prog + ctrl).index):
        t0 = time.perf_counter()
        ctx = bench.Context(cell, seed, 0.0, False, device, t0)
        for side, numbers in readings(ctx, seed in prog, seed in ctrl).items():
            line = json.dumps({"workload": cell.name, "seed": seed, "side": side, **numbers,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
