"""Run one cell of the benchmark once and print its result as the last line of standard output.

    python3 perfbench/run.py --workload ml20m.gibbs --seed 7 --seconds 10 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Set-up (imports, data from the seed, the program's build,
warm-up) is timed from this process's start; the window then runs for
``--seconds``. With ``--trace 1`` the window runs under the profiler and
the line carries the per-layer metrics and a ``breakdown``; with ``--trace
0`` it carries the end-to-end metrics. Every run compares what the
program produced with the plain reference and prints each number compared
beside its limit, as the last lines of standard error and under
``checks``, last in the line.

Exit codes: 0 with a result (``correct`` may be false); 2 without one
(no card, too few cards, or no program in the checkout); 3 when a module
of JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel caches sit at fixed paths inside the checkout
CACHE = ROOT / ".perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import bench

    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("repro_torch") is None:
        print("perfbench: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T0)
    found = bench.forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}, which nothing here may import", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
