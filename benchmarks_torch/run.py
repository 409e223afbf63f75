"""The port's benchmark harness: one driver per paper figure or claim, on the card.

    PYTHONPATH=src:. python -m benchmarks_torch.run [--full] [--only fig3,fig5] [--device cpu]

The port's counterpart of ``benchmarks/run.py``. The default is each
driver's smoke size (written to temporary directories); ``--full`` runs
the full sizes and writes the committed ``experiments/bench_torch/*.json``
(``serve`` then measures ``serve_load`` at ``serve_latency.ML20M_CATALOG``,
the catalog of the committed file). Every driver runs in this process on
``--device`` (the card unless ``cpu`` is given; without a card and without
``--device cpu`` the harness raises before any section); fig4's process
sweep spawns its own jobs. ``--only`` takes a comma list of ``fig2``,
``fig3``, ``fig4``, ``fig5``, ``rmse``, ``merge``, ``serve``,
``throughput`` and ``roofline``. A section that raises is printed and named
in the summary, and the harness then exits 1.

``roofline`` aggregates the dry run's files (``experiments/dryrun_torch/``,
``python -m repro_torch.launch.dryrun --all [--multi-pod]``) into the
reference's table for both production meshes; it needs no card, so
``--only roofline`` runs without one.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Callable

from benchmarks_torch import (
    fig2_item_update,
    fig3_multicore,
    fig4_scaling,
    fig5_overlap,
    fig_merge_comm,
    rmse_convergence,
    roofline,
    serve_latency,
    sweep_throughput,
)
from repro_torch.utils import resolve_device


def _serve(smoke: bool, device) -> str:
    latency = serve_latency.run(smoke=smoke, device=device)
    catalog = [] if smoke else [f"--{k}={v}" for k, v in serve_latency.ML20M_CATALOG.items()]
    load = serve_latency.run(smoke=smoke, device=device, load=True, argv=catalog)
    errors = {c: e["errors"] for c, e in load["load"].items()}
    return f"top_k p99 {latency['top_k']['p99_ms']:.3f} ms; errors per client count under load {errors}"


# section -> (title, driver call returning its one-line summary)
SECTIONS: dict[str, tuple[str, Callable[[bool, object], str]]] = {
    "fig2": ("per-item update cost and the Gram autotuner",
             lambda smoke, dev: f"cost model {fig2_item_update.run(smoke=smoke, device=dev)['cost_model']}"),
    "fig3": ("one half-sweep, bucketed against max-padded",
             lambda smoke, dev: "bucketed-vs-maxpad speedup {:.2f}x".format(
                 fig3_multicore.run(smoke=smoke, device=dev)["results"]["speedup_bucketed_vs_maxpad"])),
    "fig4": ("updates/s against shards, and one ring over processes",
             lambda smoke, dev: "model_matches {}".format(
                 fig4_scaling.run(smoke=smoke, device=dev)["process_sweep"]["ring_bytes_per_sweep"]["model_matches"])),
    "fig5": ("ring against all-gather, and the pipelined ring's depths",
             lambda smoke, dev: "ring_async_bitwise {0[ring_async_bitwise]} parity_ok {0[parity_ok]}".format(
                 fig5_overlap.run(smoke=smoke, device=dev))),
    "rmse": ("every backend reaches the same RMSE",
             lambda smoke, dev: f"parity_ok {rmse_convergence.run(smoke=smoke, device=dev)['parity_ok']}"),
    "merge": ("RMSE against communication",
              lambda smoke, dev: "beats_baseline {0[beats_baseline]} within_band {0[within_band]} "
                                 "zero_comm_ok {0[zero_comm_ok]}".format(fig_merge_comm.run(smoke=smoke, device=dev))),
    "serve": ("serving latency and closed-loop load", _serve),
    "throughput": ("blocked sweep-loop throughput",
                   lambda smoke, dev: f"parity_ok {sweep_throughput.run(smoke=smoke, device=dev)['parity_ok']}"),
    "roofline": ("dry-run aggregation, both production meshes", lambda smoke, dev: _roofline()),
}
NO_DEVICE = {"roofline"}  # sections that need no card


def _roofline() -> str:
    out = []
    for mesh in ("pod16x16", "pod2x16x16"):
        rows, md = roofline.table(mesh)
        print(md)
        if not rows:
            raise RuntimeError(f"no dry-run cells under {roofline.DRYRUN_DIR}/{mesh}")
        out.append(f"{mesh} {sum(r['status'] == 'ok' for r in rows)}/{len(rows)} cells ok")
    return "; ".join(out)


def main(argv: list[str] | None = None) -> int:
    """Run the chosen sections; 1 if any failed, else 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="the full sizes; writes the committed files")
    ap.add_argument("--only", default=None, help=f"comma list of {','.join(SECTIONS)}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    smoke = not args.full
    only = args.only.split(",") if args.only else list(SECTIONS)
    unknown = sorted(set(only) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown section(s) {unknown}; known: {','.join(SECTIONS)}")
    device = resolve_device(args.device) if set(only) - NO_DEVICE else None

    failures = []
    for name in only:
        title, section = SECTIONS[name]
        print(f"\n=== {name}: {title} {'(smoke)' if smoke else '(full)'} ===", flush=True)
        t0 = time.perf_counter()
        try:
            print(f"{name}: {section(smoke, device)}", flush=True)
        except Exception:  # the harness goes on to the next section and exits 1 at the end
            failures.append(name)
            traceback.print_exc()
        print(f"=== {name} done in {time.perf_counter() - t0:.1f}s ===", flush=True)

    print("\n==== benchmark summary ====")
    print("FAILURES:", failures or "none")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
