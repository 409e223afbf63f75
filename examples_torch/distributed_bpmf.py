"""Distributed BPMF (the paper's contribution) in the PyTorch port: every backend, one seed.

    PYTHONPATH=src python examples_torch/distributed_bpmf.py                # on the card
    PYTHONPATH=src python examples_torch/distributed_bpmf.py --device cpu

The port's counterpart of ``examples/distributed_bpmf.py``. Runs the same
``(seed, data)`` through the ``repro_torch.bpmf`` engine's backends (the
sequential sampler, the ring with its rotation overlapped with compute,
paper §IV-C, the depth-2 pipelined ring, arXiv:1705.10633, DESIGN.md §7,
and the synchronous all-gather baseline) by changing one config field,
and checks that they reach the same RMSE (paper §V-B). The ring has
``--num-shards`` shards (8, the reference's forced device count), on the
visible cards in turn: on a machine with one card all of them share it.
Each backend's second fit is timed, after the first has captured the
sweep.
"""
import argparse
import time

from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset


def main(argv: list[str] | None = None) -> None:
    """Fit every backend twice, time the second fit, check RMSE parity, print ``ok``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where to run (default cuda)")
    ap.add_argument("--num-shards", type=int, default=8)
    ap.add_argument("--users", type=int, default=2_000)
    ap.add_argument("--movies", type=int, default=500)
    ap.add_argument("--nnz", type=int, default=40_000)
    ap.add_argument("--sweeps", type=int, default=10)
    args = ap.parse_args(argv)

    coo = load_dataset("synthetic", num_users=args.users, num_movies=args.movies, nnz=args.nnz)
    cfg = BPMFConfig().replace(K=16, num_sweeps=args.sweeps, burn_in=2, num_shards=args.num_shards)
    print(f"{args.num_shards} shards on {args.device}; R: {coo.num_users} x {coo.num_movies}, {coo.nnz} ratings")

    rmses = {}
    variants = (("sequential", {}), ("ring", {}), ("ring_async", {"pipeline_depth": 2}), ("allgather", {}))
    for name, extra in variants:
        engine = BPMFEngine(cfg.replace(name=name, **extra), device=args.device)
        engine.prepare(coo)
        if name == "ring":
            plan = engine.backend.plan
            ratios = [f"{p.balance_ratio():.3f}" for p in (plan.part_users, plan.part_movies)]
            print(f"LPT balance ratios (max/mean cost, 1.0=perfect): users={ratios[0]} movies={ratios[1]}")
        engine.fit()  # includes the capture of the sweep on the card
        timed = BPMFEngine(cfg.replace(name=name, **extra), device=args.device)
        timed.prepare(coo)
        t0 = time.perf_counter()
        timed.fit()
        dt = time.perf_counter() - t0
        rmses[name] = engine.rmse
        print(f"{name:10s} rmse={engine.rmse:.4f}  {dt:.2f}s "
              f"({(coo.num_users + coo.num_movies) * cfg.run.num_sweeps / dt:,.0f} updates/s)")

    spread = max(rmses.values()) - min(rmses.values())
    assert spread < 5e-3, f"parity broken! {rmses}"
    print("ok — all versions reach the same RMSE (paper §V-B)")


if __name__ == "__main__":
    main()
