"""BPMF engine CLI of the PyTorch port::

    PYTHONPATH=src python -m repro_torch.launch.bpmf --dataset synthetic --sweeps 20
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --K 8 --sweeps 5
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --backend ring --num-shards 2
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --backend posterior_merge --num-partitions 2
    PYTHONPATH=src python -m repro_torch.launch.bpmf --dataset movielens --dataset-path ratings.csv
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --checkpoint-dir /tmp/ck --checkpoint-every 2
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --pipeline-blocks 2 --donate-blocks off
    PYTHONPATH=src python -m repro_torch.launch.bpmf --device cpu --checkpoint-dir /tmp/ck --resume \
        --export-artifact /tmp/art

Prints per-sweep sample and posterior-mean RMSE. ``--resume`` continues
from the latest checkpoint in ``--checkpoint-dir`` with randomness
identical to an uninterrupted run; ``--export-artifact`` writes the
serving artifact after the run (``python -m repro_torch.launch.serve``).
Checkpoints and artifacts are the JAX package's files, so either package
resumes or serves what the other wrote. Runs on the GPU unless ``--device
cpu`` is given, and exits with an error when there is no GPU and no CPU
request. The flags are those of ``python -m repro.launch.bpmf`` that this
port runs, with the same names and defaults, plus ``--device``.
The ring backends put shard d on card ``d % n`` of the n visible cards, so
``--num-shards 4`` on one card runs all four shards there; ``posterior_merge``
places its chains the same way. On one card every backend replays its sweep
as a captured CUDA graph; ``--pipeline-blocks`` and ``--donate-blocks`` set
the block queue's depth and whether blocks hand back the graph's buffers or
copies (the same samples either way).

Multi-process: ``--coordinator host:port --num-processes N --process-id i``
(or the ``REPRO_*`` environment that ``python -m
repro_torch.launch.multiproc`` sets) joins this process to a job of N
(:mod:`repro_torch.launch.hostdevices`); the ring backends then split their
``--num-shards`` over the N processes, and ``posterior_merge`` its chains.
Only process 0 prints and writes the artifact, except that every process of
a ring spread over processes ends with one ``ring traffic:`` line: the bytes
its ring sent to the other processes (rotation and gathers) and staged
through the host. ``--inject-failure SWEEP``
kills the job's last process after that sweep (not under ``--resume``), so
a launcher's elastic restart can be tried end to end.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.bpmf",
        description="Run BPMF Gibbs sampling through the repro_torch engine.",
    )
    p.add_argument("--backend", default="sequential",
                   help="sequential | ring | ring_async | allgather | "
                        "posterior_merge (registry name)")
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | movielens | chembl (registry name)")
    p.add_argument("--dataset-path", default=None, help="file for movielens/chembl loaders")
    p.add_argument("--users", type=int, default=400, help="synthetic: number of users")
    p.add_argument("--movies", type=int, default=300, help="synthetic: number of movies")
    p.add_argument("--nnz", type=int, default=12_000, help="synthetic: number of ratings")
    p.add_argument("--K", type=int, default=16, help="latent rank")
    p.add_argument("--alpha", type=float, default=2.0, help="rating noise precision")
    p.add_argument("--sweeps", type=int, default=50)
    p.add_argument("--sweeps-per-block", type=int, default=8,
                   help="Gibbs sweeps between host reads of the metrics (same samples)")
    p.add_argument("--pipeline-blocks", type=int, default=1,
                   help="block dispatch queue depth: dispatch the next block before "
                        "reading the previous block's metrics (1 = synchronous; same "
                        "samples at every depth)")
    p.add_argument("--donate-blocks", default="auto", choices=["auto", "on", "off"],
                   help="hand the captured sweep's buffers back as the next carry "
                        "(off = copies every block; same samples)")
    p.add_argument("--burn-in", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="split + sampler seed")
    p.add_argument("--num-shards", type=int, default=0,
                   help="distributed shard count (0 = one per visible card; one on the CPU)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="ring_async: ring rotations kept in flight (d >= 1)")
    p.add_argument("--num-partitions", type=int, default=0,
                   help="posterior_merge: independent partition chains "
                        "(0 = one per visible card; one on the CPU)")
    p.add_argument("--merge-method", default="precision", choices=["precision", "pool"],
                   help="posterior_merge: subset-posterior combination "
                        "(precision-weighted Gaussian product or uniform pooling)")
    p.add_argument("--gram-impl", default="auto",
                   choices=["auto", "pallas_fused", "pallas", "xla"],
                   help="Gram dispatch: auto/pallas/pallas_fused = the CUDA kernel "
                        "(plain version on CPU); xla = plain version, CPU only")
    p.add_argument("--export-artifact", default=None,
                   help="after the run, write the posterior serving artifact here "
                        "(consumed by python -m repro_torch.launch.serve)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="sweeps between auto-saves (0 = none)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--sync-checkpoint-writes", action="store_true",
                   help="commit checkpoints synchronously instead of on the "
                        "background writer thread")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu only when asked)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0's store: joins a multi-process job "
                        "(env fallback: REPRO_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count of the multi-process job (env fallback: REPRO_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes) (env fallback: REPRO_PROCESS_ID)")
    p.add_argument("--inject-failure", type=int, default=None, metavar="SWEEP",
                   help="testing: kill the job's last process after SWEEP completes "
                        "(skipped under --resume so an elastic restart does not re-fire it)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.launch.hostdevices import init_multiprocess, process_count, process_index, shutdown

    init_multiprocess(args.coordinator, args.num_processes, args.process_id, device=args.device)

    from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
    from repro_torch.runtime.elastic import FailureInjector, NodeFailure, StepTimer

    say = print if process_index() == 0 else (lambda *a, **kw: None)
    dataset_kw = {}
    if args.dataset == "synthetic":
        dataset_kw = dict(num_users=args.users, num_movies=args.movies, nnz=args.nnz)
    elif args.dataset_path:
        dataset_kw = dict(path=args.dataset_path)
    coo = load_dataset(args.dataset, **dataset_kw)
    cfg = BPMFConfig().replace(
        name=args.backend,
        num_shards=args.num_shards,
        pipeline_depth=args.pipeline_depth,
        num_partitions=args.num_partitions,
        merge_method=args.merge_method,
        gram_impl=args.gram_impl,
        K=args.K,
        alpha=args.alpha,
        num_sweeps=args.sweeps,
        sweeps_per_block=args.sweeps_per_block,
        pipeline_blocks=args.pipeline_blocks,
        donate_blocks=args.donate_blocks,
        burn_in=args.burn_in,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        async_checkpoint_writes=not args.sync_checkpoint_writes,
    )
    engine = BPMFEngine(cfg, device=args.device)
    engine.prepare(coo)
    resumed_at = 0
    if args.resume:
        resumed_at = engine.restore()
        say(f"resumed from checkpoint at sweep {resumed_at}")
    # the straggler watchdog times every sweep; the injector stands in for a
    # preempted process, so a launcher's restart policy can be tried end to end
    timer = StepTimer()
    injector = None
    if args.inject_failure is not None and not args.resume and process_index() == process_count() - 1:
        injector = FailureInjector({args.inject_failure: 1})
    shards = ""
    if hasattr(engine.backend, "num_shards"):
        shards = f" shards={engine.backend.num_shards}"
    elif hasattr(engine.backend, "num_partitions"):
        shards = f" partitions={engine.backend.num_partitions}"
    say(
        f"backend={args.backend}{shards} device={engine.device} processes={process_count()} "
        f"dataset={args.dataset} R: {coo.num_users} x {coo.num_movies}, {coo.nnz} ratings; "
        f"K={cfg.model.K} sweeps={cfg.run.num_sweeps}"
    )
    t0 = time.time()
    t_prev = t0
    for m in engine.sample():
        t_now = time.time()
        timer.record(int(m.sweep), t_now - t_prev)
        t_prev = t_now
        say(f"  sweep {int(m.sweep):4d}  rmse(sample)={m.rmse_sample:.4f}  "
            f"rmse(avg)={m.rmse_avg:.4f}")
        if injector is not None:
            try:
                injector.check(int(m.sweep))
            except NodeFailure as e:
                # die as a preempted process does: no shutdown handshake, no
                # exit handlers; only committed checkpoints survive, which is
                # what the launcher's restart resumes from
                print(f"injected failure at sweep {int(m.sweep)} on process {process_index()}: {e}",
                      flush=True)
                os._exit(1)
    dt = time.time() - t0
    swept = engine.num_sweeps_done - resumed_at  # only what this process ran
    updates = (coo.num_users + coo.num_movies) * swept
    say(
        f"final rmse(avg)={engine.rmse:.4f} after {engine.num_sweeps_done} sweeps "
        f"({swept} this run) in {dt:.2f}s ({updates / max(dt, 1e-9):,.0f} item updates/s)"
    )
    ring = getattr(engine.backend, "ring", None)
    if ring is not None and ring.spans_processes:  # every rank: what its ring sent to the others
        print(f"ring traffic: process {process_index()} of {process_count()} sent "
              f"{ring.rotation_bytes_sent} rotation bytes and {ring.gather_bytes_sent} gather bytes "
              f"to other processes, staged {ring.host_bytes} bytes through the host, in {swept} sweeps",
              flush=True)
    if args.export_artifact:
        path = engine.export(args.export_artifact)  # a collective in a multi-process job
        say(f"exported serving artifact to {path}")
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
