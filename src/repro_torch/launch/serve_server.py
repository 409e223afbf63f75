"""Persistent BPMF serving server CLI.

Serves concurrent ``predict``/``top_k`` queries over an exported artifact
(either package's) with adaptive micro-batching and zero-downtime artifact
hot-swap (DESIGN.md §11), on one device::

    python -m repro_torch.launch.serve_server --artifact /tmp/bpmf-art --port 8642

    # then, from anywhere:
    python -m repro_torch.launch.serve --server 127.0.0.1:8642 --user 7 --top-k 10
    curl -s -XPOST -d '{"rows": [0], "cols": [5]}' 127.0.0.1:8642/query
    curl -s 127.0.0.1:8642/healthz

Re-exporting into the same artifact directory (e.g. ``python -m
repro_torch.launch.bpmf ... --export-artifact <same dir>`` after more sweeps)
hot-swaps the live posterior without dropping a request: the watcher
validates the fresh export, warms it, and swaps it in between
micro-batches. ``--port 0`` binds an ephemeral port (printed on stderr).
The flags are those of ``python -m repro.launch.serve_server``, with
``--device cuda|cpu`` (default ``cuda``) in place of ``--devices``; with no
GPU and no ``--device cpu`` the CLI exits with the error of
``repro_torch.launch.bpmf``. ``--topk-mode sharded`` scans the catalog
split into one item shard per visible card and merges the shards'
candidates (the same answers as ``replicated``).
"""
from __future__ import annotations

import argparse
import signal
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_server",
        description="Persistent micro-batching BPMF serving server.",
    )
    p.add_argument("--artifact", required=True,
                   help="artifact directory written by BPMFEngine.export(); "
                        "also the directory watched for hot-swap re-exports")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=8642,
                   help="bind port (0 = ephemeral, printed on stderr)")
    p.add_argument("--deadline-ms", type=float, default=2.0,
                   help="micro-batch coalescing deadline (max added latency)")
    p.add_argument("--max-batch", type=int, default=1024,
                   help="coalesced query-row cap per dispatch cycle")
    p.add_argument("--no-adaptive", action="store_true",
                   help="always wait the full deadline (default: skip the "
                        "wait while traffic is sparse)")
    p.add_argument("--topk-mode", choices=("auto", "replicated", "sharded"),
                   default="auto",
                   help="catalog top-k execution: the scan on this device (replicated), "
                        "one item shard per visible card (sharded), or sharded for "
                        "several cards and 1,024+ items (auto)")
    p.add_argument("--no-watch", action="store_true",
                   help="disable the artifact hot-swap watcher")
    p.add_argument("--poll-interval", type=float, default=1.0,
                   help="hot-swap watcher poll cadence in seconds")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to serve (default cuda; cpu only when asked)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.serve import ArtifactError, BPMFServer
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)  # no GPU and no --device cpu: raise

    try:
        server = BPMFServer(
            args.artifact,
            host=args.host,
            port=args.port,
            deadline_ms=args.deadline_ms,
            max_batch=args.max_batch,
            adaptive=not args.no_adaptive,
            topk_mode=args.topk_mode,
            watch=not args.no_watch,
            poll_interval_s=args.poll_interval,
            device=device,
        )
    except ArtifactError as e:
        print(f"cannot load artifact: {e}", file=sys.stderr)
        return 1

    def _graceful(signum, frame):
        server.shutdown()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    host, port = server.start()
    meta = server.handle.get().meta
    print(
        f"serving {args.artifact} on http://{host}:{port} "
        f"(R {meta.num_users} x {meta.num_movies}, K={meta.K}, "
        f"backend={meta.backend}, topk_mode={args.topk_mode}, "
        f"deadline={args.deadline_ms}ms, device={device}, "
        f"watch={'off' if args.no_watch else 'on'})",
        file=sys.stderr, flush=True,
    )
    try:
        server.serve_forever()
    finally:
        server.shutdown()
    print("server stopped cleanly", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
