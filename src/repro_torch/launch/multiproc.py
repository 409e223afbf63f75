"""Run ``repro_torch.launch.bpmf`` (or ``launch.train``) as a job of N processes on this host (DESIGN.md §14).

    PYTHONPATH=src python -m repro_torch.launch.multiproc --num-processes 2 -- \
        --device cpu --backend ring --num-shards 4 --sweeps 8 \
        --checkpoint-dir /tmp/ck --checkpoint-every 2
    PYTHONPATH=src python -m repro_torch.launch.multiproc --num-processes 4 -- \
        --device cpu --arch gemma-2b --reduced --model-parallel 2

The children run ``repro_torch.launch.train`` (the LM over a mesh of the
job's ranks) when the forwarded arguments name an ``--arch``, else
``repro_torch.launch.bpmf``.

The port's counterpart of ``scripts/launch_multiproc.py``. It spawns N
children with process-major ids 0..N-1 and wires them into one
``torch.distributed`` job through the ``REPRO_COORDINATOR`` (a free
localhost port) / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
environment. Everything after ``--`` goes to every child as it is, so
``--device`` too: on a machine with one card every child runs on
``cuda:0`` (the ranks share the card over ``gloo``). The children's output
is forwarded line by line under a ``[pI]`` prefix.

A child that exits non-zero does not stop its peers by itself (they wait
in their next collective until its timeout), so the launcher kills the
whole gang at the first nonzero exit. With ``--elastic`` it then respawns
the job with ``--resume`` at the layout
:class:`repro_torch.runtime.elastic.RestartPolicy` picks: the largest
smaller process count that divides the same shard count S (the forwarded
``--num-shards``, else ``--num-partitions``, else N). The restarted job
reads its rows from the last committed checkpoint and draws the samples
of an uninterrupted run. The last line is a summary:
``[launcher] done rc=... restarts=... lost_seconds=...``, where
``lost_seconds`` is the wall time of the attempts that failed.
``--num-processes 1`` runs one child with no job (the single-process path).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.multiproc",
        description="Run repro_torch.launch.bpmf (launch.train with --arch) as N local processes "
                    "(the arguments after -- go to every process).",
    )
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--elastic", action="store_true",
                   help="on a child failure, respawn at a smaller process count (same shard "
                        "count) with --resume; needs --checkpoint-dir in the forwarded arguments")
    p.add_argument("--max-restarts", type=int, default=2, help="elastic restarts before giving up")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds before the whole job is killed")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(proc: subprocess.Popen, tag: str) -> None:
    """Forward one child's output line by line under a ``[tag]`` prefix."""
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[{tag}] {line}")
        sys.stdout.flush()


def run_once(num_processes: int, forward: list[str], timeout: float) -> int:
    """One launch of ``num_processes`` children; the first nonzero exit code (124 on timeout), else 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_SRC, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(k, None)
    if num_processes > 1:
        env["REPRO_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
        env["REPRO_NUM_PROCESSES"] = str(num_processes)
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    for i in range(num_processes):
        child_env = dict(env)
        if num_processes > 1:
            child_env["REPRO_PROCESS_ID"] = str(i)
        entry = "repro_torch.launch.train" if any(a == "--arch" or a.startswith("--arch=") for a in forward) \
            else "repro_torch.launch.bpmf"
        proc = subprocess.Popen(
            [sys.executable, "-m", entry, *forward],
            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append(proc)
        pump = threading.Thread(target=_pump, args=(proc, f"p{i}"), daemon=True)
        pump.start()
        pumps.append(pump)
    rc = 0
    try:
        remaining = dict(enumerate(procs))
        t0 = time.monotonic()
        while remaining and rc == 0:
            for i, p in list(remaining.items()):
                child_rc = p.poll()
                if child_rc is None:
                    continue
                del remaining[i]
                if child_rc != 0:
                    rc = child_rc
                    print(f"[launcher] process {i} exited rc={child_rc}; killing its peers", flush=True)
                    break
            if rc == 0 and time.monotonic() - t0 > timeout:
                print("[launcher] timeout; killing the job", flush=True)
                rc = 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            p.wait()
        for pump in pumps:
            pump.join(timeout=5)
    return rc


def _forwarded_int(forward: list[str], flag: str) -> int:
    """The value of ``flag`` among the forwarded arguments (``--flag N`` or ``--flag=N``), 0 if absent."""
    for i, a in enumerate(forward):
        if a == flag and i + 1 < len(forward):
            return int(forward[i + 1])
        if a.startswith(flag + "="):
            return int(a.split("=", 1)[1])
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    own, forward = (argv[: argv.index("--")], argv[argv.index("--") + 1:]) if "--" in argv else (argv, [])
    args = build_parser().parse_args(own)
    if args.elastic and "--checkpoint-dir" not in forward:
        print("--elastic needs --checkpoint-dir (and --checkpoint-every) in the forwarded "
              "arguments, so that the restart has something to resume", file=sys.stderr)
        return 2
    from repro_torch.runtime.elastic import RestartPolicy

    n = args.num_processes
    shards = _forwarded_int(forward, "--num-shards") or _forwarded_int(forward, "--num-partitions") or n
    policy = RestartPolicy(total_devices=shards, max_restarts=args.max_restarts)
    lost = 0.0
    t0 = time.monotonic()
    rc = run_once(n, forward, args.timeout)
    while rc != 0 and args.elastic:
        lost += time.monotonic() - t0
        layout = policy.next_layout(n)
        if layout is None:
            print("[launcher] restart policy exhausted", flush=True)
            break
        n = layout[0]
        print(f"[launcher] elastic restart: {n} processes x {layout[1]} shards, resuming", flush=True)
        resumed = forward if "--resume" in forward else [*forward, "--resume"]
        t0 = time.monotonic()
        rc = run_once(n, resumed, args.timeout)
    print(f"[launcher] done rc={rc} restarts={policy.restarts_done} lost_seconds={lost:.3f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
