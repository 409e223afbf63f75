#!/usr/bin/env python3
"""Which collectives run on tensors of the card for ranks that share it over ``gloo``.

    PYTHONPATH=src python3 scripts/lm_mesh_probe.py [--device cuda|cpu] [--processes 2]

Spawns gangs of ``--processes`` ranks of itself, joined as
``launch/multiproc.py``'s children are
(:func:`repro_torch.launch.hostdevices.init_multiprocess`), so on a
machine with one card every rank sits on ``cuda:0`` under ``gloo``. The
gangs (``--groups``, all three by default) run one after the other, so that
a rank killed by one check does not hide the others:

* ``dtensor``: ``torch.distributed.tensor``'s ``redistribute`` of
  ``Shard(0) -> Replicate``, ``Partial -> Replicate`` and
  ``Partial -> Shard(0)`` on a 1-D ``DeviceMesh``, each with its backward;
* ``native``: the raw collectives handed a tensor of the device:
  ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single`` and ``broadcast``;
  also ``all_gather`` and ``all_reduce`` of ``bfloat16`` tensors;
* ``port``: the port's own collectives
  (:mod:`repro_torch.models.collectives`), forward and backward;
* ``timing`` (not in the default set): CUDA tensors of 4, 32 and 256 MiB
  (float32 and bfloat16) all-gathered and all-reduced two ways, handed to
  ``gloo`` as they are and staged by hand through pinned host memory;
  each check's ``ms`` is the median of 5 timed calls after one warm-up,
  the slowest rank's, and the two ways alternate call by call.

``--groups port+native`` runs both in one gang, the port's checks first.

Each result is held to the one-process result computed from the same
seed. Each rank appends one JSON line per finished check to a file, so a
check that kills its rank is reported as ``crashed`` with the signal. The
last line is ``{"probe": ..., "checks": {name: "ok" | "wrong" | "error:
..." | "crashed: ..."}}``. The script exits 0 whatever the checks give: it
reports, the design reads the report.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("dtensor", "native", "port")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _checks(group: str, dev, r: int, n: int) -> dict:
    """name -> fn() returning the max abs error against the one-process result."""
    import torch
    import torch.distributed as dist

    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * n, 6, generator=g, dtype=torch.float64).float()
    parts = torch.randn(n, 4 * n, 6, generator=g, dtype=torch.float64).float()  # rank i's partial sum
    cot = torch.randn(4 * n, 6, generator=g, dtype=torch.float64).float()  # a cotangent
    c = full.shape[0] // n
    mine = slice(r * c, (r + 1) * c)

    def err(a, b) -> float:
        if a.device != dev:
            raise RuntimeError(f"result on {a.device}, not {dev}")
        return float((a.detach().cpu() - b).abs().max())

    if group == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("model",))

        def run(local, src, dst, want, cot_out, want_grad) -> float:
            local = local.to(dev).requires_grad_()
            out = DTensor.from_local(local, mesh, [src]).redistribute(mesh, [dst]).to_local()
            (out * cot_out.to(dev)).sum().backward()
            return max(err(out, want), err(local.grad, want_grad))

        return {
            "dtensor_shard_to_replicate": lambda: run(full[mine], Shard(0), Replicate(), full, cot, cot[mine]),
            "dtensor_partial_to_replicate": lambda: run(parts[r], Partial(), Replicate(), parts.sum(0), cot, cot),
            "dtensor_partial_to_shard": lambda: run(parts[r], Partial(), Shard(0), parts.sum(0)[mine], cot[mine],
                                                    cot),
        }
    if group == "native":
        def all_reduce() -> float:
            x = parts[r].to(dev).clone()
            dist.all_reduce(x)
            return err(x, parts.sum(0))

        def all_gather_into_tensor() -> float:
            out = torch.empty(full.shape, device=dev)
            dist.all_gather_into_tensor(out, full[mine].to(dev).contiguous())
            return err(out, full)

        def reduce_scatter_tensor() -> float:
            out = torch.empty(c, 6, device=dev)
            dist.reduce_scatter_tensor(out, parts[r].to(dev).contiguous())
            return err(out, parts.sum(0)[mine])

        def all_to_all_single() -> float:
            out = torch.empty(full.shape, device=dev)
            dist.all_to_all_single(out, parts[r].to(dev).contiguous())
            return err(out, torch.cat([parts[i][mine] for i in range(n)]))

        def broadcast() -> float:
            x = (full if r == 0 else torch.zeros_like(full)).to(dev)
            dist.broadcast(x, 0)
            return err(x, full)

        def all_gather_bf16() -> float:
            outs = [torch.empty(c, 6, device=dev, dtype=torch.bfloat16) for _ in range(n)]
            dist.all_gather(outs, full[mine].to(dev, torch.bfloat16).contiguous())
            return err(torch.cat(outs).float(), full.bfloat16().float())

        def all_reduce_bf16() -> float:
            x = parts[r].to(dev, torch.bfloat16)
            dist.all_reduce(x)
            return err(x.float(), parts.bfloat16().float().sum(0).bfloat16().float())  # one rounding of 2 terms

        return {"native_all_reduce": all_reduce, "native_all_gather_into_tensor": all_gather_into_tensor,
                "native_reduce_scatter_tensor": reduce_scatter_tensor,
                "native_all_to_all_single": all_to_all_single, "native_broadcast": broadcast,
                "native_all_gather_bf16": all_gather_bf16, "native_all_reduce_bf16": all_reduce_bf16}
    if group == "timing":
        import time

        def staged(x, fn):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            return fn(host).to(dev, non_blocking=True)

        def gather(x):
            outs = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(outs, x)
            return torch.cat(outs)

        def reduce(x):
            x = x.clone()
            dist.all_reduce(x)
            return x

        def timed(op, dtype, mib):
            def run() -> dict:
                numel = (mib << 20) // torch.empty((), dtype=dtype).element_size()
                x = torch.full((numel,), float(r + 1), dtype=dtype, device=dev)
                ways = {"gloo": op, "staged": lambda t: staged(t, op)}
                ms: dict = {w: [] for w in ways}
                for i in range(6):
                    for w, fn in (ways.items() if i % 2 else reversed(ways.items())):
                        torch.cuda.synchronize(dev)
                        t0 = time.perf_counter()
                        out = fn(x)
                        torch.cuda.synchronize(dev)
                        if i:
                            ms[w].append((time.perf_counter() - t0) * 1e3)
                        if op is reduce:
                            e = float((out.float() - n * (n + 1) // 2).abs().max())
                        else:
                            e = float((out.view(n, -1)[:, 0].float().cpu() - torch.arange(1, n + 1)).abs().max())
                        if e:
                            return {"max_abs_err": e}
                return {"max_abs_err": 0.0, "ms": {w: sorted(v)[2] for w, v in ms.items()}, "bytes": x.nbytes}
            return run

        return {f"{name}_{str(dtype)[6:]}_{mib}MiB": timed(op, dtype, mib)
                for name, op in (("all_gather", gather), ("all_reduce", reduce))
                for dtype in (torch.float32, torch.bfloat16) for mib in (4, 32, 256)}
    from repro_torch.models import collectives as C

    group_all = C.Mesh.create((n,), ("model",)).group(("model",))

    def run(fn, local, want, cot_out, want_grad) -> float:
        local = local.to(dev).requires_grad_()
        out = fn(local)
        (out * cot_out.to(dev)).sum().backward()
        return max(err(out, want), err(local.grad, want_grad))

    # exact adjoints: gather <-> reduce-scatter, all-reduce <-> all-reduce
    return {
        "port_all_gather": lambda: run(lambda t: C.all_gather(t, 0, group_all), full[mine], full,
                                         cot, n * cot[mine]),
        "port_reduce_scatter": lambda: run(lambda t: C.reduce_scatter(t, 0, group_all), parts[r],
                                             parts.sum(0)[mine], cot[mine], cot),
        "port_all_reduce": lambda: run(lambda t: C.all_reduce(t, group_all), parts[r], parts.sum(0),
                                         cot, n * cot),
    }


def rank_main(device: str, group: str, out_path: str) -> None:
    import faulthandler

    import torch

    from repro_torch.launch.hostdevices import init_multiprocess, process_count, process_index, shutdown

    faulthandler.enable()
    init_multiprocess(device=device, timeout_s=120)
    r, n = process_index(), process_count()
    dev = torch.device("cuda", torch.cuda.current_device()) if device.startswith("cuda") else torch.device("cpu")
    checks = {name: fn for g in group.split("+") for name, fn in _checks(g, dev, r, n).items()}
    for name, fn in checks.items():
        with open(out_path, "a") as f:
            f.write(json.dumps({"rank": r, "check": name, "started": True}) + "\n")
        try:
            e = fn()
            e = e if isinstance(e, dict) else {"max_abs_err": e}
            res = {"ok": e["max_abs_err"] < 1e-5, **e}
        except Exception as exc:  # the report is the product: every failure is recorded
            res = {"ok": False, "error": f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"}
        with open(out_path, "a") as f:
            f.write(json.dumps({"rank": r, "check": name, **res}) + "\n")
        torch.distributed.barrier()
    shutdown()


def run_group(device: str, processes: int, group: str, tmp: str) -> dict:
    """One gang for ``group``; check name -> verdict."""
    out_path = os.path.join(tmp, f"{group}.jsonl")
    env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{_free_port()}", REPRO_NUM_PROCESSES=str(processes))
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_ROOT, "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    cmd = [sys.executable, os.path.abspath(__file__), "--device", device, "--processes", str(processes),
           "--group", group, "--out", out_path]
    procs = [subprocess.Popen(cmd, env=dict(env, REPRO_PROCESS_ID=str(i)), stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL) for i in range(processes)]
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = [json.loads(x) for x in open(out_path)] if os.path.exists(out_path) else []
    if not lines:
        return {group: f"crashed before any check: rank exit codes {rcs}"}
    started = {(r["rank"], r["check"]) for r in lines if r.get("started")}
    done = {(r["rank"], r["check"]): r for r in lines if not r.get("started")}
    verdict: dict = {}
    for name in dict.fromkeys(r["check"] for r in lines):
        recs = [done.get(key) for key in sorted(started) if key[1] == name]
        if any(r is None for r in recs):
            verdict[name] = f"crashed: rank exit codes {rcs}"
        elif any("error" in r for r in recs):
            verdict[name] = "error: " + next(r["error"] for r in recs if "error" in r)
        elif all(r["ok"] for r in recs) and "ms" in recs[0]:
            verdict[name] = {"verdict": "ok", "bytes": recs[0]["bytes"],
                             "ms": {w: max(r["ms"][w] for r in recs) for w in recs[0]["ms"]}}
        elif all(r["ok"] for r in recs):
            verdict[name] = "ok"
        else:
            verdict[name] = f"wrong: max_abs_err {max(r['max_abs_err'] for r in recs)}"
    return verdict


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--group", help="(a rank) the groups its gang runs, joined by +")
    p.add_argument("--groups", default=",".join(GROUPS),
                   help="the gangs to run, comma-separated; groups joined by + share one gang, in order")
    p.add_argument("--out")
    args = p.parse_args()
    if os.environ.get("REPRO_PROCESS_ID") is not None:
        rank_main(args.device, args.group, args.out)
        return 0
    import torch

    checks: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for group in args.groups.split(","):
            checks.update(run_group(args.device, args.processes, group, tmp))
    print(json.dumps({
        "probe": "lm_mesh", "device": args.device, "processes": args.processes, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "gpu": torch.cuda.get_device_name(0) if args.device.startswith("cuda") else None, "checks": checks,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
