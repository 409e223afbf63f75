#!/usr/bin/env python3
"""Time variants of the port's Gram kernels on one CUDA card, in turns.

    python3 scripts/gram_variants.py     # from the repository root, on a machine with one GPU

Builds ``src/repro_torch/kernels/csrc/bpmf_gram.cu`` as it is and with one
design choice undone, each into ``src/repro_torch/kernels/build/variants/``
(gitignored), and times every variant on the same MovieLens-20M-like shapes
at K = 32 through the wrapper's own launch code, in the order a, b, c, c,
b, a. The variants:

- ``as_built``: the source as it is (128 threads a block, 64-row tiles);
- ``threads_256``: 256 threads a block (half as many blocks fit on an SM);
- ``tile_128``: 128-row shared-memory tiles;

and, for the heavy buckets, the piece width of ``piece_width`` (eight pieces
per SM) against the one that gives four (``pieces_per_sm`` 8 and 4).

Per case it prints the single-call time (CUDA events around one call, the
device idle when it starts, so the host's latency is in it) and the device
time (a CUDA graph of the call, replayed). The shapes: buckets of the users
and movies sides with nnz drawn as the ML20M-like data has them, the heavy
movie buckets, and two ring-step layouts like those of the 4-shard ring
(30,500 short users rows; 6,820 Zipf-sized movies rows). Last it prints the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gram_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.types import Bucket
    from repro_torch.kernels import bpmf_gram as gk
    from repro_torch.kernels import build, ops

    src = (ROOT / "src/repro_torch/kernels/csrc/bpmf_gram.cu").read_text()
    variants = {
        "as_built": src,
        "threads_256": src.replace("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        "tile_128": src.replace("constexpr int kTile = 64;", "constexpr int kTile = 128;"),
    }
    if len({v for v in variants.values()}) != len(variants):
        raise RuntimeError("a variant's substitution no longer matches the source")
    out_dir = ROOT / "src/repro_torch/kernels/build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        gk.load_library = lambda _, path=out_dir / f"{name}.so": build.Library(ctypes.CDLL(str(path)), path, 0.0, "")
        libs[name] = gk._library()

    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    cases = {}

    def bucket(name, Ns, B, P, lo, hi, pieces_per_sm=8):
        X = (0.5 * torch.randn(Ns, 32, generator=gen)).cuda()
        nnz = torch.randint(lo, hi + 1, (B,), generator=gen, dtype=torch.int32).cuda()
        nbr = torch.randint(0, Ns, (B, P), generator=gen, dtype=torch.int32).cuda()
        val = (torch.randn(B, P, generator=gen).cuda() * (torch.arange(P, device="cuda")[None] < nnz[:, None]))
        cases[name] = ("bucket", X, nbr, val.contiguous(), nnz, sms * pieces_per_sm // 8)

    bucket("users P=8", 27_278, 17_228, 8, 1, 8)
    bucket("users P=128", 27_278, 59_711, 128, 33, 128)
    bucket("movies P=512", 138_493, 20_391, 512, 129, 512)
    for P, B in ((16_384, 120), (65_536, 17), (131_072, 5)):
        for per_sm in (8, 4):
            bucket(f"movies P={P} pieces_per_sm={per_sm}", 138_493, B, P, P // 2 + 1, P, per_sm)
    for name, (cap, Ns, sizes) in {
        "ring users layout": (34_624, 6_820, np.clip(rng.lognormal(3.3, 0.8, 30_500), 1, 2000).astype(int)),
        "ring movies layout": (6_824, 34_624, np.clip(1.13e6 / np.arange(1, 6821) ** 0.9 / 9.6, 1, 30_000).astype(int)),
    }.items():
        ids = rng.permutation(cap)[: len(sizes)].astype(np.int32)
        buckets = []
        for lo, P in ((0, 8), (8, 32), (32, 128), (128, 512), (512, 2048), (2048, 8192), (8192, 32_768)):
            sel = np.nonzero((sizes > lo) & (sizes <= P))[0]
            if len(sel):
                nnz = sizes[sel].astype(np.int32)
                val = rng.normal(size=(len(sel), P)).astype(np.float32) * (np.arange(P)[None] < nnz[:, None])
                arrays = (ids[sel], rng.integers(0, Ns, (len(sel), P)).astype(np.int32), val.astype(np.float32), nnz)
                buckets.append(Bucket(*(torch.from_numpy(a).cuda() for a in arrays)))
        X = torch.from_numpy(rng.normal(size=(Ns, 32)).astype(np.float32)).cuda()
        G, g = torch.zeros(cap, 32, 32, device="cuda"), torch.zeros(cap, 32, device="cuda")
        cases[name] = ("layout", X, ops.fused_step(tuple(buckets)), G, g)

    def call(lib, case):
        stream = torch.cuda.current_stream().cuda_stream
        if case[0] == "bucket":
            _, X, nbr, val, nnz, n_sms = case
            return gk._launch_gram(lib, X, nbr, val, nnz, torch.float32, n_sms, stream)
        _, X, step, G, g = case
        return gk._launch_fused(lib, G, g, X, step.nbr, step.val, step.cnt, 2.0, torch.float32, step.order, stream)

    def single_call_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm up off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return single_call_ms(graph.replay)

    order = list(variants) + list(reversed(variants))
    results = {name: {case: [] for case in cases} for name in variants}
    for name in order:
        for case_name, case in cases.items():
            fn = lambda: call(libs[name], case)  # noqa: E731
            results[name][case_name].append((single_call_ms(fn), device_ms(fn)))
    for name in variants:
        print(json.dumps({"variant": name, "ms_single_call_device": {
            case: [[round(a, 4), round(b, 4)] for a, b in runs] for case, runs in results[name].items()}}),
            flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
