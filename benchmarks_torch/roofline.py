"""Roofline aggregator: the dry run's JSONs -> the per-cell table.

    PYTHONPATH=src:. python -m benchmarks_torch.roofline [--mesh pod16x16] [--out roofline.json]

The port's counterpart of ``benchmarks/roofline.py``, with its columns:
per (arch x shape) the three roofline terms in seconds, the dominant term,
MODEL_FLOPS / traced flops, the HBM peak and whether it fits, and the
roofline fraction, read from ``experiments/dryrun_torch/<mesh>/*.json``
(``python -m repro_torch.launch.dryrun --all [--multi-pod]`` writes them;
the terms are predictions at the H100's datasheet rates, not times). No
card is needed: pure JSON aggregation. ``--out`` also writes the rows and
the markdown table as JSON.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from benchmarks_torch.common import save_result

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments", "dryrun_torch")


def load_cells(mesh: str, root: str | None = None) -> list[dict]:
    """Every cell's JSON under ``<root>/<mesh>/``, in file-name order."""
    cells = []
    for path in sorted(glob.glob(os.path.join(root or DRYRUN_DIR, mesh, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def table(mesh: str = "pod16x16", root: str | None = None) -> tuple[list[dict], str]:
    """(rows, markdown table) of the cells of ``mesh``; a failed cell is a ``FAILED`` row."""
    cells = load_cells(mesh, root)
    rows, lines = [], []
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "useful | HBM GB | fits | roofline frac |")
    lines += [hdr, "|" + "---|" * 10]
    for c in cells:
        if c.get("status") != "ok":
            lines.append(f"| {c['arch']} | {c['shape']} | FAILED: {c.get('error', '')[:60]} |" + " |" * 7)
            rows.append({"arch": c["arch"], "shape": c["shape"], "status": "error"})
            continue
        r = c["roofline"]
        mem_gb = r["memory"]["peak_bytes_est"] / 1e9
        rows.append({
            "arch": c["arch"], "shape": c["shape"], "status": "ok",
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "hbm_gb": mem_gb, "fits_hbm": r["fits_hbm"],
            "roofline_fraction": r["roofline_fraction"], "trace_s": c.get("trace_s"),
        })
        u = r["useful_flops_ratio"]
        lines.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant'].replace('_s', '')} "
            f"| {u:.3f} | {mem_gb:.2f} | {'Y' if r['fits_hbm'] else 'N'} "
            f"| {r['roofline_fraction']:.4f} |"
        )
    return rows, "\n".join(lines)


def main(argv=None) -> int:
    """Print the table of ``--mesh``; with ``--out``, also write it as JSON."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="pod16x16", help="pod16x16 or pod2x16x16")
    ap.add_argument("--dir", default=None, help="the dry run's output root (default experiments/dryrun_torch)")
    ap.add_argument("--out", default=None, help="also write the rows and the table to this JSON file")
    args = ap.parse_args(argv)
    rows, md = table(args.mesh, args.dir)
    print(md)
    if args.out:
        save_result(f"roofline_{args.mesh}", {"rows": rows, "markdown": md}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
