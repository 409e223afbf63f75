"""Shared utilities of the port's benchmark scripts: result IO and the device record.

The scripts import ``repro_torch`` only, run on the card unless given
``--device cpu``, and write ``experiments/bench_torch/<name>.json``. A
smoke run never writes the committed file: without an explicit ``--out``
it writes to a temporary directory (:func:`smoke_out_path`).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import torch

from repro_torch.utils import device_line

OUT_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments",
                                        "bench_torch"))


def save_result(name: str, payload: dict[str, Any], out: str | None = None) -> str:
    """Write a benchmark payload as JSON; returns the path.

    The default target is the committed ``experiments/bench_torch/<name>.json``;
    smoke runs pass ``out`` (:func:`smoke_out_path`) so that they never
    overwrite the committed numbers.
    """
    path = out or os.path.join(OUT_DIR, f"{name}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return os.path.normpath(path)


def smoke_out_path(name: str, smoke: bool, out: str | None) -> str | None:
    """A benchmark's output path under the smoke contract.

    An explicit ``out`` always wins; a smoke run without one writes to a
    fresh temporary directory; a full run to the committed file (``None``).
    """
    if out:
        return out
    if smoke:
        return os.path.join(tempfile.mkdtemp(prefix=f"bench-{name}-"), f"{name}.json")
    return None


def device_record(device: torch.device) -> dict[str, Any]:
    """What every payload says about where it ran: ``device`` (``"gpu"``/``"cpu"``), the card line, the count."""
    cuda = device.type == "cuda"
    return {"device": "gpu" if cuda else device.type, "card": device_line(device),
            "devices": torch.cuda.device_count() if cuda else 1}
