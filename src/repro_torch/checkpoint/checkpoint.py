"""Checkpoints on disk with an atomic commit, in the JAX package's format.

Layout (one directory per step), byte for byte that of
``repro.checkpoint.checkpoint``::

    <dir>/step_000100.tmp-<nonce>/     # written here first
        manifest.json                  # step, and each leaf's name, shape, dtype
        <leaf-name>.npy                # one file per leaf
    <dir>/step_000100/                 # atomic rename on commit
    <dir>/LATEST                       # text file: committed step number

A checkpoint is a flat, ordered mapping of leaf names to arrays: the
caller names the leaves (the engine from an explicit table) and the
manifest lists them in the order given. This port writes from a single
process. It also *reads* the per-shard leaves that a multi-process JAX
job writes (``<leaf>.shard-<start>_<stop>[-...].npy`` with ``"sharded":
true`` in the manifest), reassembling the global array on the host, so a
checkpoint from any JAX process count restores here. Writing sharded
leaves comes with multi-process runs (ROADMAP Queue 1 item 9).

Atomicity: the tmp directory is renamed to its final name only after every
leaf and the manifest are on disk, and ``LATEST`` is replaced after the
rename, so a killed process never leaves a half-readable "latest"
checkpoint.
"""
from __future__ import annotations

import json
import os
import secrets
import shutil
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch

_MANIFEST = "manifest.json"


class CheckpointError(Exception):
    """Base class of the typed checkpoint read failures.

    Callers (the engine, the artifact loader) tell "not a checkpoint"
    (``FileNotFoundError``) from "damaged" (:class:`CheckpointCorruptError`)
    from "a different schema" (:class:`CheckpointSchemaError`).
    """


class CheckpointCorruptError(CheckpointError):
    """A committed checkpoint is unreadable: truncated leaf file, garbage
    manifest, or an unparsable ``LATEST`` pointer."""


class CheckpointSchemaError(CheckpointError, ValueError):
    """The checkpoint is readable but lacks leaves the restore asks for
    (schema drift). Subclasses ``ValueError``, as in the JAX package."""


def host_snapshot_leaf(x: Any) -> np.ndarray:
    """A host copy of one leaf, taken now.

    A tensor is copied to the host on the current stream of its device, so
    a later in-place update of the tensor (the posterior sums are updated in
    place) cannot reach a write still in flight; a CPU tensor is copied too.
    A numpy array is written as it is: the caller hands over one it does
    not change afterwards.
    """
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _parse_shard_ranges(fname: str, name: str) -> tuple[tuple[int, int], ...]:
    body = fname[len(name) + len(".shard-") : -len(".npy")]
    if body == "scalar":
        return ()
    return tuple(
        (int(a), int(b)) for a, b in (part.split("_") for part in body.split("-"))
    )


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, leaves: Mapping[str, Any]) -> str:
    """Write ``leaves`` for ``step``; atomic commit; returns the final path.

    Args:
        directory: Checkpoint root (created if needed).
        step: Step number; the directory is ``step_<08d>``. Saving a step
            again replaces it.
        leaves: Leaf name -> array (numpy or tensor), in manifest order.

    Returns:
        The committed step directory.
    """
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = f"{final}.tmp-{secrets.token_hex(4)}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in leaves.items():
        arr = host_snapshot_leaf(leaf)
        np.save(os.path.join(tmp, f"{name}.npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # re-save of the same step: replace
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(directory, f".LATEST-{secrets.token_hex(4)}")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    """The committed step ``LATEST`` points at, or ``None`` without one.

    Raises:
        CheckpointCorruptError: ``LATEST`` holds no integer.
    """
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = f.read().strip()
    try:
        return int(raw)
    except ValueError as e:
        raise CheckpointCorruptError(
            f"unparsable LATEST pointer {path!r}: {raw[:40]!r}"
        ) from e


def _assemble_sharded_leaf(final: str, entry: dict) -> np.ndarray:
    """Reassemble a ``"sharded": true`` leaf from its shard files."""
    name = entry["name"]
    shape = tuple(int(d) for d in entry["shape"])
    dtype = np.dtype(entry["dtype"])
    prefix = f"{name}.shard-"
    files = [f for f in os.listdir(final) if f.startswith(prefix) and f.endswith(".npy")]
    if not files:
        raise CheckpointCorruptError(
            f"sharded checkpoint leaf {name!r} has no shard files under {final}"
        )
    out = np.zeros(shape, dtype)
    covered = np.zeros(shape, bool)
    for fname in files:
        try:
            ranges = _parse_shard_ranges(fname, name)
            block = np.load(os.path.join(final, fname))
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint shard {os.path.join(final, fname)}: {e}"
            ) from e
        sl = tuple(slice(a, b) for a, b in ranges)
        out[sl] = block
        covered[sl] = True
    if not covered.all():
        raise CheckpointCorruptError(
            f"sharded checkpoint leaf {name!r} under {final} has gaps: "
            f"{int(covered.size - covered.sum())} of {covered.size} elements "
            f"missing (a writer process died before the commit barrier?)"
        )
    return out


def restore_checkpoint(
    directory: str, target: Iterable[str], step: Optional[int] = None
) -> dict[str, np.ndarray]:
    """Read the leaves named in ``target`` from a committed checkpoint.

    Args:
        directory: Checkpoint root.
        target: Leaf names to read (a mapping's keys serve too). The
            checkpoint may hold more; the shapes are whatever it holds.
        step: Step to read; ``None`` reads the one ``LATEST`` points at.

    Returns:
        Leaf name -> host numpy array, in ``target`` order.

    Raises:
        FileNotFoundError: No committed checkpoint, or none at ``step``.
        CheckpointCorruptError: Unreadable manifest or leaf file.
        CheckpointSchemaError: A named leaf is not in the checkpoint.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    final = _step_dir(directory, step)
    if not os.path.isdir(final):
        raise FileNotFoundError(f"no checkpoint directory {final}")
    manifest_path = os.path.join(final, _MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {manifest_path}: {e}"
        ) from e
    if not isinstance(manifest, dict) or not isinstance(manifest.get("leaves"), list):
        raise CheckpointCorruptError(f"checkpoint manifest {manifest_path} has no leaf table")
    by_name = {e["name"]: e for e in manifest["leaves"] if isinstance(e, dict)}

    names = list(target)
    missing = [n for n in names if n not in by_name]
    if missing:
        raise CheckpointSchemaError(f"checkpoint {final} missing leaves: {missing[:5]}...")
    out = {}
    for name in names:
        leaf_path = os.path.join(final, f"{name}.npy")
        if os.path.exists(leaf_path):
            try:
                out[name] = np.load(leaf_path)
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"unreadable checkpoint leaf {leaf_path} (truncated or overwritten?): {e}"
                ) from e
        elif by_name[name].get("sharded"):
            out[name] = _assemble_sharded_leaf(final, by_name[name])
        else:
            raise CheckpointCorruptError(
                f"checkpoint leaf file {leaf_path} missing (truncated commit?)"
            )
    return out
