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
manifest lists them in the order given.

Multi-process jobs (DESIGN.md §14): a leaf that only exists in pieces,
one per process (a :class:`ShardedHostLeaf`, such as the factor rows of a
ring over processes), is written as per-shard files, each process saving
its own pieces with their global index ranges in the file name
(``<leaf>.shard-<start>_<stop>[-...].npy``) and ``"sharded": true`` in the
manifest. Every process stages into one deterministic tmp directory
(``step_N.tmp-mp``); a barrier confirms every shard file is on disk; then
process 0 alone writes the manifest, renames the directory into place and
replaces ``LATEST``; a last barrier keeps every process behind the commit.
Whole leaves are written by process 0. The read path reassembles a sharded
leaf on the host, so a checkpoint written at one process count (by either
package) restores at any other. In one process the format is the
one-file-per-leaf one.

Atomicity: the tmp directory is renamed to its final name only after every
leaf and the manifest are on disk, and ``LATEST`` is replaced after the
rename, so a killed process never leaves a half-readable "latest"
checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets
import shutil
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.launch.hostdevices import process_count, process_index

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


@dataclasses.dataclass(frozen=True)
class ShardedHostLeaf:
    """Host snapshot of one process's pieces of a leaf that spans processes.

    The global shape and dtype, and the pieces this process holds, each
    keyed by its global ``(start, stop)`` range per dimension: what
    :func:`save_checkpoint` needs to write this process's shard files, and
    process 0 the manifest entry. A process that holds no piece passes
    ``shards=()``.
    """

    global_shape: tuple[int, ...]
    dtype: str
    #: ``(((start, stop), ...per dim), block)`` per piece held here
    shards: tuple[tuple[tuple[tuple[int, int], ...], np.ndarray], ...]


def _shard_ranges(shape: tuple[int, ...], index) -> tuple[tuple[int, int], ...]:
    """Resolve a piece's index (slices, one per dimension) into per-dimension (start, stop)."""
    out = []
    for dim, sl in zip(shape, index):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError(f"non-contiguous shard slice {sl}")
        out.append((int(start), int(stop)))
    return tuple(out)


def host_snapshot_leaf(x: Any) -> np.ndarray | ShardedHostLeaf:
    """A host copy of one leaf, taken now.

    A tensor is copied to the host on the current stream of its device, so
    a later in-place update of the tensor (the posterior sums are updated in
    place) cannot reach a write still in flight; a CPU tensor is copied too.
    A numpy array or a :class:`ShardedHostLeaf` is written as it is: the
    caller hands over one it does not change afterwards.
    """
    if isinstance(x, ShardedHostLeaf):
        return x
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _shard_filename(name: str, ranges: tuple[tuple[int, int], ...]) -> str:
    body = "-".join(f"{a}_{b}" for a, b in ranges) or "scalar"
    return f"{name}.shard-{body}.npy"


def _parse_shard_ranges(fname: str, name: str) -> tuple[tuple[int, int], ...]:
    body = fname[len(name) + len(".shard-") : -len(".npy")]
    if body == "scalar":
        return ()
    return tuple(
        (int(a), int(b)) for a, b in (part.split("_") for part in body.split("-"))
    )


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _barrier(tag: str) -> None:
    """Block until every process of the job reaches this point (``tag`` names it in a timeout's error)."""
    try:
        torch.distributed.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"checkpoint barrier {tag!r} failed: {e}") from e


def save_checkpoint(directory: str, step: int, leaves: Mapping[str, Any], *, collective: bool = True) -> str:
    """Write ``leaves`` for ``step``; atomic commit; returns the final path.

    In a multi-process job this is a collective (every process calls it
    with the same step and leaf names): the protocol of the module
    docstring. ``collective=False`` writes every leaf from this process
    alone, with no barrier.

    Args:
        directory: Checkpoint root (created if needed).
        step: Step number; the directory is ``step_<08d>``. Saving a step
            again replaces it.
        leaves: Leaf name -> array (numpy, tensor or
            :class:`ShardedHostLeaf`), in manifest order.
        collective: Follow the multi-process protocol when in a job.

    Returns:
        The committed step directory.
    """
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    procs = process_count() if collective else 1
    pid = process_index() if collective else 0
    if procs == 1:
        tmp = f"{final}.tmp-{secrets.token_hex(4)}"
        os.makedirs(tmp, exist_ok=True)
    else:
        # one name that every process stages into
        tmp = f"{final}.tmp-mp"
        if pid == 0:
            if os.path.exists(tmp):  # left by a job that was killed
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
        _barrier(f"ckpt-begin-{step}")
    manifest = {"step": step, "leaves": []}
    for name, leaf in leaves.items():
        leaf = host_snapshot_leaf(leaf)
        if isinstance(leaf, ShardedHostLeaf):
            for ranges, block in leaf.shards:
                path = os.path.join(tmp, _shard_filename(name, ranges))
                # a piece held by several processes: each stages under its
                # own name, and the replace races to the same bytes
                stage = f"{path}.p{pid}"
                with open(stage, "wb") as f:
                    np.save(f, block)
                os.replace(stage, path)
            manifest["leaves"].append(
                {"name": name, "shape": list(leaf.global_shape), "dtype": leaf.dtype, "sharded": True}
            )
        else:
            if pid == 0:  # a whole leaf: one writer
                np.save(os.path.join(tmp, f"{name}.npy"), leaf)
            manifest["leaves"].append({"name": name, "shape": list(leaf.shape), "dtype": str(leaf.dtype)})
    if procs > 1:
        _barrier(f"ckpt-written-{step}")
    if pid == 0:
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):  # re-save of the same step: replace
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(directory, f".LATEST-{secrets.token_hex(4)}")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    if procs > 1:
        _barrier(f"ckpt-committed-{step}")
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
