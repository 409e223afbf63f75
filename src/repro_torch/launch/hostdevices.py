"""Join this process to a multi-process ``torch.distributed`` job (the port of ``repro.launch.hostdevices``).

The JAX package joins a ``jax.distributed`` job whose global device list
spans the processes. Here a job is a ``torch.distributed`` process group:
:func:`init_multiprocess` reads the coordinator address, the process count
and this process's id from its arguments or from the ``REPRO_COORDINATOR``
/ ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment (the route
``python -m repro_torch.launch.multiproc`` uses), picks the backend by a
fixed rule and initializes the group with a timeout, so a rank that dies
cannot hang its peers forever.

The backend rule, applied once and never retried with the other backend:

* ``nccl`` when every rank has a card of its own: the device is CUDA with
  no card index and the job has no more ranks than this host has cards
  (rank r takes card ``r % n``);
* ``gloo`` otherwise: on the CPU, and for ranks that share a card (NCCL
  refuses two ranks on one card). Under ``gloo`` every hand-over of a CUDA
  tensor between ranks is staged through pinned host memory
  (:mod:`repro_torch.core.distributed`).

Every rank of a job runs on this host: the launcher spawns them here.
:func:`process_index` and :func:`process_count` are the rank and the
world size (0 and 1 outside a job).
"""
from __future__ import annotations

import datetime
import os

import torch

DEFAULT_TIMEOUT_S = 600.0


def multiprocess_active() -> bool:
    """Whether this process belongs to an initialized ``torch.distributed`` group."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank in the job (0 outside a job)."""
    return torch.distributed.get_rank() if multiprocess_active() else 0


def process_count() -> int:
    """The job's number of processes (1 outside a job)."""
    return torch.distributed.get_world_size() if multiprocess_active() else 1


def choose_backend(device: torch.device, num_processes: int) -> str:
    """The process-group backend for ranks on ``device``, by the rule in the module docstring.

    Args:
        device: The device every rank was asked to run on (``cpu``,
            ``cuda`` or ``cuda:i``).
        num_processes: Ranks in the job.

    Returns:
        ``"nccl"`` when each rank gets a card of its own, else ``"gloo"``.
    """
    if device.type != "cuda" or device.index is not None:
        return "gloo"
    return "nccl" if num_processes <= torch.cuda.device_count() else "gloo"


def init_multiprocess(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join a multi-process job if one is configured; else do nothing.

    Flags win over the ``REPRO_*`` environment. On a CUDA device the
    rank's card (``cuda:(rank % n)`` unless an index is given) becomes the
    current device, so ``"cuda"`` means that card from here on.

    Args:
        coordinator: ``host:port`` of rank 0's store.
        num_processes: Ranks in the job.
        process_id: This process's rank.
        device: Where the rank runs: ``None`` or ``"cuda"`` (a card),
            ``"cpu"``.
        timeout_s: Seconds a collective (or the rendezvous) may wait for a
            peer before it raises.

    Returns:
        True when the group was initialized, False for a plain
        single-process run.

    Raises:
        ValueError: A process count or id without a coordinator, or a
            coordinator without both.
        RuntimeError: A CUDA device asked for and none is visible, or the
            chosen backend failed to initialize (no other is tried).
    """
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR") or None
    if num_processes is None and os.environ.get("REPRO_NUM_PROCESSES"):
        num_processes = int(os.environ["REPRO_NUM_PROCESSES"])
    if process_id is None and os.environ.get("REPRO_PROCESS_ID"):
        process_id = int(os.environ["REPRO_PROCESS_ID"])
    if coordinator is None:
        if num_processes not in (None, 1) or process_id not in (None, 0):
            raise ValueError(
                "got --num-processes/--process-id without a --coordinator address "
                "(or REPRO_COORDINATOR)"
            )
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "multi-process init needs all of coordinator, num_processes and process_id "
            f"(got {coordinator=}, {num_processes=}, {process_id=})"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
                "to run on the CPU"
            )
        torch.cuda.set_device(dev.index if dev.index is not None else process_id % n)
    backend = choose_backend(dev, num_processes)
    shared = "" if backend == "nccl" or dev.type == "cpu" else f", ranks share cuda:{torch.cuda.current_device()}"
    print(
        f"repro_torch: rank {process_id}/{num_processes} joins tcp://{coordinator} over "
        f"{backend} ({dev.type}{shared})",
        flush=True,
    )
    torch.distributed.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def shutdown() -> None:
    """Leave the job (after a barrier, so no rank tears down a group a peer still uses)."""
    if multiprocess_active():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
