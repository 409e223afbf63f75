"""The BPMF ring of shard devices and the LM's mesh of ranks (the port of ``repro.launch.mesh``).

The JAX package builds a 1-D ``Mesh`` over the first ``num_shards``
global devices. Here a ring is the ordered list of S shard devices. In one
process shard d sits on card ``d % n`` of the n visible cards, so S may
exceed n and shards then share a card; on the CPU every shard sits on the
CPU. In a job of P processes (:mod:`repro_torch.launch.hostdevices`) the
ring spans them: process p holds shards ``local_shard_range(S, p, P)``,
all on its own device.

:func:`make_host_mesh` is the LM's ``("data", "model")`` mesh over the
job's ranks (one rank outside a job), as the reference's over whatever
devices exist. :func:`make_production_mesh` (the reference's 16 x 16 and
2 x 16 x 16 meshes) and :func:`bpmf_ring_from` (that mesh flattened into
the BPMF ring) are abstract, seen from one rank: what the dry run
(:mod:`repro_torch.launch.dryrun`, ROADMAP Queue 1 item 11e) traces.

Axes, as the reference names them: ``pod`` (across pods: data
parallelism only), ``data`` (within-pod data parallelism and the
FSDP-style weight storage split), ``model`` (tensor parallelism and the
sequence-split KV caches at decode).
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import Ring, local_shard_range
from repro_torch.launch.hostdevices import process_count, process_index
from repro_torch.models.collectives import Mesh


def make_host_mesh(model: int = 1) -> Mesh:
    """The ``("data", "model")`` mesh of shape ``(n // model, model)`` over the job's n ranks.

    ``model`` is capped at n, as the reference caps it at its device count.
    A collective: every rank of the job calls it.

    Raises:
        ValueError: ``model`` is below 1 or does not divide n.
    """
    n = process_count()
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    model = min(model, n)
    if n % model:
        raise ValueError(f"model-parallel {model} does not divide the job's {n} processes")
    return Mesh.create((n // model, model), ("data", "model"))


def make_production_mesh(multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The reference's production mesh, abstract and seen from ``rank``.

    ``(16, 16)`` over ``("data", "model")``, or with ``multi_pod``
    ``(2, 16, 16)`` over ``("pod", "data", "model")``: the reference's
    shapes, so per-rank shapes compare with the reference's.
    """
    if multi_pod:
        return Mesh.abstract((2, 16, 16), ("pod", "data", "model"), rank=rank)
    return Mesh.abstract((16, 16), ("data", "model"), rank=rank)


def bpmf_ring_from(mesh: Mesh) -> Ring:
    """The abstract BPMF ring of ``mesh.size`` shards, seen from ``mesh.rank`` (paper §IV: ranks on one ring).

    The ring holds one ``meta`` shard, ``shard_offset = mesh.rank``; its
    hand-overs and gathers record what they would move and move nothing.
    """
    return Ring(["meta"], num_shards=mesh.size, shard_offset=mesh.rank, abstract=True)


def bpmf_ring(num_shards: int = 0, device: str | torch.device | None = None) -> Ring:
    """A :class:`~repro_torch.core.distributed.Ring` of ``num_shards`` shards.

    Args:
        num_shards: Ring length S; 0 means one shard per visible card (one
            shard on the CPU), or one per process in a multi-process job.
        device: ``None`` or ``"cuda"`` spreads the shards over every visible
            card (in a multi-process job: puts this process's shards on its
            current card); ``"cuda:i"`` keeps them all on card i; ``"cpu"``
            puts them on the CPU.

    Raises:
        ValueError: ``num_shards`` is negative, or not a multiple of the
            job's process count.
        RuntimeError: Shards are asked for on CUDA and no card is visible.
    """
    if num_shards < 0:
        raise ValueError(f"num_shards must be >= 0, got {num_shards}")
    dev = torch.device("cuda" if device is None else device)
    if process_count() > 1:
        S = num_shards or process_count()
        local = local_shard_range(S, process_index(), process_count())
        return Ring([dev] * len(local), num_shards=S, shard_offset=local.start)
    if dev.type == "cpu":
        return Ring([dev] * (num_shards or 1))
    if dev.type != "cuda":
        raise ValueError(f"a ring runs on CUDA cards or the CPU, got {dev}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            f"{num_shards or 'one'} ring shard(s) asked for on CUDA, but no CUDA device "
            "is visible; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    cards = [dev] if dev.index is not None else [torch.device("cuda", i) for i in range(n)]
    S = num_shards or len(cards)
    return Ring([cards[d % len(cards)] for d in range(S)])
