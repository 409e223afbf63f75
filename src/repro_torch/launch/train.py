"""End-to-end LM training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch yi-6b --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch zamba2-2.7b --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch minicpm3-4b --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch mixtral-8x22b --reduced --steps 20

The counterpart of ``python -m repro.launch.train``, with its flags and
defaults plus ``--device`` (default ``cuda``; without a card and without
``--device cpu`` it exits with an error). It trains any of the ten configs
(``--reduced`` for the smoke-size config): the attention family (gemma-2b,
yi-6b, chameleon-34b, nemotron-4-340b, hubert-xlarge), MLA (minicpm3-4b),
MoE (grok-1-314b, mixtral-8x22b, whose router losses join the loss), the
SSM family (mamba2-130m) or the hybrid (zamba2-2.7b), on synthetic
Markov-ish tokens,
logs every ``--log-every`` steps, checkpoints every ``--checkpoint-every``
steps into ``--checkpoint-dir`` (resuming from its latest step when there
is one; the files are the reference's, leaf for leaf), and prints ``loss
first -> last (LEARNING)`` or ``(flat)``: it exits 0 only when the mean loss
of the last 5 steps is below that of the first 5.

``--model-parallel N`` runs the LM over a ``("data", "model")`` mesh of the
job's ranks (ROADMAP Queue 1 item 9a) under ``TRAIN_RULES``: run it as a job
of P processes, ``python -m repro_torch.launch.multiproc --num-processes P
-- --arch ... --model-parallel N`` (ranks on one card share it over
``gloo``), for a mesh of shape ``(P // N, N)``. Each rank holds its shards
of the state, sees the whole batch and computes its rows; every rank logs
the same loss, rank 0 alone prints it. The checkpoints hold whole leaves
(each rank writes its shards), so a run saved at one mesh resumes at any
other, or in one process, and the reference reads them. ``--model-parallel``
above the job's process count raises: several cards, one rank each, are
ROADMAP Queue 1 item 9b.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.launch.hostdevices import init_multiprocess, process_count, process_index, shutdown
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.models.module import TRAIN_RULES
from repro_torch.training.optimizer import AdamW, warmup_cosine
from repro_torch.training.train import (
    init_train_state,
    make_train_step,
    state_from_leaves,
    state_host_leaves,
    state_leaves,
    state_specs,
)
from repro_torch.utils import logger, resolve_device


def synthetic_lm_batch(generator: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                       device: str | torch.device = "cpu") -> dict:
    """Markov-ish synthetic tokens (learnable structure, not pure noise), drawn with ``generator``.

    Half the positions copy the previous token + 1. The draws are made on
    the generator's device (the CPU for a CPU generator) and moved to
    ``device``, so a seed gives the same batch on every device.
    """
    base = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator, dtype=torch.int64)
    copy = torch.rand((batch, seq), generator=generator) < 0.5
    shifted = torch.roll(base, 1, dims=1)
    tokens = torch.where(copy, (shifted + 1) % cfg.vocab_size, base).to(torch.int32)
    if cfg.input_mode == "frames":
        inputs = torch.randn((batch, seq, cfg.frame_dim), generator=generator).to(torch.bfloat16)
        labels = tokens
        mask = (torch.rand((batch, seq), generator=generator) < cfg.mask_prob).float()
        mask = torch.clamp_min(mask, 1e-6)  # avoid all-zero masks on tiny batches
    else:
        inputs = tokens
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((batch, seq), dtype=torch.float32)
        mask[:, -1] = 0.0
    return {k: v.to(device) for k, v in {"inputs": inputs, "labels": labels, "mask": mask}.items()}


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of step ``step``'s batch: a function of (seed, step) only, so a resumed run sees the same batches."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def main(argv: list[str] | None = None) -> int:
    """Parse the flags, train, and return 0 when the loss fell (``LEARNING``), 1 otherwise."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where to run (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    joined = init_multiprocess(device=args.device)
    if args.model_parallel > process_count():
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} needs a job of at least as many processes "
            f"(python -m repro_torch.launch.multiproc --num-processes {args.model_parallel} -- ...); this "
            f"one has {process_count()}. One rank per card on several cards is ROADMAP Queue 1 item 9b")
    mesh = make_host_mesh(args.model_parallel) if joined else None
    log = logger.info if process_index() == 0 else (lambda *a: None)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, args.steps // 10 + 1, args.steps))
    step_fn = make_train_step(model, opt, args.microbatches, rules=TRAIN_RULES, mesh=mesh)
    state = init_train_state(prng.key(args.seed), model, opt, device, TRAIN_RULES, mesh)
    specs = state_specs(model, opt, TRAIN_RULES, mesh) if mesh is not None else None
    log("arch=%s params=%.2fM device=%s%s", cfg.name, model.num_params() / 1e6, device,
        f" mesh={mesh.shape}" if mesh is not None else "")

    manager = None
    start = 0
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir)
        latest = manager.latest()
        if latest is not None:
            state = state_from_leaves(manager.restore(state_leaves(state), step=latest), state, specs, mesh)
            start = latest
            log("restored step %d from %s", start, args.checkpoint_dir)

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_lm_batch(step_generator(args.seed, step), cfg, args.batch, args.seq, device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            log("step %4d loss=%.4f acc=%.3f gnorm=%.2f %.0f tok/s", step + 1, losses[-1],
                float(metrics["accuracy"]), float(metrics["grad_norm"]), args.batch * args.seq / dt)
            t0 = time.time()
        if manager and (step + 1) % args.checkpoint_every == 0:
            manager.save(step + 1, state_host_leaves(state, specs, mesh))
    if manager:
        manager.save(args.steps, state_host_leaves(state, specs, mesh))
        manager.close()

    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log("loss %.4f -> %.4f (%s)", first, last, "LEARNING" if last < first else "flat")
    shutdown()
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
