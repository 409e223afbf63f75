#!/usr/bin/env python3
"""One forward, train step, prefill and decode step per reduced arch, on the card.

    PYTHONPATH=src python3 scripts/smoke_models_torch.py [--device cpu] [arch ...]

The port's counterpart of ``scripts/smoke_models.py``: for every arch (or
those named) the reduced config is built, its params drawn, and one
forward (logits of shape ``[B, L, padded_vocab]``, no NaN), one train step
(a finite loss), and for a decoder a prefill of ``L // 2`` tokens and one
greedy decode step (logits ``[B, 1, padded_vocab]``, no NaN) are run. It
runs on the card by default (and raises without one) and on the CPU with
``--device cpu``. Prints one ``[ok]`` line per arch; exits 1 on the first
failure.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import prng
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import init_train_state, make_train_step
from repro_torch.utils import resolve_device

B, L = 2, 64


def smoke(arch: str, device: torch.device) -> str:
    """Run the four steps of ``arch``'s reduced config on ``device``; its ``[ok]`` line."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    key = prng.key(0, device)
    params = model.init(key, device)
    gen = torch.Generator(device=device).manual_seed(0)
    if cfg.input_mode == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=device, dtype=torch.int32)
    else:
        inputs = torch.randn((B, L, cfg.frame_dim), generator=gen, device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device=device, dtype=torch.int32)
    mask = torch.ones((B, L), dtype=torch.float32, device=device)

    with torch.no_grad():
        logits, _ = model.forward(params, inputs)
    assert tuple(logits.shape) == (B, L, cfg.padded_vocab), logits.shape
    assert not bool(torch.isnan(logits).any()), f"{arch}: NaN logits"

    opt = AdamW(learning_rate=1e-3)
    state = init_train_state(key, model, opt, device)
    state, m = make_train_step(model, opt)(state, {"inputs": inputs, "labels": labels, "mask": mask})
    loss = float(m["loss"])
    assert loss == loss, f"{arch}: NaN loss"

    decode_info = "no-decode"
    if not cfg.is_encoder:
        with torch.no_grad():
            cache = model.init_cache(B, L + 8, device)
            lg, cache = model.prefill(params, inputs[:, : L // 2], cache)
            tok = lg[:, -1, :].argmax(-1)[:, None].to(torch.int32)
            lg2, cache = model.decode(params, tok, cache, torch.tensor([L // 2], dtype=torch.int32, device=device))
        assert tuple(lg2.shape) == (B, 1, cfg.padded_vocab), lg2.shape
        assert not bool(torch.isnan(lg2).any()), f"{arch}: NaN decode"
        decode_info = "decode-ok"
    return f"[ok] {arch:18s} loss={loss:.3f} {decode_info}"


def main(argv: list[str] | None = None) -> int:
    """Smoke every named arch (all by default); 1 at the first failure."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("archs", nargs="*", help=f"archs to run (default: all of {', '.join(ARCHS)})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in args.archs or ARCHS:
        try:
            print(smoke(arch, device), flush=True)
        except Exception as e:  # noqa: BLE001 — name the arch, then stop
            print(f"[FAIL] {arch}: {type(e).__name__}: {e}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
