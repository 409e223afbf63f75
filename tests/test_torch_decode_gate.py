"""``chip_smoke.py``'s decode gate can fail: each fault it is there to catch makes it raise.

The gate (``chip_smoke.decode_gate`` and ``check_decode_gate``) compares a
prefill plus one-token decode steps against one pass over the whole
sequence: every cache field per layer, and the stack's output minus each
decoded position's own embedding. Here it runs on reduced gemma-2b,
zamba2-2.7b and mamba2-130m on the CPU, on the real code (it must pass) and
with one fault injected by ``monkeypatch`` (it must raise):

* ``attn_zeroed``: the decode step's attention output is zero;
* ``attn_own_slot``: the decode step attends only to its own token, so the
  cache is ignored (the cache itself is still written);
* ``S_reset``: the SSD state is zero at the start of every decode step;
* ``conv_unshifted``: the decode step hands back the conv window it was
  given, so the window never takes the new token.

In float32 activations (``GATE_ACTIVATIONS``) every field is held to
``DECODE_CACHE_BAND`` and ``DECODE_RESIDUAL_BAND``. In bf16, the configs'
own dtype, the SSM and hybrid configs' ``S`` and ``conv`` fields and the
residual are held to ``DECODE_OWN_DTYPE_BAND``; attention faults are left to
the float32 gate, which bf16 rounding does not blur. Run with ``-s`` to
print each reading.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import mamba2, transformer
from repro_torch.models.model import build_model
from repro_torch.models.module import map_descs

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

P, T = 40, 8  # prompt (a whole 32-token SSD chunk and a partial one), teacher-forced steps


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn_zeroed(real):
    def apply(params, x, positions, cfg, cache=None):
        y, new_cache = real(params, x, positions, cfg, cache)
        return (torch.zeros_like(y) if cache is not None and x.shape[1] == 1 else y), new_cache

    return transformer, "apply_attention", apply


def _attn_own_slot(real):
    def apply(params, x, positions, cfg, cache=None):
        y, new_cache = real(params, x, positions, cfg, cache)
        if cache is not None and x.shape[1] == 1:
            y, _ = real(params, x, positions, cfg, None)  # self-attention over the one token
        return y, new_cache

    return transformer, "apply_attention", apply


def _S_reset(real):
    def step(x, dt, A, Bm, Cm, S):
        return real(x, dt, A, Bm, Cm, torch.zeros_like(S))

    return mamba2, "ssd_step", step


def _conv_unshifted(real):
    def apply(params, x, cfg, state=None, return_state=False):
        y, new_state = real(params, x, cfg, state, return_state)
        if state is not None and x.shape[1] == 1:
            new_state = dataclasses.replace(new_state, conv=state.conv)
        return y, new_state

    return transformer, "apply_mamba2", apply


FAULTS = {"attn_zeroed": _attn_zeroed, "attn_own_slot": _attn_own_slot, "S_reset": _S_reset,
          "conv_unshifted": _conv_unshifted}
REAL = {"attn_zeroed": transformer.apply_attention, "attn_own_slot": transformer.apply_attention,
        "S_reset": mamba2.ssd_step, "conv_unshifted": transformer.apply_mamba2}
ATTN_FAULTS, SSM_FAULTS = ("attn_zeroed", "attn_own_slot"), ("S_reset", "conv_unshifted")
F32_CASES = ([("gemma-2b", f) for f in (None, *ATTN_FAULTS)]
             + [("zamba2-2.7b", f) for f in (None, *ATTN_FAULTS, *SSM_FAULTS)]
             + [("mamba2-130m", f) for f in (None, *SSM_FAULTS)])
OWN_DTYPE_CASES = [(a, f) for a in ("zamba2-2.7b", "mamba2-130m") for f in (None, *SSM_FAULTS)]


def _model_params_tokens(arch: str, activation_dtype: str):
    """Reduced ``arch`` with f32 params drawn from a seeded numpy generator at each descriptor's scale."""
    cfg = get_config(arch).reduced().replace(activation_dtype=activation_dtype)
    model = build_model(cfg)
    rng = np.random.default_rng(0)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            return (torch.zeros if d.init == "zeros" else torch.ones)(d.shape, dtype=d.dtype)
        return torch.from_numpy((d.scale * rng.normal(size=d.shape)).astype(np.float32)).to(d.dtype)

    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, P + T)).astype(np.int32)
    return model, map_descs(leaf, model.descs()), torch.from_numpy(tokens)


def _gate(monkeypatch, arch: str, fault, activation_dtype: str) -> dict:
    model, params, tokens = _model_params_tokens(arch, activation_dtype)
    if fault is not None:
        monkeypatch.setattr(*FAULTS[fault](REAL[fault]))
    gate = chip_smoke.decode_gate(torch, model, params, tokens, P)
    print(json.dumps({"arch": arch, "fault": fault, "activation_dtype": activation_dtype,
                      "residual": gate["residual_rel_err"], "logits_record": gate["logits_rel_err_record"],
                      "cache": {k: v["worst"] for k, v in gate["cache_rel_err"].items()}}))
    return gate


@pytest.mark.parametrize("arch, fault", F32_CASES, ids=[f"{a}-{f or 'real'}" for a, f in F32_CASES])
def test_the_float32_gate_passes_the_real_decode_and_fails_each_fault(monkeypatch, arch, fault):
    gate = _gate(monkeypatch, arch, fault, chip_smoke.GATE_ACTIVATIONS)
    if fault is None:
        chip_smoke.check_decode_gate(arch, gate)
    else:
        with pytest.raises(AssertionError, match="teacher-forced decode"):
            chip_smoke.check_decode_gate(arch, gate)


@pytest.mark.parametrize("arch, fault", OWN_DTYPE_CASES, ids=[f"{a}-{f or 'real'}" for a, f in OWN_DTYPE_CASES])
def test_the_bf16_gate_on_the_ssm_fields_passes_the_real_decode_and_fails_each_state_fault(monkeypatch, arch,
                                                                                          fault):
    gate = _gate(monkeypatch, arch, fault, "bfloat16")
    check = lambda: chip_smoke.check_decode_gate(arch, gate, chip_smoke.DECODE_OWN_DTYPE_BAND,
                                                 chip_smoke.DECODE_OWN_DTYPE_BAND, chip_smoke.OWN_DTYPE_FIELDS)
    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError, match="teacher-forced decode"):
            check()
