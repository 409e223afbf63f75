"""``chip_smoke.py``'s decode gate can fail: each fault it is there to catch makes it raise.

The gate (``chip_smoke.decode_gate`` and ``check_decode_gate``) compares a
prefill plus one-token decode steps against one pass over the whole
sequence: every cache field per layer, and the stack's output minus each
decoded position's own embedding. Here it runs on reduced gemma-2b,
zamba2-2.7b, mamba2-130m, minicpm3-4b and mixtral-8x22b on the CPU, on the
real code (it must pass) and with one fault injected by ``monkeypatch`` (it
must raise):

* ``attn_zeroed``: the decode step's attention output is zero;
* ``attn_own_slot``: the decode step attends only to its own token, so the
  cache is ignored (the cache itself is still written);
* ``S_reset``: the SSD state is zero at the start of every decode step;
* ``conv_unshifted``: the decode step hands back the conv window it was
  given, so the window never takes the new token;
* ``mla_no_kv_norm``: MLA's absorbed path (each decode step's: minicpm3
  runs with Q and KV chunks of 16, so its 40-token prefill and the one-pass
  runs take the materialized path, as 4,096 tokens do at full width) reads
  the latent without ``kv_norm``;
* ``mla_no_rope_score``: the absorbed path drops the ``q_pe · kpe`` score;
* ``moe_top1``: a decode step routes each token to its top-1 expert only;
* ``swa_slot_ahead``: mixtral's decode step writes its key and value one
  rolling slot ahead, at (p + 1) % W, in the read across the wrap (window
  32, a 32-token prompt and 8 decode steps: ``decode_gate`` then gates the
  residual against ``forward`` alone).

Mixtral's gate runs at ``chip_smoke.gate_config``'s capacity factor.

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
from repro_torch.models import attention, mamba2, transformer
from repro_torch.models.model import build_model
from repro_torch.models.module import NO_SHARDING, map_descs

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

P, T = 40, 8  # prompt (a whole 32-token SSD chunk and a partial one), teacher-forced steps
# the gate's runs: config name -> (arch, replacements of its reduced config, prompt)
RUNS = {
    "gemma-2b": ("gemma-2b", {}, P),
    "zamba2-2.7b": ("zamba2-2.7b", {}, P),
    "mamba2-130m": ("mamba2-130m", {}, P),
    "minicpm3-4b": ("minicpm3-4b", {"attn_q_chunk": 16, "attn_kv_chunk": 16}, P),
    "mixtral-8x22b": ("mixtral-8x22b", {}, P),  # P + T = 48 within the window of 64: caches gated
    "mixtral-8x22b-wrap": ("mixtral-8x22b", {"sliding_window": 32}, 32),  # P = W, decoded across the wrap
}


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn_zeroed(real):
    def apply(params, x, positions, cfg, ctx=NO_SHARDING, cache=None):
        y, new_cache = real(params, x, positions, cfg, ctx, cache)
        return (torch.zeros_like(y) if cache is not None and x.shape[1] == 1 else y), new_cache

    return transformer, "apply_attention", apply


def _attn_own_slot(real):
    def apply(params, x, positions, cfg, ctx=NO_SHARDING, cache=None):
        y, new_cache = real(params, x, positions, cfg, ctx, cache)
        if cache is not None and x.shape[1] == 1:
            y, _ = real(params, x, positions, cfg, ctx, None)  # self-attention over the one token
        return y, new_cache

    return transformer, "apply_attention", apply


def _S_reset(real):
    def step(x, dt, A, Bm, Cm, S):
        return real(x, dt, A, Bm, Cm, torch.zeros_like(S))

    return mamba2, "ssd_step", step


def _conv_unshifted(real):
    def apply(params, x, cfg, ctx=NO_SHARDING, state=None, return_state=False):
        y, new_state = real(params, x, cfg, ctx, state, return_state)
        if state is not None and x.shape[1] == 1:
            new_state = dataclasses.replace(new_state, conv=state.conv)
        return y, new_state

    return transformer, "apply_mamba2", apply


def _mla_no_kv_norm(real):
    def attend(*args):
        norm = attention.rms_norm
        attention.rms_norm = lambda x, scale, eps=1e-6: x
        try:
            return real(*args)
        finally:
            attention.rms_norm = norm

    return attention, "_mla_attend_flash", attend


def _mla_no_rope_score(real):
    def attend(params, q_nope, q_pe, *rest):
        return real(params, q_nope, torch.zeros_like(q_pe), *rest)

    return attention, "_mla_attend_flash", attend


def _moe_top1(real):
    def apply(params, x, cfg, ctx=NO_SHARDING):
        return real(params, x, cfg.replace(num_experts_per_tok=1) if x.shape[1] == 1 else cfg, ctx)

    return transformer, "apply_moe", apply


def _swa_slot_ahead(real):
    def write(cache, k, v, positions):
        if not (cache.rolling and k.shape[1] == 1):
            return real(cache, k, v, positions)
        new, _ = real(cache, k, v, positions + 1)  # the key at (p + 1) % W
        new = dataclasses.replace(new, next_pos=positions[-1] + 1)
        return new, attention.rolling_slot_positions(new.next_pos, cache.window)

    return attention, "_write_cache", write


FAULTS = {"attn_zeroed": _attn_zeroed, "attn_own_slot": _attn_own_slot, "S_reset": _S_reset,
          "conv_unshifted": _conv_unshifted, "mla_no_kv_norm": _mla_no_kv_norm,
          "mla_no_rope_score": _mla_no_rope_score, "moe_top1": _moe_top1, "swa_slot_ahead": _swa_slot_ahead}
REAL = {"attn_zeroed": transformer.apply_attention, "attn_own_slot": transformer.apply_attention,
        "S_reset": mamba2.ssd_step, "conv_unshifted": transformer.apply_mamba2,
        "mla_no_kv_norm": attention._mla_attend_flash, "mla_no_rope_score": attention._mla_attend_flash,
        "moe_top1": transformer.apply_moe, "swa_slot_ahead": attention._write_cache}
ATTN_FAULTS, SSM_FAULTS = ("attn_zeroed", "attn_own_slot"), ("S_reset", "conv_unshifted")
F32_CASES = ([("gemma-2b", f) for f in (None, *ATTN_FAULTS)]
             + [("zamba2-2.7b", f) for f in (None, *ATTN_FAULTS, *SSM_FAULTS)]
             + [("mamba2-130m", f) for f in (None, *SSM_FAULTS)]
             + [("minicpm3-4b", f) for f in (None, "mla_no_kv_norm", "mla_no_rope_score")]
             + [("mixtral-8x22b", f) for f in (None, "moe_top1")]
             + [("mixtral-8x22b-wrap", f) for f in (None, "swa_slot_ahead")])
OWN_DTYPE_CASES = [(a, f) for a in ("zamba2-2.7b", "mamba2-130m") for f in (None, *SSM_FAULTS)]


def _model_params_tokens(run: str, activation_dtype: str):
    """The reduced config of ``run`` (``RUNS``) with params drawn from a seeded numpy generator at each
    descriptor's scale, and P + T tokens."""
    arch, kw, prompt = RUNS[run]
    cfg = get_config(arch).reduced().replace(activation_dtype=activation_dtype, **kw)
    model = build_model(cfg)
    rng = np.random.default_rng(0)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            return (torch.zeros if d.init == "zeros" else torch.ones)(d.shape, dtype=d.dtype)
        return torch.from_numpy((d.scale * rng.normal(size=d.shape)).astype(np.float32)).to(d.dtype)

    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt + T)).astype(np.int32)
    return model, map_descs(leaf, model.descs()), torch.from_numpy(tokens), prompt


def _gate(monkeypatch, run: str, fault, activation_dtype: str) -> dict:
    model, params, tokens, prompt = _model_params_tokens(run, activation_dtype)
    if fault is not None:
        monkeypatch.setattr(*FAULTS[fault](REAL[fault]))
    gate = chip_smoke.decode_gate(torch, model, params, tokens, prompt)
    print(json.dumps({"run": run, "fault": fault, "activation_dtype": activation_dtype,
                      "residual": gate["residual_rel_err"], "logits_record": gate["logits_rel_err_record"],
                      "cache_gated": gate["cache_gated"], "capacity_factor": gate["capacity_factor"],
                      "cache": {k: v["worst"] for k, v in gate["cache_rel_err"].items()}}))
    assert gate["cache_gated"] == (run != "mixtral-8x22b-wrap")
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
