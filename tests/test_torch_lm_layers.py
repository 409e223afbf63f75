"""The LM scaffold's layers and attention: the port against the JAX reference on the same inputs.

Norms, RoPE, the four MLPs, the embedding and head (tied, soft-capped, a
padded vocabulary tail), the attention mask and rolling-cache slots, the
dense and flash attention paths (G > 1, non-causal, a window, padded
chunks, an all-masked row) and ``apply_attention`` with full and rolling
caches. Inputs are numpy-seeded; weights are carried across. Bands: f32
3e-5 (the reference's ``tests/test_attention.py`` band), bf16 5e-2
relative to the largest value.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree
from repro_torch.models import attention, layers

F32 = 3e-5
BF16 = 5e-2

# the reference's functions under jit (one compile per shape is far cheaper than eager op-by-op dispatch)
ref_norm = jax.jit(ref_layers.apply_norm, static_argnames="cfg")
ref_mlp = jax.jit(ref_layers.apply_mlp, static_argnames="cfg")
ref_head = jax.jit(ref_layers.apply_lm_head, static_argnames="cfg")
ref_dense = jax.jit(ref_attn._attend_dense, static_argnames="scale")
ref_flash = jax.jit(ref_attn._attend_flash, static_argnames=("causal", "window", "scale", "q_chunk", "kv_chunk"))
ref_attention = jax.jit(ref_attn.apply_attention, static_argnames="cfg")


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch: str = "yi-6b", **kw):
    """The reduced config of ``arch`` in both packages, with the same replacements."""
    return ref_get_config(arch).reduced().replace(**kw), get_config(arch).reduced().replace(**kw)


def _tree(cfg_pair, desc_name: str, seed: int = 0):
    """Random params of one layer from the reference's descriptors: (reference tree, port tree)."""
    ref_cfg, _ = cfg_pair
    from repro.models.module import init_params

    descs = getattr(ref_layers, desc_name, None) or getattr(ref_attn, desc_name)
    tree = jax.tree.map(np.asarray, init_params(jax.random.key(seed), descs(ref_cfg)))
    rng = np.random.default_rng(seed)
    # scales and biases away from their ones/zeros init, so they are tested too
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype) if a.ndim == 1 else a, tree)
    return tree, lm_params_from_tree(tree)


def _close(got: torch.Tensor, want, band: float, rel_to_max: bool = False) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rel_to_max:
        assert np.abs(got - want).max() <= band * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=band, rtol=band)


def _x(*shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_the_reference(norm, dtype):
    pair = _cfgs(norm=norm)
    ref_p, port_p = _tree(pair, "desc_norm")
    x = _x(2, 5, 128)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    band, rel = (F32, False) if dtype == "float32" else (BF16, True)
    _close(layers.apply_norm(port_p, tx, pair[1]), ref_norm(ref_p, jx, cfg=pair[0]), band, rel)
    _close(layers.rms_norm(tx, port_p["scale"]), ref_layers.rms_norm(jx, ref_p["scale"]), band, rel)


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope_matches_the_reference(theta):
    x = _x(2, 7, 3, 32)
    pos = np.array([0, 1, 2, 5, 9, 100, 4095], np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta), want, F32)
    _close(layers.rope_freqs(32, theta), ref_layers.rope_freqs(32, theta), 1e-7)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps_match_the_reference(mlp, dtype):
    pair = _cfgs(mlp=mlp, activation_dtype=dtype)
    ref_p, port_p = _tree(pair, "desc_mlp")
    x = _x(2, 6, 128)
    want = ref_mlp(ref_p, jnp.asarray(x), cfg=pair[0])
    got = layers.apply_mlp(port_p, torch.from_numpy(x), pair[1])
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, F32)
    else:
        _close(got, want, BF16, rel_to_max=True)


@pytest.mark.parametrize("case", ["tied", "untied_softcap_padded", "frames"])
def test_embed_and_head_match_the_reference(case):
    arch, kw = {"tied": ("gemma-2b", {}),
                "untied_softcap_padded": ("yi-6b", {"vocab_size": 500, "logits_softcap": 30.0}),
                "frames": ("hubert-xlarge", {})}[case]
    pair = _cfgs(arch, activation_dtype="float32", **kw)
    ref_e, port_e = _tree(pair, "desc_embed", seed=2)
    ref_h, port_h = _tree(pair, "desc_lm_head", seed=3)
    cfg = pair[1]
    if cfg.input_mode == "tokens":
        inputs = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    else:
        inputs = _x(2, 9, cfg.frame_dim)
    _close(layers.apply_embed(port_e, torch.from_numpy(inputs), cfg),
           ref_layers.apply_embed(ref_e, jnp.asarray(inputs), pair[0]), F32)
    h = _x(2, 9, cfg.d_model, seed=5)
    want = np.asarray(ref_head(ref_h, ref_e, jnp.asarray(h), cfg=pair[0]))
    got = layers.apply_lm_head(port_h, port_e, torch.from_numpy(h), cfg)
    assert got.dtype == torch.float32 and got.shape[-1] == cfg.padded_vocab
    V = cfg.vocab_size
    _close(got[..., :V], want[..., :V], F32)
    if cfg.padded_vocab != V:  # the padded tail carries no softmax mass: the reference's constant
        assert (got[..., V:] == float(want[0, 0, V])).all() and want[0, 0, V] == np.float32(attention.NEG_INF)
    if cfg.logits_softcap:
        assert float(got[..., :V].abs().max()) < cfg.logits_softcap


def test_mask_and_rolling_slots_match_the_reference():
    q_pos = np.array([3, 4, 9], np.int32)
    kv_pos = np.array([0, 1, 2, 3, 4, -1, 8, 9], np.int32)
    for causal in (True, False):
        for window in (None, 2, 5):
            want = ref_attn.attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal, window)
            got = attention.attention_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal, window)
            assert got.tolist() == np.asarray(want).tolist()
    for nxt in (0, 1, 3, 4, 6, 13):
        want = ref_attn.rolling_slot_positions(jnp.asarray(nxt, jnp.int32), 4)
        got = attention.rolling_slot_positions(torch.tensor(nxt, dtype=torch.int32), 4)
        assert got.tolist() == np.asarray(want).tolist()


ATTEND_CASES = {
    # name: (B, Lq, S, H, KV, causal, window, q_chunk, kv_chunk, q_offset)
    "mqa_causal": (2, 12, 12, 4, 1, True, None, 4, 8, 0),
    "gqa_noncausal_padded": (1, 13, 21, 6, 2, False, None, 5, 8, 0),
    "window_padded": (2, 11, 19, 4, 2, True, 5, 4, 6, 8),
    "mha_offset": (1, 9, 16, 3, 3, True, 7, 3, 16, 7),
}


def _qkv(B, Lq, S, H, KV, dh=8, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Lq, H, dh)).astype(np.float32), rng.normal(size=(B, S, KV, dh)).astype(np.float32),
            rng.normal(size=(B, S, KV, dh)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(ATTEND_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_flash_attention_match_the_reference(name, dtype):
    B, Lq, S, H, KV, causal, window, qc, kc, off = ATTEND_CASES[name]
    q, k, v = _qkv(B, Lq, S, H, KV)
    q_pos = np.arange(off, off + Lq, dtype=np.int32)
    kv_pos = np.arange(S, dtype=np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    mask = ref_attn.attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal, window)
    tmask = attention.attention_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal, window)
    want_dense = ref_dense(jq, jk, jv, mask, scale=0.3)
    want_flash = ref_flash(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal, window=window,
                           scale=0.3, q_chunk=qc, kv_chunk=kc)
    got_dense = attention._attend_dense(tq, tk, tv, tmask, 0.3)
    got_flash = attention._attend_flash(tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal,
                                        window, 0.3, qc, kc)
    assert got_dense.dtype == got_flash.dtype == td
    band, rel = (F32, False) if dtype == "float32" else (BF16, True)
    _close(got_dense, want_dense, band, rel)
    _close(got_flash, want_flash, band, rel)


def test_all_masked_row_keeps_each_paths_behaviour():
    """Dense: a row with every key masked is uniform over its keys; flash: it is 0. Both as the reference."""
    q, k, v = _qkv(1, 3, 6, 2, 1)
    q_pos = np.array([0, 1, 2], np.int32)
    kv_pos = np.array([3, 4, 5, -1, -1, 1], np.int32)  # query 0 sees nothing (causal)
    args = (torch.from_numpy(q_pos), torch.from_numpy(kv_pos), True, None)
    mask = attention.attention_mask(*args)
    assert not bool(mask[0].any())
    dense = attention._attend_dense(*(torch.from_numpy(a) for a in (q, k, v)), mask, 0.5)
    flash = attention._attend_flash(*(torch.from_numpy(a) for a in (q, k, v)), *args, 0.5, 2, 4)
    want_dense = ref_dense(*(jnp.asarray(a) for a in (q, k, v)),
                           ref_attn.attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), True, None), scale=0.5)
    want_flash = ref_flash(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(q_pos), jnp.asarray(kv_pos),
                           causal=True, window=None, scale=0.5, q_chunk=2, kv_chunk=4)
    _close(dense, want_dense, F32)
    _close(flash, want_flash, F32)
    np.testing.assert_allclose(dense[0, 0].numpy(), np.broadcast_to(v[0].mean(0), (2, 8)), atol=F32)
    assert bool((flash[0, 0] == 0).all())


def _attn_params(pair, seed=0):
    return _tree(pair, "desc_attention", seed)


def _run_cached(fn_ref, fn_port, ref_p, port_p, pair, x, chunks, max_len):
    """Prefill / decode through both packages' caches in the given chunks; the outputs and final caches."""
    ref_cfg, cfg = pair
    rc = ref_attn.init_kv_cache(ref_cfg, x.shape[0], max_len)
    pc = attention.init_kv_cache(cfg, x.shape[0], max_len)
    outs = []
    start = 0
    for n in chunks:
        pos = np.arange(start, start + n, dtype=np.int32)
        ry, rc = fn_ref(ref_p, jnp.asarray(x[:, start : start + n]), jnp.asarray(pos), cfg=ref_cfg, cache=rc)
        py, pc = fn_port(port_p, torch.from_numpy(x[:, start : start + n]), torch.from_numpy(pos), cfg, cache=pc)
        outs.append((py, ry))
        start += n
    return outs, pc, rc


@pytest.mark.parametrize("case", ["full", "full_qk_norm", "rolling", "rolling_prompt_longer_than_window"])
def test_apply_attention_with_caches_matches_the_reference(case):
    arch = "chameleon-34b" if case == "full_qk_norm" else "yi-6b"
    kw = {"activation_dtype": "float32", "param_dtype": "float32"}
    if case.startswith("rolling"):
        kw["sliding_window"] = 6
    pair = _cfgs(arch, **kw)
    ref_p, port_p = _attn_params(pair)
    x = _x(2, 14, 128, seed=8)
    chunks = {"full": [5, 1, 1, 4], "full_qk_norm": [7, 1, 1], "rolling": [4, 1, 1, 1, 1, 1, 1],
              "rolling_prompt_longer_than_window": [9, 1, 1, 1]}[case]
    outs, pc, rc = _run_cached(ref_attention, attention.apply_attention, ref_p, port_p, pair, x,
                               chunks, max_len=14)
    for got, want in outs:
        _close(got, want, F32)
    _close(pc.k, rc.k, F32)
    _close(pc.v, rc.v, F32)
    assert int(pc.next_pos) == int(rc.next_pos) and pc.rolling == rc.rolling
    # and the stateless path
    pos = np.arange(14, dtype=np.int32)
    want, _ = ref_attention(ref_p, jnp.asarray(x), jnp.asarray(pos), cfg=pair[0])
    got, cache = attention.apply_attention(port_p, torch.from_numpy(x), torch.from_numpy(pos), pair[1])
    assert cache is None
    _close(got, want, F32)


def test_full_cache_write_clamps_like_dynamic_update_slice():
    """A write that would run past the cache starts earlier, as JAX clamps ``dynamic_update_slice``."""
    pair = _cfgs(activation_dtype="float32")
    ref_p, port_p = _attn_params(pair)
    x = _x(1, 6, 128, seed=9)
    # 4 tokens into an 8-slot cache: positions 0-3, then 6-9 (start 6 clamps to 4)
    outs, pc, rc = _run_cached(
        lambda p, xx, pos, cfg, cache: ref_attention(p, xx, pos + (2 if pos[0] else 0), cfg=cfg, cache=cache),
        lambda p, xx, pos, c, cache: attention.apply_attention(p, xx, pos + (2 if int(pos[0]) else 0), c,
                                                               cache=cache),
        ref_p, port_p, pair, np.concatenate([x, x[:, :2]], axis=1), [4, 4], max_len=8)
    for got, want in outs:
        _close(got, want, F32)
    _close(pc.k, rc.k, F32)
    assert int(pc.next_pos) == int(rc.next_pos) == 10
    with pytest.raises(ValueError, match="do not fit"):
        attention.apply_attention(port_p, torch.from_numpy(x), torch.arange(6, dtype=torch.int32), pair[1],
                                  cache=attention.init_kv_cache(pair[1], 1, 4))


def test_unported_attention_raises_naming_its_item():
    cfg = get_config("minicpm3-4b").reduced()
    with pytest.raises(NotImplementedError, match="11c"):
        attention.desc_attention(cfg)
    assert dataclasses.fields(attention.KVCache)[-1].name == "rolling"
