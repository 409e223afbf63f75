"""MLA (minicpm3-4b): the port's latent attention and whole model against the JAX reference.

``apply_mla`` through each of its three paths (dense; materialized, Lq above
the Q chunk; absorbed, ``w_uk`` folded into the query, for Lq within the Q
chunk and S above the KV chunk), with and without the query's low-rank
(``q_lora_rank`` 0 and 64), in f32 within 1e-4 and bf16 within 5e-2 of the
largest value (the bf16 absorbed path against the reference's bf16 dense
path: jax's CPU runtime cannot run one of the reference's absorbed-path
einsums in bf16); prefill and decode through the latent cache (``ckv``,
``kpe``, ``next_pos``, the clamped start); and reduced minicpm3-4b whole:
forward, prefill/decode and one step's gradients within 1e-4 (f32),
teacher-forced decode against forward within 2e-3 (``tests/test_archs.py``'s
band), its full config's parameter count. Inputs are numpy-seeded and the
reference's weights are carried across.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models.model import build_model as ref_build_model
from repro.models.module import init_params as ref_init_params
from repro.training.losses import chunked_lm_loss as ref_chunked_lm_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree
from repro_torch.launch import train as train_cli
from repro_torch.models import attention
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import loss_and_grads

ARCH = "minicpm3-4b"
F32, BF16 = 1e-4, 5e-2
B, T = 2, 16

ref_apply_mla = jax.jit(ref_attn.apply_mla, static_argnames="cfg")

# path: (tokens, the config's replacements that make apply_mla take it)
PATHS = {
    "dense": (12, {}),
    "materialized": (20, {"attn_q_chunk": 8, "attn_kv_chunk": 8}),
    "absorbed": (12, {"attn_q_chunk": 16, "attn_kv_chunk": 8}),
}
PATH_FN = {"dense": "_mla_attend_dense", "materialized": "_mla_attend_materialized",
           "absorbed": "_mla_attend_flash"}


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    return ref_get_config(ARCH).reduced().replace(**kw), get_config(ARCH).reduced().replace(**kw)


def _attn_params(ref_cfg, seed: int = 0):
    """The reference's MLA params from its descriptors (norm scales moved off their ones): both trees."""
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.key(seed), ref_attn.desc_attention(ref_cfg)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype) if a.ndim == 1 else a, tree)
    return tree, lm_params_from_tree(tree)


def _x(*shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want, band: float, rel_to_max: bool = False) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rel_to_max:
        assert np.abs(got - want).max() <= band * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=band, rtol=band)


def test_descriptors_match_the_reference():
    for q_lora in (0, 64):
        ref_cfg, cfg = _cfgs(q_lora_rank=q_lora)
        want = ref_attn.desc_attention(ref_cfg)
        got = attention.desc_attention(cfg)
        assert sorted(got) == sorted(want) and ("w_dq" in got) == (q_lora > 0) and ("w_q" in got) == (q_lora == 0)
        for name, d in got.items():
            w = want[name]
            assert (d.shape, d.axes, d.init, d.scale) == (tuple(w.shape), tuple(w.axes), w.init, w.scale)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("q_lora", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_matches_the_reference_on_each_path(monkeypatch, path, q_lora, dtype):
    L, kw = PATHS[path]
    ref_cfg, cfg = _cfgs(q_lora_rank=q_lora, activation_dtype=dtype, **kw)
    ref_p, port_p = _attn_params(ref_cfg)
    x = _x(B, L, cfg.d_model)
    pos = np.arange(L, dtype=np.int32)
    taken = []
    for name, fn in ((n, getattr(attention, n)) for n in PATH_FN.values()):
        monkeypatch.setattr(attention, name, lambda *a, _n=name, _f=fn: (taken.append(_n), _f(*a))[1])
    # jax's CPU runtime has no bf16 x bf16 = f32 dot for one of the reference's absorbed-path einsums, so
    # there the bf16 yardstick is the reference's dense path (its tests hold the flash paths to dense)
    want_cfg = ref_cfg
    if (path, dtype) == ("absorbed", "bfloat16"):
        want_cfg = ref_cfg.replace(attn_q_chunk=512, attn_kv_chunk=1024)
    want, _ = ref_apply_mla(ref_p, jnp.asarray(x, dtype), jnp.asarray(pos), cfg=want_cfg)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, cache = attention.apply_mla(port_p, tx, torch.from_numpy(pos), cfg)
    assert taken == [PATH_FN[path]] and cache is None and got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, F32)
    else:
        _close(got, want, BF16, rel_to_max=True)


def _run_cached(ref_cfg, cfg, ref_p, port_p, x, chunks, max_len, shift=lambda p: p):
    """Prefill / decode through both packages' latent caches in the given chunks."""
    rc = ref_attn.init_mla_cache(ref_cfg, x.shape[0], max_len)
    pc = attention.init_mla_cache(cfg, x.shape[0], max_len)
    start = 0
    for n in chunks:
        pos = shift(np.arange(start, start + n, dtype=np.int32))
        ry, rc = ref_apply_mla(ref_p, jnp.asarray(x[:, start : start + n]), jnp.asarray(pos), cfg=ref_cfg, cache=rc)
        py, pc = attention.apply_mla(port_p, torch.from_numpy(x[:, start : start + n]), torch.from_numpy(pos), cfg,
                                     cache=pc)
        _close(py, ry, F32)
        start += n
    return pc, rc


@pytest.mark.parametrize("case", ["dense", "absorbed_decode", "clamped_start"])
def test_prefill_and_decode_through_the_latent_cache_match_the_reference(case):
    kw = {"activation_dtype": "float32", "q_lora_rank": 64}
    if case == "absorbed_decode":  # prefill of 5 > 4 materializes; each decode step (S = 14 > 4) absorbs
        kw.update(attn_q_chunk=4, attn_kv_chunk=4)
    ref_cfg, cfg = _cfgs(**kw)
    ref_p, port_p = _attn_params(ref_cfg, seed=3)
    x = _x(B, 14, cfg.d_model, seed=4)
    if case == "clamped_start":
        # 4 tokens into an 8-slot cache at positions 0-3, then at 6-9: the start 6 clamps to 4
        pc, rc = _run_cached(ref_cfg, cfg, ref_p, port_p, x, [4, 4], 8, lambda p: p + (2 if p[0] else 0))
        assert int(pc.next_pos) == int(rc.next_pos) == 10
    else:
        pc, rc = _run_cached(ref_cfg, cfg, ref_p, port_p, x, [5, 1, 1, 1, 2, 1], 14)
        assert int(pc.next_pos) == int(rc.next_pos) == 11
    assert pc.ckv.shape == tuple(rc.ckv.shape) and pc.kpe.shape == tuple(rc.kpe.shape)
    _close(pc.ckv, rc.ckv, F32)  # the un-normalised latent: kv_norm is applied on read
    _close(pc.kpe, rc.kpe, F32)
    with pytest.raises(ValueError, match="do not fit"):
        attention.apply_mla(port_p, torch.from_numpy(x[:, :6]), torch.arange(6, dtype=torch.int32), cfg,
                            cache=attention.init_mla_cache(cfg, B, 4))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """(reference model, port model, reference params, port params, tokens): reduced minicpm3-4b,
    f32 activations and params, chunks small enough that T tokens take every MLA path."""
    kw = {"activation_dtype": "float32", "attn_q_chunk": 4, "attn_kv_chunk": 8}
    ref_model = ref_build_model(ref_get_config(ARCH).reduced().replace(**kw))
    model = build_model(get_config(ARCH).reduced().replace(**kw))
    ref_params = ref_model.init(jax.random.key(0))
    params = lm_params_from_tree(jax.tree.map(np.asarray, ref_params))
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32)
    return ref_model, model, ref_params, params, tokens


def test_forward_matches_the_reference(built):
    ref_model, model, ref_params, params, tokens = built
    want, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    with torch.no_grad():
        got, metrics = model.forward(params, torch.from_numpy(tokens))
    assert got.shape == (B, T, model.cfg.padded_vocab)
    _close(got, want, F32)
    assert all(float(v) == 0.0 for v in metrics.values())


def test_prefill_and_decode_match_the_reference(built):
    ref_model, model, ref_params, params, tokens = built
    Lp = T // 2
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(tokens[:, :Lp]), ref_model.init_cache(B, T))
    cache = model.init_cache(B, T, "cpu")
    assert isinstance(cache, attention.MLACache)
    with torch.no_grad():
        got, cache = model.prefill(params, torch.from_numpy(tokens[:, :Lp]), cache)
        _close(got, want, F32)
        decode = jax.jit(ref_model.decode)
        for t in range(Lp, T):
            want, ref_cache = decode(ref_params, jnp.asarray(tokens[:, t : t + 1]), ref_cache,
                                     jnp.asarray([t], jnp.int32))
            got, cache = model.decode(params, torch.from_numpy(tokens[:, t : t + 1]), cache,
                                      torch.tensor([t], dtype=torch.int32))
            _close(got, want, F32)
    _close(cache.ckv, ref_cache.ckv, F32)
    _close(cache.kpe, ref_cache.kpe, F32)
    assert cache.next_pos.tolist() == np.asarray(ref_cache.next_pos).tolist() == [T] * model.cfg.num_layers


def test_teacher_forced_decode_matches_forward(built):
    _, model, _, params, tokens = built
    tokens = torch.from_numpy(tokens[:1])
    Lp = T // 2
    with torch.no_grad():
        full, _ = model.forward(params, tokens)
        logits, cache = model.prefill(params, tokens[:, :Lp], model.init_cache(1, T, "cpu"))
        outs = [logits[:, -1]]
        for t in range(Lp, T):
            logits, cache = model.decode(params, tokens[:, t : t + 1], cache, torch.tensor([t], dtype=torch.int32))
            outs.append(logits[:, -1])
    stepwise = torch.stack(outs, dim=1)
    np.testing.assert_allclose(stepwise[:, :-1].numpy(), full[:, Lp - 1 : -1].numpy(), atol=2e-3, rtol=2e-3)


def test_one_step_gradients_match_the_reference(built):
    ref_model, model, ref_params, params, tokens = built
    rng = np.random.default_rng(2)
    batch = {"inputs": tokens, "labels": rng.integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32),
             "mask": np.ones((B, T), np.float32)}

    def ref_loss(p, b):
        hidden, _ = ref_model.hidden(p, b["inputs"])
        return ref_chunked_lm_loss(lambda h: ref_model.logits(p, h), hidden, b["labels"], b["mask"])[0]

    want_loss, want = jax.jit(jax.value_and_grad(ref_loss))(ref_params, jax.tree.map(jnp.asarray, batch))
    grads, metrics = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-6)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= F32 * max(np.abs(w).max(), 1e-30)


def test_full_config_param_count_and_cache_match_the_reference():
    ref_model, model = ref_build_model(ref_get_config(ARCH)), build_model(get_config(ARCH))
    assert model.num_params() == ref_model.num_params() == 4_073_937_408
    assert model.matmul_params() == ref_model.matmul_params()
    assert sum(t.numel() for t in tree_leaves(model.abstract())) == ref_model.num_params()
    cfg = model.cfg
    cache = model.init_cache(1, 4128, "meta")
    assert cache.ckv.shape == (62, 1, 4128, 256) and cache.kpe.shape == (62, 1, 4128, 32)
    assert cache.ckv.dtype == cfg.dtype("act")


def test_the_cli_trains_reduced_minicpm3():
    """Exit 0: the mean loss of the last 5 steps is below that of the first 5 (``LEARNING``)."""
    assert train_cli.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "20", "--batch", "4",
                           "--seq", "32"]) == 0
