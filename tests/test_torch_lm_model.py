"""The LM scaffold's models and optimizer: the port against the JAX reference on the same inputs.

The five attention-family configs (gemma-2b, yi-6b, chameleon-34b,
nemotron-4-340b, hubert-xlarge), reduced, with the reference's params
carried across (``repro_torch.convert.lm_params_from_tree``): forward
logits, prefill and decode, and one step's gradients within 1e-4 in f32;
teacher-forced decode against forward within 2e-3 (the band of
``tests/test_archs.py``); reduced gemma in bf16 within 5e-2 of the largest
logit. ``AdamW.update`` on equal grads within 1e-6, two microbatches equal
to one within 1e-5; a tied table's gradient over 64 bf16 loss chunks
within 1e-4 on average (gemma-2b, mamba2-130m). Parameter counts of the full configs from descriptors
(no allocation) and the registry. The MLA and MoE configs have their own
files (``tests/test_torch_lm_mla.py``, ``tests/test_torch_lm_moe.py``).
"""
from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.registry import runnable_cells as ref_runnable_cells
from repro.models.model import build_model as ref_build_model
from repro.training.losses import chunked_lm_loss as ref_chunked_lm_loss
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.optimizer import warmup_cosine as ref_warmup_cosine
from repro_torch.configs import ARCHS, SHAPES, get_config, runnable_cells
from repro_torch.convert import lm_params_from_tree, lm_params_to_tree
from repro_torch.core import prng
from repro_torch.models import module
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamW, tree_leaves, tree_map, warmup_cosine
from repro_torch.training.train import loss_and_grads

FAMILY = ("gemma-2b", "yi-6b", "chameleon-34b", "nemotron-4-340b", "hubert-xlarge")
DECODERS = tuple(a for a in FAMILY if a != "hubert-xlarge")
B, T = 2, 16


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    """Per (arch, activation dtype, param dtype): (reference model, port model, reference params,
    port params, inputs). The default is f32 activations and the config's own param dtype."""
    out = {}

    def get(arch: str, act: str = "float32", param: str | None = None):
        if (arch, act, param) not in out:
            kw = {"activation_dtype": act, **({"param_dtype": param} if param else {})}
            ref_model = ref_build_model(ref_get_config(arch).reduced().replace(**kw))
            model = build_model(get_config(arch).reduced().replace(**kw))
            ref_params = ref_model.init(jax.random.key(0))
            params = lm_params_from_tree(jax.tree.map(np.asarray, ref_params))
            cfg = model.cfg
            rng = np.random.default_rng(1)
            if cfg.input_mode == "tokens":
                inputs = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
            else:
                inputs = rng.normal(size=(B, T, cfg.frame_dim)).astype(np.float32)
            out[(arch, act, param)] = (ref_model, model, ref_params, params, inputs)
        return out[(arch, act, param)]

    return get


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", FAMILY)
def test_forward_matches_the_reference(arch, built):
    ref_model, model, ref_params, params, inputs = built(arch)
    want, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(inputs))
    with torch.no_grad():
        got, metrics = model.forward(params, torch.from_numpy(inputs))
    assert got.shape == (B, T, model.cfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    assert set(metrics) == {"aux_loss", "router_z", "drop_fraction"}


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_the_reference(arch, built):
    ref_model, model, ref_params, params, inputs = built(arch)
    Lp = T // 2
    ref_cache = ref_model.init_cache(B, T)
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(inputs[:, :Lp]), ref_cache)
    cache = model.init_cache(B, T, "cpu")
    with torch.no_grad():
        got, cache = model.prefill(params, torch.from_numpy(inputs[:, :Lp]), cache)
        _close(got, want, 1e-4)
        decode = jax.jit(ref_model.decode)
        for t in range(Lp, T):
            want, ref_cache = decode(ref_params, jnp.asarray(inputs[:, t : t + 1]), ref_cache,
                                     jnp.asarray([t], jnp.int32))
            got, cache = model.decode(params, torch.from_numpy(inputs[:, t : t + 1]), cache,
                                      torch.tensor([t], dtype=torch.int32))
            _close(got, want, 1e-4)
    _close(cache.k, ref_cache.k, 1e-4)
    _close(cache.v, ref_cache.v, 1e-4)
    assert cache.next_pos.tolist() == np.asarray(ref_cache.next_pos).tolist() == [T] * model.cfg.num_layers


@pytest.mark.parametrize("arch", DECODERS)
def test_teacher_forced_decode_matches_forward(arch, built):
    """The port's own teacher-forced decode reproduces its stateless forward (``tests/test_archs.py``'s band)."""
    _, model, _, params, inputs = built(arch)
    tokens = torch.from_numpy(inputs[:1])
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


def _batch(model, inputs):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[:, -1] = 0.0
    return {"inputs": inputs, "labels": labels, "mask": mask}


@pytest.mark.parametrize("arch", FAMILY)
def test_one_step_gradients_match_the_reference(arch, built):
    """f32 params and activations: every gradient leaf within 1e-4 of its largest entry.

    chameleon and nemotron keep bf16 params, whose gradients are bf16 in both
    packages (one bf16 step is 2**-8); here they run with f32 params, and
    in their own bf16 below.
    """
    ref_model, model, ref_params, params, inputs = built(arch, param="float32")
    _check_gradients(ref_model, model, ref_params, params, inputs, 1e-4)


@pytest.mark.parametrize("arch", ["chameleon-34b", "nemotron-4-340b"])
def test_bf16_param_gradients_match_the_reference(arch, built):
    """The configs' own bf16 params: bf16 gradients within the bf16 band, 5e-2 of the largest entry."""
    _check_gradients(*built(arch), 5e-2)


def _check_gradients(ref_model, model, ref_params, params, inputs, band: float) -> None:
    batch = _batch(model, inputs)

    def ref_loss(p, b):
        hidden, _ = ref_model.hidden(p, b["inputs"])
        loss, _ = ref_chunked_lm_loss(lambda h: ref_model.logits(p, h), hidden, b["labels"], b["mask"])
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(ref_loss))(ref_params, jax.tree.map(jnp.asarray, batch))
    grads, metrics = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-6)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want)):
        assert g.shape == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
        w = np.asarray(w, np.float32)
        assert np.abs(g.float().numpy() - w).max() <= band * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m"])
def test_a_tied_head_sums_the_chunks_gradients_in_float32(arch, built, monkeypatch):
    """bf16 activations, an f32 tied table, 64 loss chunks: the table's gradient from the head against
    the reference's, whose scan sums each chunk's cotangent in f32: the mean |difference| within 1e-4
    of the mean |gradient|, and the largest within 5e-3 of the largest entry.

    The backbone is replaced by one fixed bf16 hidden state in both
    packages, so the head is all that differs. Each chunk's bf16 product
    may round one unit apart in the two packages, which the mean hardly
    sees (it reads 2e-7 to 8e-7 here); a table cast to bf16 once for every
    chunk sums their gradients in bf16 and reads 2.5e-3.
    """
    ref_model, model, ref_params, params, _ = built(arch, "bfloat16", "float32")
    cfg, C, L = model.cfg, 4, 256
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    labels, mask = np.roll(tokens, -1, 1), np.ones((B, L), np.float32)
    hidden = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    ref_hidden = jnp.asarray(hidden).astype(jnp.bfloat16)

    def ref_loss(table):
        p = {**ref_params, "embed": {**ref_params["embed"], "tok": table}}
        return ref_chunked_lm_loss(lambda h: ref_model.logits(p, h), ref_hidden, jnp.asarray(labels),
                                   jnp.asarray(mask), chunk=C)[0]

    want = np.asarray(jax.jit(jax.grad(ref_loss))(ref_params["embed"]["tok"]), np.float32)
    monkeypatch.setattr(type(model), "hidden",
                        lambda self, p, inputs, positions=None, ctx=None: (torch.from_numpy(hidden).bfloat16(), {}))
    batch = {"inputs": torch.from_numpy(tokens), "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    grads, _ = loss_and_grads(model, {"embed": params["embed"], "head": params["head"]}, batch, loss_chunk=C)
    got = grads["embed"]["tok"]
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.mean() <= 1e-4 * np.abs(want).mean() and diff.max() <= 5e-3 * np.abs(want).max()


def test_adamw_update_matches_the_reference():
    rng = np.random.default_rng(3)
    shapes = {"stack": {"w": (9, 4, 6), "scale": (9, 6)}, "embed": (40, 8), "bias": (7,), "count": ()}
    tree = lambda: jax.tree.map(lambda s: np.asarray(rng.normal(size=s), np.float32), shapes,
                                is_leaf=lambda x: isinstance(x, tuple))
    params0 = tree()
    ref_opt = RefAdamW(learning_rate=ref_warmup_cosine(1e-2, 1, 4), clip_norm=0.5)
    opt = AdamW(learning_rate=warmup_cosine(1e-2, 1, 4), clip_norm=0.5, scan_chunks=4)
    ref_params, ref_state = jax.tree.map(jnp.asarray, params0), None
    params = lm_params_from_tree(params0)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    ref_update = jax.jit(ref_opt.update)
    for _ in range(3):
        grads = tree()
        ref_params, ref_state, ref_m = ref_update(jax.tree.map(jnp.asarray, grads), ref_state, ref_params)
        params, state, m = opt.update(lm_params_from_tree(grads), state, params)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(ref_m[name]), rtol=1e-6)
        for got, want in zip(tree_leaves(params) + tree_leaves(state.mu) + tree_leaves(state.nu),
                             jax.tree.leaves(ref_params) + jax.tree.leaves(ref_state.mu)
                             + jax.tree.leaves(ref_state.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        assert int(state.count) == int(ref_state.count)


def test_two_microbatches_equal_one(built):
    _, model, _, params, _ = built("yi-6b")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, model.cfg.vocab_size, (4, T)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(tokens), "labels": torch.from_numpy(np.roll(tokens, -1, 1)),
             "mask": torch.ones((4, T))}
    g1, m1 = loss_and_grads(model, params, batch)
    g2, m2 = loss_and_grads(model, params, batch, microbatches=2)
    for name in ("loss", "ce", "accuracy"):
        np.testing.assert_allclose(float(m2[name]), float(m1[name]), rtol=1e-5)
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30)


def test_reduced_gemma_in_bf16_matches_the_reference(built):
    ref_model, model, ref_params, params, inputs = built("gemma-2b", "bfloat16")
    want = np.asarray(jax.jit(ref_model.forward)(ref_params, jnp.asarray(inputs))[0])
    with torch.no_grad():
        got = model.forward(params, torch.from_numpy(inputs))[0].numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("arch", FAMILY)
def test_full_config_param_counts_match_the_reference(arch):
    """Counted from descriptors on both sides; the port's abstract params allocate nothing (``meta``)."""
    ref_model, model = ref_build_model(ref_get_config(arch)), build_model(get_config(arch))
    assert model.num_params() == ref_model.num_params()
    assert model.active_params() == ref_model.active_params()
    assert model.matmul_params() == ref_model.matmul_params()
    abstract = tree_leaves(model.abstract())
    assert all(t.device.type == "meta" for t in abstract)
    assert sum(t.numel() for t in abstract) == ref_model.num_params()
    if arch == "gemma-2b":
        assert model.num_params() == model.matmul_params() == 2_506_172_416


def test_registry_matches_the_reference():
    assert ARCHS == REF_ARCHS
    assert runnable_cells() == ref_runnable_cells()
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == {
        "train_4k": (4096, 256, "train"), "prefill_32k": (32768, 32, "prefill"),
        "decode_32k": (32768, 128, "decode"), "long_500k": (524288, 1, "decode")}
    for arch in ARCHS:
        for ref_cfg, cfg in ((ref_get_config(arch), get_config(arch)),
                             (ref_get_config(arch).reduced(), get_config(arch).reduced())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
            assert (cfg.padded_vocab, cfg.q_per_kv, cfg.sub_quadratic) == (
                ref_cfg.padded_vocab, ref_cfg.q_per_kv, ref_cfg.sub_quadratic)
            assert cfg.dtype("param") == getattr(torch, cfg.param_dtype)


def test_params_carry_across_and_back_with_equal_dtypes(built):
    ref_model, model, ref_params, params, _ = built("chameleon-34b")  # bf16 params
    tree = jax.tree.map(np.asarray, ref_params)
    assert tree_leaves(params)[0].dtype == torch.bfloat16
    back = lm_params_to_tree(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_init_is_stable_and_drawn_in_pieces(monkeypatch):
    model = build_model(get_config("yi-6b").reduced())
    a = model.init(prng.key(5), "cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(model.init(prng.key(5), "cpu"))):
        assert torch.equal(x, y)
    monkeypatch.setattr(module, "_DRAW_PIECE", 1000)  # piece i of a leaf: normal(fold_in(leaf key, i))
    w = model.init(prng.key(5), "cpu")["stack"]["layers"]["mlp"]["w_up"].reshape(-1)
    leaf_key = prng.fold_in(prng.key(5), zlib.crc32(b"stack/layers/mlp/w_up") % 2**31)
    for i in (0, 3):
        want = 128**-0.5 * prng.normal(prng.fold_in(leaf_key, i), (1000,))
        assert torch.equal(w[i * 1000 : (i + 1) * 1000], want)
    stack = a["stack"]["layers"]
    assert torch.equal(stack["ln_attn"]["scale"], torch.ones(4, 128))
    w = stack["mlp"]["w_up"]
    assert abs(float(w.std()) - 128**-0.5) < 0.01  # fan-in normal
    abstract = model.abstract()
    assert tree_map(lambda t: (t.shape, t.dtype), a) == tree_map(lambda t: (t.shape, t.dtype), abstract)


@pytest.mark.parametrize("remat, group", [("full", 1), ("block", 1), ("full", 2), ("block", 2)])
def test_remat_policies_give_the_gradients_of_no_remat(remat, group):
    """Recompute changes no value: every policy (and grouped remat, each layer checkpointed again inside
    its group) gives remat="none"'s loss and gradients, through the flash path's own Q-block checkpoints."""
    base = get_config("yi-6b").reduced().replace(activation_dtype="float32", attn_q_chunk=4, attn_kv_chunk=8)
    model = build_model(base.replace(remat="none"))
    params = model.init(prng.key(6), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, base.vocab_size, (2, T)).astype(np.int32))
    batch = {"inputs": tokens, "labels": tokens.roll(-1, 1), "mask": torch.ones((2, T))}
    want, m_want = loss_and_grads(model, params, batch)
    got, m_got = loss_and_grads(build_model(base.replace(remat=remat, remat_group=group)), params, batch)
    assert float(m_got["loss"]) == float(m_want["loss"])
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)
