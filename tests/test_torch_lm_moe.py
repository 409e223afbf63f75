"""MoE (mixtral-8x22b's SwiGLU experts, grok-1-314b's GELU experts): the port against the JAX reference.

``apply_moe`` in f32 within 1e-4 and bf16 within 5e-2 of the largest value,
with and without an overflowing group (``drop_fraction > 0``), and its three
metrics; the multi-group path with ``MOE_GROUP`` set small in both
packages; the drop pattern and the top-k tie order read exactly through
indicator experts (each expert's output is its own unit vector, so a
token's output holds the combine weight of each pick it kept), with random
and all-zero routers; and reduced mixtral-8x22b and grok-1-314b whole:
forward and one step's gradients within 1e-4 (f32, overflowing groups),
prefill/decode within 1e-4 (mixtral's rolling cache), teacher-forced decode
against forward within 2e-3, the config's bf16 params carried across and
back, the full configs' parameter counts (mixtral's depth cut to 2 and 1
layers too), and remat "block" giving no remat's gradients.
Inputs are numpy-seeded; the reference's weights are carried across.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.model import build_model as ref_build_model
from repro.models.module import init_params as ref_init_params
from repro.training.losses import chunked_lm_loss as ref_chunked_lm_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree, lm_params_to_tree
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import loss_and_grads

ARCHS = ("mixtral-8x22b", "grok-1-314b")
F32, BF16 = 1e-4, 5e-2
B, T = 2, 16
OVERFLOW = 0.5  # capacity factor at which a 16-token group of 4 experts has 8 slots an expert and drops picks


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch: str, **kw):
    return ref_get_config(arch).reduced().replace(**kw), get_config(arch).reduced().replace(**kw)


def _moe_params(ref_cfg, seed: int = 0):
    tree = jax.tree.map(np.asarray, ref_init_params(jax.random.key(seed), ref_moe.desc_moe(ref_cfg)))
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


def _both(ref_p, port_p, x, ref_cfg, cfg):
    """apply_moe of both packages on x (the reference freshly traced, so a patched MOE_GROUP holds)."""
    ref_fn = jax.jit(lambda p, xx: ref_moe.apply_moe(p, xx, ref_cfg))
    want, want_m = ref_fn(ref_p, jnp.asarray(x, ref_cfg.activation_dtype))
    with torch.no_grad():
        got, got_m = moe.apply_moe(port_p, torch.from_numpy(x).to(cfg.dtype("act")), cfg)
    return got, got_m, want, want_m


def _check_metrics(got_m: dict, want_m: dict) -> None:
    """aux_loss and router_z (f32) within 1e-5; drop_fraction in the activation dtype, within 2 of its ulps
    (XLA may turn the reference's division by the token count into a product with its reciprocal)."""
    assert set(got_m) == set(want_m) == {"aux_loss", "router_z", "drop_fraction"}
    for k in ("aux_loss", "router_z"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5)
    drop = got_m["drop_fraction"]
    assert str(drop.dtype).split(".")[1] == str(want_m["drop_fraction"].dtype)
    np.testing.assert_allclose(float(drop), float(want_m["drop_fraction"]), rtol=2 * torch.finfo(drop.dtype).eps)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", ["fits", "overflows"])
def test_apply_moe_and_its_metrics_match_the_reference(arch, dtype, capacity):
    kw = {"activation_dtype": dtype, "param_dtype": "float32"}
    if capacity == "overflows":
        kw["capacity_factor"] = OVERFLOW
    ref_cfg, cfg = _cfgs(arch, **kw)
    ref_p, port_p = _moe_params(ref_cfg)
    got, got_m, want, want_m = _both(ref_p, port_p, _x(B, T, cfg.d_model), ref_cfg, cfg)
    assert got.dtype == cfg.dtype("act")
    _close(got, want, *((F32,) if dtype == "float32" else (BF16, True)))
    _check_metrics(got_m, want_m)
    assert (float(got_m["drop_fraction"]) > 0) == (capacity == "overflows")


@pytest.mark.parametrize("L", [48, 40])
def test_the_multi_group_path_matches_the_reference(monkeypatch, L):
    """MOE_GROUP = 16: 48 tokens are 3 groups a row, 40 one group (not a multiple), in both packages."""
    monkeypatch.setattr(ref_moe, "MOE_GROUP", 16)
    monkeypatch.setattr(moe, "MOE_GROUP", 16)
    ref_cfg, cfg = _cfgs("mixtral-8x22b", activation_dtype="float32", param_dtype="float32", capacity_factor=0.75)
    ref_p, port_p = _moe_params(ref_cfg, seed=2)
    got, got_m, want, want_m = _both(ref_p, port_p, _x(B, L, cfg.d_model, seed=3), ref_cfg, cfg)
    _close(got, want, F32)
    _check_metrics(got_m, want_m)
    assert float(got_m["drop_fraction"]) > 0


def _indicator(ref_cfg, router: np.ndarray):
    """Experts whose output on any token with feature 0 equal to 1 is their own unit vector e_e."""
    E, D, F = ref_cfg.num_experts, ref_cfg.d_model, ref_cfg.d_ff
    w_up = np.zeros((E, D, F), np.float32)
    w_up[:, 0, :] = 1.0  # relu(x · w_up)^2 = 1 in every column
    w_down = np.zeros((E, F, D), np.float32)
    w_down[np.arange(E), :, np.arange(E)] = 1.0 / F
    tree = {"router": router.astype(np.float32), "w_up": w_up, "w_down": w_down}
    return tree, lm_params_from_tree(tree)


@pytest.mark.parametrize("router", ["random", "zero"])
def test_the_drop_pattern_and_tie_order_match_the_reference(router):
    ref_cfg, cfg = _cfgs("mixtral-8x22b", mlp="relu2", activation_dtype="float32", param_dtype="float32",
                         capacity_factor=OVERFLOW)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    w = _x(cfg.d_model, E, seed=4) if router == "random" else np.zeros((cfg.d_model, E), np.float32)
    ref_p, port_p = _indicator(ref_cfg, w)
    x = _x(B, T, cfg.d_model, seed=5)
    x[..., 0] = 1.0
    got, got_m, want, want_m = _both(ref_p, port_p, x, ref_cfg, cfg)
    kept_got, kept_want = got[..., :E].numpy(), np.asarray(want)[..., :E]  # [B, T, E]: each kept pick's weight
    assert ((kept_got != 0) == (kept_want != 0)).all() and (kept_want != 0).any()
    np.testing.assert_allclose(kept_got, kept_want, atol=1e-5)
    assert not np.asarray(want)[..., E:].any()
    _check_metrics(got_m, want_m)
    C = moe.capacity(T, cfg)
    kept = (kept_got != 0).sum(axis=(1, 2))
    assert (kept < K * T).all() and float(got_m["drop_fraction"]) == 1 - kept.mean() / (K * T)
    if router == "zero":
        # every prob is 1/E: the picks are experts 0 then 1 (lower index first, as jax.lax.top_k), each
        # keeping the first C tokens of the group
        _, _, top_p, top_e = moe._route(torch.from_numpy(x[:1]), port_p["router"], cfg)
        assert (top_e == torch.tensor([0, 1])).all() and (top_p == 0.5).all()
        want_kept = np.zeros((T, E), bool)
        want_kept[:C, :2] = True
        assert ((kept_got[0] != 0) == want_kept).all()


# ---------------------------------------------------------------------------
# The whole models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """Per (arch, capacity factor or None for the config's, param dtype): (reference model, port
    model, reference params, port params, tokens), f32 activations."""
    out = {}

    def get(arch: str, capacity_factor: float | None = None, param: str = "float32"):
        key = (arch, capacity_factor, param)
        if key not in out:
            kw = {"activation_dtype": "float32", "param_dtype": param}
            if capacity_factor is not None:
                kw["capacity_factor"] = capacity_factor
            ref_model = ref_build_model(ref_get_config(arch).reduced().replace(**kw))
            model = build_model(get_config(arch).reduced().replace(**kw))
            ref_params = ref_model.init(jax.random.key(0))
            params = lm_params_from_tree(jax.tree.map(np.asarray, ref_params))
            tokens = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32)
            out[key] = (ref_model, model, ref_params, params, tokens)
        return out[key]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_one_step_gradients_match_the_reference(arch, built):
    """Overflowing groups (every layer drops picks): logits, metrics, loss and every gradient leaf."""
    ref_model, model, ref_params, params, tokens = built(arch, OVERFLOW)
    want, want_m = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    with torch.no_grad():
        got, got_m = model.forward(params, torch.from_numpy(tokens))
    _close(got, want, F32)
    _check_metrics(got_m, want_m)
    assert float(got_m["drop_fraction"]) > 0
    rng = np.random.default_rng(2)
    batch = {"inputs": tokens, "labels": rng.integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32),
             "mask": np.ones((B, T), np.float32)}

    def ref_loss(p, b):
        hidden, metrics = ref_model.hidden(p, b["inputs"])
        loss, _ = ref_chunked_lm_loss(lambda h: ref_model.logits(p, h), hidden, b["labels"], b["mask"])
        cfg = ref_model.cfg
        return loss + cfg.router_aux_weight * metrics["aux_loss"] + 1e-3 * metrics["router_z"]

    want_loss, want_g = jax.jit(jax.value_and_grad(ref_loss))(ref_params, jax.tree.map(jnp.asarray, batch))
    grads, metrics = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-6)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(want_g)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g.float().numpy() - w).max() <= F32 * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, built):
    ref_model, model, ref_params, params, tokens = built(arch)
    Lp = T // 2
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(tokens[:, :Lp]), ref_model.init_cache(B, T))
    cache = model.init_cache(B, T, "cpu")
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
    _close(cache.k, ref_cache.k, F32)
    _close(cache.v, ref_cache.v, F32)
    assert cache.rolling == ref_cache.rolling == (arch == "mixtral-8x22b")
    assert cache.next_pos.tolist() == np.asarray(ref_cache.next_pos).tolist() == [T] * model.cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch, built):
    _, model, _, params, tokens = built(arch)
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


def test_bf16_params_carry_across_and_back(built):
    _, _, ref_params, params, _ = built("mixtral-8x22b", param="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    for a, b in zip(jax.tree.leaves(lm_params_to_tree(params)), jax.tree.leaves(jax.tree.map(np.asarray, ref_params))):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch, layers, total, active", [
    ("mixtral-8x22b", None, 140_630_071_296, None),
    ("mixtral-8x22b", 2, 5_410_781_184, 1_786_902_528),
    ("mixtral-8x22b", 1, 2_906_720_256, None),
    ("grok-1-314b", None, 213_410_125_824, None),
])
def test_full_config_param_counts_match_the_reference(arch, layers, total, active):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if layers is not None:
        ref_cfg, cfg = ref_cfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    assert model.num_params() == ref_model.num_params() == total
    assert model.active_params() == ref_model.active_params()
    assert model.matmul_params() == ref_model.matmul_params()
    if active is not None:
        assert model.active_params() == active
    assert sum(t.numel() for t in tree_leaves(model.abstract())) == total


def test_the_cli_trains_reduced_mixtral():
    """Exit 0: the mean loss of the last 5 steps is below that of the first 5 (``LEARNING``)."""
    assert train_cli.main(["--device", "cpu", "--arch", "mixtral-8x22b", "--reduced", "--steps", "20",
                           "--batch", "4", "--seq", "32"]) == 0


def test_block_remat_gives_the_gradients_of_no_remat():
    """Recompute changes no value through the MoE layer: under "block" the expert ``bmm``s are recomputed,
    not saved, as the reference's policy treats its batched expert einsums."""
    from repro_torch.core import prng

    base = get_config("mixtral-8x22b").reduced().replace(activation_dtype="float32", param_dtype="float32",
                                                         capacity_factor=OVERFLOW)
    model = build_model(base.replace(remat="none"))
    params = model.init(prng.key(6), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, base.vocab_size, (2, T)).astype(np.int32))
    batch = {"inputs": tokens, "labels": tokens.roll(-1, 1), "mask": torch.ones((2, T))}
    want, m_want = loss_and_grads(model, params, batch)
    got, m_got = loss_and_grads(build_model(base.replace(remat="block")), params, batch)
    assert float(m_got["loss"]) == float(m_want["loss"]) and float(m_want["drop_fraction"]) > 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)
