"""The SSM and hybrid LM families: the port against the JAX reference on the same inputs.

The SSD core (``ssd_chunked`` with several chunks, an initial state and
G = 2 groups, ``ssd_step``, ``ssd_reference``, ``_causal_conv``) and the
mamba2 mixer in its three modes (forward, prefill with ``return_state``,
decode) on seeded numpy inputs; then reduced mamba2-130m and zamba2-2.7b
with one seeded numpy param tree given to both packages
(``repro_torch.convert.lm_params_from_tree`` for the port): forward
logits, prefill and decode logits and every cache leaf, one step's
gradients, teacher-forced decode against forward, the hybrid's nested
remat, greedy tokens and the CLI. Bands: f32 within 1e-4 of the largest
value against the reference, teacher-forced decode within 2e-3 of forward
(``tests/test_archs.py``'s band), the bf16 SSD within 5e-2 of the largest
value. The full configs' parameter counts and cache bytes come from
descriptors and ``meta`` tensors (no allocation).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba2 as ref_mamba2
from repro.models.model import build_model as ref_build_model
from repro.training.lm_serve import greedy_generate as ref_greedy_generate
from repro.training.losses import chunked_lm_loss as ref_chunked_lm_loss
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree
from repro_torch.core import prng
from repro_torch.launch import train as train_cli
from repro_torch.models import mamba2
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.model import build_model
from repro_torch.models.module import map_descs
from repro_torch.models.transformer import HybridCache
from repro_torch.training.lm_serve import greedy_generate
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import loss_and_grads
from repro_torch.utils import tree_size_bytes

FAMILIES = ("mamba2-130m", "zamba2-2.7b")
FULL_PARAMS = {"mamba2-130m": 129_001_920, "zamba2-2.7b": 2_340_750_240}
B, T = 2, 40  # T: a chunk (32) and a partial one of the reduced configs


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _within(got, want, band: float) -> None:
    """max |got - want| at most ``band`` x max |want| (``got`` a tensor, ``want`` an array)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(float(np.abs(want).max()), 1e-30)
    assert err <= band * scale, f"max |err| {err} > {band} x {scale}"


def _ssd_inputs(L: int, H: int = 4, P: int = 8, G: int = 2, N: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(B, L, H, P)).astype(np.float32),
        dt=np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32),  # post-softplus
        A=-np.exp(0.5 * rng.normal(size=(H,))).astype(np.float32),
        Bm=rng.normal(size=(B, L, G, N)).astype(np.float32),
        Cm=rng.normal(size=(B, L, G, N)).astype(np.float32),
        S0=rng.normal(size=(B, H, P, N)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype, band", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_ssd_chunked_matches_the_reference(dtype, band):
    """Four chunks of 8, an initial state, G = 2 groups over H = 4 heads: the output and final state
    against the reference's chunked scan, and (f32) against both packages' token-by-token oracle."""
    d = _ssd_inputs(32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args = [d["x"], d["dt"], d["A"], d["Bm"], d["Cm"]]
    jargs = [jnp.asarray(a, jd if k in (0, 3, 4) else jnp.float32) for k, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(td if k in (0, 3, 4) else torch.float32) for k, a in enumerate(args)]
    want_y, want_S = ref_mamba2.ssd_chunked(*jargs, 8, jnp.asarray(d["S0"]))
    got_y, got_S = mamba2.ssd_chunked(*targs, 8, torch.from_numpy(d["S0"]))
    assert got_y.dtype == td and got_S.dtype == torch.float32
    _within(got_y, want_y, band)
    _within(got_S, want_S, band)
    if dtype == "float32":
        oracle_y, oracle_S = ref_mamba2.ssd_reference(*jargs, jnp.asarray(d["S0"]))
        _within(got_y, oracle_y, 1e-4)
        _within(got_S, oracle_S, 1e-4)
        own_y, own_S = mamba2.ssd_reference(*targs, torch.from_numpy(d["S0"]))
        _within(own_y, oracle_y, 1e-4)
        _within(own_S, oracle_S, 1e-4)


def test_ssd_step_and_the_causal_conv_match_the_reference():
    d = _ssd_inputs(1, seed=1)
    want_y, want_S = ref_mamba2.ssd_step(*(jnp.asarray(d[k][:, 0] if k != "A" else d[k])
                                           for k in ("x", "dt", "A", "Bm", "Cm")), jnp.asarray(d["S0"]))
    got_y, got_S = mamba2.ssd_step(*(torch.from_numpy(d[k][:, 0] if k != "A" else d[k])
                                     for k in ("x", "dt", "A", "Bm", "Cm")), torch.from_numpy(d["S0"]))
    _within(got_y, want_y, 1e-6)
    _within(got_S, want_S, 1e-6)
    rng = np.random.default_rng(2)
    xBC, w, b = (rng.normal(size=s).astype(np.float32) for s in ((B, 11, 24), (4, 24), (24,)))
    for jd, td, band in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = ref_mamba2._causal_conv(jnp.asarray(xBC, jd), jnp.asarray(w), jnp.asarray(b))
        got = mamba2._causal_conv(torch.from_numpy(xBC).to(td), torch.from_numpy(w), torch.from_numpy(b))
        assert got.dtype == td
        _within(got, want, band)


@pytest.fixture(scope="module")
def mixer():
    """(reference cfg, port cfg, reference params, port params) of one reduced mamba2 mixer, G = 2, f32."""
    kw = dict(activation_dtype="float32", ssm_ngroups=2)
    ref_cfg = ref_get_config("mamba2-130m").reduced().replace(**kw)
    cfg = get_config("mamba2-130m").reduced().replace(**kw)
    ref_params = {k: jnp.asarray(v) for k, v in _init_descs(ref_mamba2.desc_mamba2(ref_cfg)).items()}
    return ref_cfg, cfg, ref_params, lm_params_from_tree(jax.tree.map(np.asarray, ref_params))


def _init_descs(descs: dict) -> dict:
    """Seeded numpy values for a reference descriptor dict (its init law's scale, normal everywhere)."""
    rng = np.random.default_rng(3)
    return {k: (d.scale * rng.normal(size=d.shape)).astype(np.float32) for k, d in descs.items()}


def _state_close(got: SSMState, want, band: float = 1e-4) -> None:
    _within(got.S, want.S, band)
    _within(got.conv, want.conv, band)
    assert int(got.next_pos) == int(want.next_pos)


@pytest.mark.parametrize("L", [2, 37], ids=["L<K-1", "L-partial-chunk"])
def test_apply_mamba2_forward_and_prefill_match_the_reference(mixer, L):
    """Forward (no state), prefill with ``return_state`` (the conv tail left-padded when L < K - 1; L
    padded to whole chunks), then a prefill from that state (the SSD from ``state.S``, the conv from
    zeros) and a decode step."""
    ref_cfg, cfg, ref_params, params = mixer
    ref_apply = jax.jit(ref_mamba2.apply_mamba2, static_argnames=("cfg", "return_state"))
    x = np.random.default_rng(L).normal(size=(B, L, cfg.d_model)).astype(np.float32)
    want, none = ref_apply(ref_params, jnp.asarray(x), cfg=ref_cfg)
    got, state = mamba2.apply_mamba2(params, torch.from_numpy(x), cfg)
    assert none is None and state is None
    _within(got, want, 1e-4)
    want, ref_state = ref_apply(ref_params, jnp.asarray(x), cfg=ref_cfg, return_state=True)
    got, state = mamba2.apply_mamba2(params, torch.from_numpy(x), cfg, return_state=True)
    _within(got, want, 1e-4)
    _state_close(state, ref_state)
    assert state.conv.shape == (B, cfg.ssm_conv - 1, mamba2.conv_dim(cfg))
    x2 = np.random.default_rng(L + 1).normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    for piece in (x2, x2[:, :1]):  # a prefill from the state, and a decode step
        want, ref_next = ref_apply(ref_params, jnp.asarray(piece), cfg=ref_cfg, state=ref_state, return_state=True)
        got, nxt = mamba2.apply_mamba2(params, torch.from_numpy(piece), cfg, state=state, return_state=True)
        _within(got, want, 1e-4)
        _state_close(nxt, ref_next)


def test_decode_steps_continue_the_prefill_state(mixer):
    """Prefill then one-token decode steps equal one forward over the whole sequence, state and all."""
    ref_cfg, cfg, ref_params, params = mixer
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(B, 12, cfg.d_model)).astype(np.float32))
    full, full_state = mamba2.apply_mamba2(params, x, cfg, return_state=True)
    out, state = mamba2.apply_mamba2(params, x[:, :7], cfg, return_state=True)
    outs = [out]
    for t in range(7, 12):
        out, state = mamba2.apply_mamba2(params, x[:, t : t + 1], cfg, state=state)
        outs.append(out)
    _within(torch.cat(outs, dim=1), full.numpy(), 1e-5)
    _within(state.S, full_state.S.numpy(), 1e-5)
    _within(state.conv, full_state.conv.numpy(), 1e-5)
    assert int(state.next_pos) == 12


def test_the_masked_decay_keeps_gradients_finite():
    """One 128-token chunk whose decay passes e^88: the reference's gradient (mask after ``exp``) is
    NaN; the port masks before ``exp``, so its forward equals the reference's and its gradient is
    finite and equals the token-by-token oracle's."""
    d = _ssd_inputs(128, H=2, P=4, G=1, N=4, seed=6)
    dt = np.full_like(d["dt"], 0.8)
    args = (d["x"], dt, np.full_like(d["A"], -1.0), d["Bm"], d["Cm"])
    ref_y = jax.jit(lambda x, dt, A, Bm, Cm: ref_mamba2.ssd_chunked(x, dt, A, Bm, Cm, 128)[0])
    ref_grad = jax.jit(jax.grad(lambda dt: ref_y(args[0], dt, *args[2:]).sum()))
    assert not bool(jnp.isfinite(ref_grad(jnp.asarray(dt))).all())
    grads = []
    for fn in (lambda *a: mamba2.ssd_chunked(*a, 128), mamba2.ssd_reference):
        t = torch.from_numpy(dt).requires_grad_(True)
        y, _ = fn(torch.from_numpy(args[0]), t, *(torch.from_numpy(a) for a in args[2:]))
        y.sum().backward()
        grads.append(t.grad)
    assert bool(torch.isfinite(grads[0]).all())
    _within(grads[0], grads[1].numpy(), 1e-4)
    _within(mamba2.ssd_chunked(*(torch.from_numpy(a) for a in args), 128)[0], ref_y(*args), 1e-5)


# ---------------------------------------------------------------------------
# Reduced mamba2-130m and zamba2-2.7b
# ---------------------------------------------------------------------------


def _numpy_params(descs, seed: int) -> dict:
    """Seeded numpy params for a descriptor tree, each leaf by its init law (normal at its scale, zeros,
    ones): one tree for both packages (the reference's own init takes ~10 s per reduced config here)."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            return (np.zeros if d.init == "zeros" else np.ones)(d.shape, np.float32)
        return (d.scale * rng.normal(size=d.shape)).astype(np.float32)

    return map_descs(leaf, descs)


@pytest.fixture(scope="module")
def built():
    """Per arch: (reference model, port model, reference params, port params, tokens [B, T]), f32."""
    out = {}

    def get(arch: str):
        if arch not in out:
            ref_model = ref_build_model(ref_get_config(arch).reduced().replace(activation_dtype="float32"))
            model = build_model(get_config(arch).reduced().replace(activation_dtype="float32"))
            tree = _numpy_params(model.descs(), 0)
            tokens = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (B, T)).astype(np.int32)
            out[arch] = (ref_model, model, jax.tree.map(jnp.asarray, tree), lm_params_from_tree(tree), tokens)
        return out[arch]

    return get


def _cache_leaves(cache) -> dict:
    """{dotted field path: leaf} of a cache dataclass tree (either package's)."""
    out = {}

    def walk(node, path):
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}")
        elif not isinstance(node, bool):
            out[path] = node

    walk(cache, "")
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_the_reference(arch, built):
    ref_model, model, ref_params, params, tokens = built(arch)
    want, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    with torch.no_grad():
        got, metrics = model.forward(params, torch.from_numpy(tokens))
    assert got.shape == (B, T, model.cfg.padded_vocab) and got.dtype == torch.float32
    _within(got, want, 1e-4)
    assert set(metrics) == {"aux_loss", "router_z", "drop_fraction"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_reference(arch, built):
    """A 21-token prefill (a partial chunk) and 19 decode steps: every step's logits and, at the end,
    every cache leaf (SSM states, conv windows, the hybrid's KV caches, the counters)."""
    ref_model, model, ref_params, params, tokens = built(arch)
    Lp = 21
    ref_cache = ref_model.init_cache(B, T)
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(tokens[:, :Lp]), ref_cache)
    cache = model.init_cache(B, T, "cpu")
    assert isinstance(cache, HybridCache if arch == "zamba2-2.7b" else SSMState)
    decode = jax.jit(ref_model.decode)
    with torch.no_grad():
        got, cache = model.prefill(params, torch.from_numpy(tokens[:, :Lp]), cache)
        _within(got, want, 1e-4)
        for t in range(Lp, T):
            want, ref_cache = decode(ref_params, jnp.asarray(tokens[:, t : t + 1]), ref_cache,
                                     jnp.asarray([t], jnp.int32))
            got, cache = model.decode(params, torch.from_numpy(tokens[:, t : t + 1]), cache,
                                      torch.tensor([t], dtype=torch.int32))
            _within(got, want, 1e-4)
    want_leaves, got_leaves = _cache_leaves(ref_cache), _cache_leaves(cache)
    assert set(got_leaves) == set(want_leaves)
    for name, leaf in got_leaves.items():
        assert tuple(leaf.shape) == want_leaves[name].shape, name
        if name.endswith("next_pos"):
            assert (leaf.numpy() == np.asarray(want_leaves[name])).all() and int(leaf.max()) == T
        else:
            _within(leaf, want_leaves[name], 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_decode_matches_forward(arch, built):
    """The port's own teacher-forced decode reproduces its stateless forward (``tests/test_archs.py``'s band)."""
    _, model, _, params, tokens = built(arch)
    tokens = torch.from_numpy(tokens[:1])
    Lp = 13
    with torch.no_grad():
        full, _ = model.forward(params, tokens)
        logits, cache = model.prefill(params, tokens[:, :Lp], model.init_cache(1, T, "cpu"))
        outs = [logits[:, -1]]
        for t in range(Lp, T):
            logits, cache = model.decode(params, tokens[:, t : t + 1], cache, torch.tensor([t], dtype=torch.int32))
            outs.append(logits[:, -1])
    stepwise = torch.stack(outs, dim=1)
    np.testing.assert_allclose(stepwise[:, :-1].numpy(), full[:, Lp - 1 : -1].numpy(), atol=2e-3, rtol=2e-3)


def _batch(model, tokens):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, model.cfg.vocab_size, tokens.shape).astype(np.int32)
    mask = np.ones(tokens.shape, np.float32)
    mask[:, -1] = 0.0
    return {"inputs": tokens, "labels": labels, "mask": mask}


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_gradients_match_the_reference(arch, built, monkeypatch):
    """f32: the loss within 1e-6 and every gradient leaf within 1e-4 of its largest entry.

    The reference differentiates its token-by-token oracle (``ssd_reference``) in place of its chunked
    scan: at these params the chunked scan's gradient is NaN for both reduced configs (its decay mask
    comes after the ``exp``; ``test_the_masked_decay_keeps_gradients_finite``). The forward values are
    the same.
    """
    ref_model, model, ref_params, params, tokens = built(arch)
    batch = _batch(model, tokens)
    monkeypatch.setattr(ref_mamba2, "ssd_chunked", lambda x, dt, A, Bm, Cm, chunk, initial_state=None:
                        ref_mamba2.ssd_reference(x, dt, A, Bm, Cm, initial_state))

    def ref_loss(p, b):
        hidden, _ = ref_model.hidden(p, b["inputs"])
        loss, _ = ref_chunked_lm_loss(lambda h: ref_model.logits(p, h), hidden, b["labels"], b["mask"])
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(ref_loss))(ref_params, jax.tree.map(jnp.asarray, batch))
    grads, metrics = loss_and_grads(model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-6)
    got_leaves, want_leaves = tree_leaves(grads), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        _within(g, w, 1e-4)


@pytest.mark.parametrize("arch, remat", [("zamba2-2.7b", "full"), ("zamba2-2.7b", "block"),
                                         ("mamba2-130m", "full")])
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    """Recompute changes no value: the hybrid's nested remat (each segment a checkpoint whose mamba2
    layers are checkpointed again) and the SSM stack's give remat="none"'s loss and gradients."""
    base = get_config(arch).reduced().replace(activation_dtype="float32")
    model = build_model(base.replace(remat="none"))
    params = model.init(prng.key(6), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, base.vocab_size, (2, 24)).astype(np.int32))
    batch = {"inputs": tokens, "labels": tokens.roll(-1, 1), "mask": torch.ones((2, 24))}
    want, m_want = loss_and_grads(model, params, batch)
    got, m_got = loss_and_grads(build_model(base.replace(remat=remat)), params, batch)
    assert float(m_got["loss"]) == pytest.approx(float(m_want["loss"]), rel=1e-6)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)


def test_greedy_generation_gives_the_reference_tokens(built):
    ref_model, model, ref_params, params, tokens = built("zamba2-2.7b")
    prompt = tokens[:, :6]
    want = np.asarray(ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt), steps=5, max_len=12))
    got = greedy_generate(model, params, torch.from_numpy(prompt), steps=5, max_len=12)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_config_counts_match_the_reference(arch):
    """Parameter counts from descriptors on both sides (the port's abstract params are ``meta``), and the
    decode cache's bytes from ``meta`` tensors at 4,128 slots (the card's 4,096-token prompt + 32)."""
    ref_model, model = ref_build_model(ref_get_config(arch)), build_model(get_config(arch))
    assert model.num_params() == ref_model.num_params() == FULL_PARAMS[arch]
    assert model.active_params() == ref_model.active_params()
    assert model.matmul_params() == ref_model.matmul_params()
    abstract = tree_leaves(model.abstract())
    assert all(t.device.type == "meta" for t in abstract) and sum(t.numel() for t in abstract) == FULL_PARAMS[arch]
    cache = model.init_cache(1, 4128, "meta")
    ref_bytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(ref_model.abstract_cache(1, 4128)))
    assert tree_size_bytes(cache) == ref_bytes
    cfg = model.cfg
    state = cfg.num_layers * (cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
                              + (cfg.ssm_conv - 1) * mamba2.conv_dim(cfg) * 2 + 4)
    kv = 0 if arch == "mamba2-130m" else 9 * (4128 * cfg.num_kv_heads * cfg.head_dim * 2 * 2 + 4)
    assert tree_size_bytes(cache) == state + kv  # zamba2: 452.9 MB, mamba2: 19.1 MB


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_cli_trains_the_reduced_config_on_the_cpu(arch):
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--steps", "12", "--batch", "2", "--seq", "32",
            "--log-every", "100"]
    assert train_cli.main(argv) == 0  # LEARNING: the last 5 steps' mean loss below the first 5's
