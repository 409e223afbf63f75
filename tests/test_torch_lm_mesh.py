"""The LM over a mesh of 4 ``gloo`` CPU ranks against the JAX package run unsharded (``multidevice``).

One subprocess gang of 4 ranks on a ``(2, 2)`` mesh runs one reduced config
per family, in float32: gemma-2b (MQA), minicpm3-4b (MLA, with small flash
chunks and ``flash_q_parallel``), mixtral-8x22b (MoE), mamba2-130m (SSM)
and zamba2-2.7b (hybrid). The params are a reference param tree drawn by
its descriptors from a seeded numpy generator, carried across by
``convert.lm_params_from_tree``; every rank cuts its shards and checks their
shapes against the specs. The ranks write what they gather to ``.npz``,
and this process runs the reference unsharded on the same params and batch:

* one train step under ``TRAIN_RULES`` and under ``ZERO_RULES``: the loss,
  the metrics, the grad norm and every updated param and moment match
  ``jax.jit(make_train_step(model, opt, TRAIN_RULES, mesh=None))``;
* a prefill under ``SERVE_RULES`` (the KV cache split along the sequence)
  and 4 decode steps under ``DECODE_RULES``: the logits of each step, the
  greedy tokens and the gathered cache match the reference's prefill and
  decode;
* for gemma-2b, each rank's ``collectives.STATS`` (calls and payload bytes)
  over the ``TRAIN_RULES`` step and the first decode step equal the dry
  run's trace of that rank (``repro_torch.launch.dryrun``, an abstract
  mesh on the ``meta`` device), exactly.

The band is 1e-4 relative to the largest magnitude of each compared array.
Meanwhile ``python -m repro_torch.launch.multiproc --num-processes 2 --
--device cpu --arch gemma-2b --reduced --model-parallel 2`` trains and
checkpoints; the reference reads the checkpoint, and one process resumes
from it and learns.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.models.module import TRAIN_RULES as REF_TRAIN_RULES
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.train import TrainState as RefTrainState
from repro.training.train import init_train_state as ref_init_train_state
from repro.training.train import make_train_step as ref_make_train_step

ROOT = Path(__file__).resolve().parents[1]
GANG_TIMEOUT_S = 240
BAND = 1e-4
CASES = {  # arch -> config overrides (float32 throughout)
    "gemma-2b": {},
    "minicpm3-4b": {"attn_q_chunk": 4, "attn_kv_chunk": 8, "flash_q_parallel": True},
    "mixtral-8x22b": {},
    "mamba2-130m": {},
    "zamba2-2.7b": {},
}
B, L = 4, 16  # train batch: rows over (data, model) under ZERO_RULES
SB, P, T, S = 2, 6, 4, 16  # serve batch, prompt, decode steps, cache length

WORKER = r"""
import dataclasses
import sys
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree, lm_params_to_tree
from repro_torch.launch.hostdevices import init_multiprocess, process_index, shutdown
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import module
from repro_torch.models.model import build_model
from repro_torch.models.module import flatten_descs, gather_full, local_shape, shard_of
from repro_torch.training.lm_serve import gather_logits, make_decode_step, make_prefill_step
from repro_torch.training.optimizer import AdamW, OptState, tree_leaves, tree_leaves_specs, tree_map
from repro_torch.training.train import TrainState, jit_train_step
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import collectives
from repro_torch.models.collectives import Mesh

torch.set_num_threads(1)
init_multiprocess(device="cpu", timeout_s=120)
mesh = make_host_mesh(2)
data = np.load(sys.argv[1])
out = {}
CASES = CASES_LITERAL
B, L, SB, P, T, S = DIMS_LITERAL
DRY_ARCH = "gemma-2b"  # each rank's collectives of one train and one decode step against its dry-run trace


def nested(prefix):
    tree = {}
    for k in data.files:
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
    return tree


def shards(tree, specs):
    return tree_map(lambda t, sp: shard_of(t, sp, mesh).contiguous().clone(), tree, specs)


def check_shapes(local, whole, specs, what):
    for a, b, sp in zip(tree_leaves(local), tree_leaves(whole), tree_leaves_specs(specs)):
        assert tuple(a.shape) == local_shape(tuple(b.shape), sp, mesh), (what, a.shape, b.shape, sp)


def fields(c, prefix=""):
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        if dataclasses.is_dataclass(v):
            yield from fields(v, prefix + f.name + ".")
        elif not isinstance(v, bool):
            yield prefix + f.name, v


def same_as_dry_run(stats, cfg, shape, spec, rules):
    # this rank's collectives of one real step (STATS) against the dry run's trace of its rank
    stats = dict(stats)
    ab = Mesh.abstract(mesh.sizes, mesh.axis_names, rank=process_index())
    step, args, _ = dryrun.cell_step(DRY_ARCH, shape, ab, rules_train=rules, microbatches=1, cfg=cfg, spec=spec)
    _, cost = dryrun.trace(step, *args)
    traced = {"calls": len(cost.collectives), "bytes": sum(c["payload_bytes"] for c in cost.collectives)}
    assert traced == {k: stats[k] for k in traced} and traced["calls"] > 0, (shape, process_index(), traced, stats)


def put(key, t):
    out[key] = lm_params_to_tree(t) if isinstance(t, torch.Tensor) else np.asarray(t)


for arch, kw in CASES.items():
    cfg = get_config(arch).reduced().replace(activation_dtype="float32", param_dtype="float32", **kw)
    model = build_model(cfg)
    whole = {"head": {}, **lm_params_from_tree(nested(arch + "|params|"))}  # a tied head is an empty dict
    batch = {k: torch.from_numpy(data[f"{arch}|batch|{k}"]) for k in ("inputs", "labels", "mask")}
    names = ["/".join(p) for p, _ in flatten_descs(model.descs())]
    opt = AdamW()
    for rules_name in ("TRAIN_RULES", "ZERO_RULES"):
        rules = getattr(module, rules_name)
        specs = model.specs(rules, mesh)
        local = shards(whole, specs)
        check_shapes(local, whole, specs, rules_name)
        moments = [shards(lm_params_from_tree(nested(f"{arch}|{m}|")), specs) for m in ("mu", "nu")]
        one = torch.ones((), dtype=torch.int32)
        state = TrainState(params=local, opt=OptState(mu=moments[0], nu=moments[1], count=one), step=one)
        collectives.reset_stats()
        state, metrics = jit_train_step(model, opt, mesh, rules, batch=B, seq=L)(state, batch)
        if arch == DRY_ARCH and rules_name == "TRAIN_RULES":
            same_as_dry_run(collectives.STATS, cfg, "train_4k", ShapeSpec("t", L, B, "train"), rules)
        check_shapes(state.opt.mu, whole, specs, rules_name + " mu")
        tag = f"{arch}|{rules_name}|"
        for k, v in metrics.items():
            put(tag + "metric|" + k, v.float())
        for part, tree in (("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu)):
            for name, leaf, sp in zip(names, tree_leaves(tree), tree_leaves_specs(specs)):
                put(tag + part + "|" + name, gather_full(leaf, sp, mesh))
    # serving: prefill under SERVE_RULES, decode under DECODE_RULES (the same storage)
    local = shards(whole, model.specs(module.SERVE_RULES, mesh))
    tokens = torch.from_numpy(data[f"{arch}|serve_tokens"])
    sctx = model.ctx(module.SERVE_RULES, mesh).with_batch(SB, S)
    cache = model.init_cache(SB, S, "cpu", ctx=sctx)
    logits, cache = make_prefill_step(model, module.SERVE_RULES, mesh, S)(local, tokens[:, :P], cache)
    put(f"{arch}|serve|logits0", logits)
    decode = make_decode_step(model, rules=module.DECODE_RULES, mesh=mesh, max_len=S)
    dctx = model.ctx(module.DECODE_RULES, mesh).with_batch(SB, S)
    for t in range(T):
        tok, pos = tokens[:, P + t : P + t + 1], torch.tensor([P + t], dtype=torch.int32)
        collectives.reset_stats()
        put(f"{arch}|serve|token{t + 1}", decode(local, tok, cache, pos[0])[0])
        if arch == DRY_ARCH and t == 0:
            same_as_dry_run(collectives.STATS, cfg, "decode_32k", ShapeSpec("d", S, SB, "decode"), None)
        logits, cache = model.decode(local, dctx.rows(tok), cache, pos, ctx=dctx)
        put(f"{arch}|serve|logits{t + 1}", gather_logits(model, local, logits, dctx))
    whole_cache = model.gather_cache(cache, sctx, SB, S)
    for (name, a), (_, b), (_, sp) in zip(fields(cache), fields(whole_cache),
                                          fields(model.cache_specs(module.SERVE_RULES, mesh, SB, S))):
        assert tuple(a.shape) == local_shape(tuple(b.shape), sp, mesh), (arch, name, a.shape, sp)
        put(f"{arch}|cache|{name}", b)
if process_index() == 0:
    np.savez(sys.argv[2], **out)
shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(k, None)
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    return env


def _ref_cfg(arch: str):
    return ref_get_config(arch).reduced().replace(activation_dtype="float32", param_dtype="float32", **CASES[arch])


def _flat(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}/"))
    return out


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= BAND * max(1.0, float(np.max(np.abs(want), initial=0.0))), (what, err)


def _ref_cache_fields(c, prefix: str = ""):
    import dataclasses

    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        if dataclasses.is_dataclass(v):
            yield from _ref_cache_fields(v, prefix + f.name + ".")
        elif not isinstance(v, bool):
            yield prefix + f.name, np.asarray(v)


def _inputs(arch: str, data: dict) -> dict:
    """The reference's params, moments, batch and serving tokens, also into ``data``.

    The moments are a trained state's, the second one at least 1: the step is then a smooth function of
    the gradient (from zero moments it is ``lr * g / (|g| + eps)``, whose sign rounding flips where |g|
    is near eps), and ``mu`` and ``nu`` carry the gradient's error to the comparison as it is."""
    cfg = _ref_cfg(arch)
    model = ref_build_model(cfg)
    rng = np.random.default_rng(len(arch))

    def draw(d):  # each descriptor's law, from a seeded numpy generator
        if d.init in ("zeros", "ones"):
            return jnp.full(d.shape, 0.0 if d.init == "zeros" else 1.0, d.dtype)
        return jnp.asarray(d.scale * rng.normal(size=d.shape), d.dtype)

    params = jax.tree.map(draw, model.descs(), is_leaf=lambda x: hasattr(x, "axes"))
    moment = lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype)
    mu, nu = jax.tree.map(moment, params), jax.tree.map(lambda p: 1 + moment(p) ** 2, params)
    for part, tree in (("params", params), ("mu", mu), ("nu", nu)):
        for name, leaf in _flat(jax.tree.map(np.asarray, tree)).items():
            data[f"{arch}|{part}|{name}"] = leaf
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    else:
        inputs = rng.normal(size=(B, L, cfg.frame_dim)).astype(np.float32)
    batch = {"inputs": inputs, "labels": rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32),
             "mask": (rng.random((B, L)) < 0.8).astype(np.float32)}
    for k, v in batch.items():
        data[f"{arch}|batch|{k}"] = v
    tokens = rng.integers(0, cfg.vocab_size, (SB, P + T)).astype(np.int32)
    data[f"{arch}|serve_tokens"] = tokens
    return {"model": model, "params": params, "mu": mu, "nu": nu, "batch": batch, "tokens": tokens}


def _reference(inp: dict) -> dict:
    """The reference's train step and serving on ``inp``, unsharded."""
    model, params, tokens = inp["model"], inp["params"], inp["tokens"]
    opt = RefAdamW()
    one = jnp.asarray(1, jnp.int32)
    state = RefTrainState(params=params, opt=dataclasses.replace(opt.init(params), mu=inp["mu"], nu=inp["nu"],
                                                                 count=one), step=one)
    state, metrics = jax.jit(ref_make_train_step(model, opt, REF_TRAIN_RULES, mesh=None))(
        state, {k: jnp.asarray(v) for k, v in inp["batch"].items()})
    out = {"metric": {k: np.asarray(v) for k, v in metrics.items()},
           "params": _flat(jax.tree.map(np.asarray, state.params)),
           "mu": _flat(jax.tree.map(np.asarray, state.opt.mu)), "nu": _flat(jax.tree.map(np.asarray, state.opt.nu))}
    cache = model.init_cache(SB, S)
    logits, cache = jax.jit(model.prefill)(params, jnp.asarray(tokens[:, :P]), cache)
    out["logits"] = [np.asarray(logits)]
    decode = jax.jit(model.decode)
    for t in range(T):
        logits, cache = decode(params, jnp.asarray(tokens[:, P + t : P + t + 1]), cache,
                               jnp.asarray([P + t], jnp.int32))
        out["logits"].append(np.asarray(logits))
    out["cache"] = dict(_ref_cache_fields(cache))
    return out


def _cli(tmp_path: Path) -> tuple[subprocess.Popen, list[str]]:
    common = ["--device", "cpu", "--arch", "gemma-2b", "--reduced", "--batch", "4", "--seq", "16",
              "--steps", "24", "--log-every", "100", "--checkpoint-dir", str(tmp_path / "ck")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.multiproc", "--num-processes", "2", "--timeout",
         str(GANG_TIMEOUT_S), "--", *common, "--model-parallel", "2", "--checkpoint-every", "12"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, common


@pytest.mark.multidevice
def test_the_lm_over_a_mesh_of_four_ranks_matches_the_unsharded_reference(tmp_path):
    data: dict = {}
    inputs = {arch: _inputs(arch, data) for arch in CASES}
    np.savez(tmp_path / "in.npz", **data)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("CASES_LITERAL", repr(CASES)).replace("DIMS_LITERAL", repr((B, L, SB, P, T, S))))
    port = _free_port()
    cli, common = _cli(tmp_path)  # the 2-rank CLI runs beside the gang
    gang = [subprocess.Popen([sys.executable, str(script), str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                             env=_env(REPRO_COORDINATOR=f"127.0.0.1:{port}", REPRO_NUM_PROCESSES="4",
                                      REPRO_PROCESS_ID=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        refs = {arch: _reference(inp) for arch, inp in inputs.items()}  # while the ranks run
        outs = [p.communicate(timeout=GANG_TIMEOUT_S)[0] for p in gang]
        cli_out = cli.communicate(timeout=GANG_TIMEOUT_S)[0]
    finally:
        for p in (*gang, cli):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not any(p.returncode for p in gang), "\n".join(o[-3000:] for o in outs)
    got = np.load(tmp_path / "out.npz")

    for arch, ref in refs.items():
        for rules in ("TRAIN_RULES", "ZERO_RULES"):
            tag = f"{arch}|{rules}|"
            for k in ("loss", "ce", "z_loss", "accuracy", "tokens", "grad_norm", "lr"):
                _close(got[tag + "metric|" + k], ref["metric"][k], tag + k)
            if "aux_loss" in ref["metric"]:
                for k in ("aux_loss", "router_z", "drop_fraction"):
                    _close(got[tag + "metric|" + k], ref["metric"][k], tag + k)
            for part in ("params", "mu", "nu"):
                for name, want in ref[part].items():
                    _close(got[f"{tag}{part}|{name}"], want, f"{tag}{part}|{name}")
        for t, want in enumerate(ref["logits"]):
            _close(got[f"{arch}|serve|logits{t}"], want, f"{arch} logits {t}")
            if t:
                np.testing.assert_array_equal(got[f"{arch}|serve|token{t}"][:, 0], want[:, -1].argmax(-1))
        for name, want in ref["cache"].items():
            _close(got[f"{arch}|cache|{name}"], want, f"{arch} cache {name}")

    # the CLI: the 2-rank run learns, the reference restores its checkpoint, one process resumes it
    assert cli.returncode == 0 and "(LEARNING)" in cli_out and "mesh={'data': 1, 'model': 2}" in cli_out, \
        cli_out[-3000:]
    ref_model = ref_build_model(ref_get_config("gemma-2b").reduced())
    target = jax.eval_shape(lambda k: ref_init_train_state(k, ref_model, RefAdamW()), jax.random.key(0))
    restored = RefCheckpointManager(str(tmp_path / "ck")).restore(target, step=24)
    assert int(restored.step) == 24
    ck = tmp_path / "ck"
    for d in ck.iterdir():  # resume the gang's step 12 in one process
        if d.name == "step_00000024":
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
    (ck / "LATEST").write_text("12")
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common], env=_env(),
                         capture_output=True, text=True, timeout=GANG_TIMEOUT_S)
    assert one.returncode == 0 and "restored step 12" in one.stderr and "(LEARNING)" in one.stderr, \
        one.stderr[-3000:]
