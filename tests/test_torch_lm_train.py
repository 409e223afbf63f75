"""The LM training CLI, its checkpoints, the example and the serving steps, on the CPU.

``python -m repro_torch.launch.train --device cpu --arch gemma-2b --reduced``
learns (one subprocess); a run interrupted after a checkpoint and resumed
ends with the uninterrupted run's state bit for bit; the reference's
``CheckpointManager`` restores a port checkpoint's ``TrainState`` and the
port restores the reference's; ``examples_torch/lm_train.py --device cpu``
runs; greedy generation gives the reference's tokens; the CLI refuses
``--model-parallel > 1`` and (without a card) the default device.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.training.lm_serve import greedy_generate as ref_greedy_generate
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.train import abstract_batch as ref_abstract_batch
from repro.training.train import init_train_state as ref_init_train_state
from repro_torch import serve
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_tree
from repro_torch.core import prng
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.training import serve as training_serve
from repro_torch.training.lm_serve import greedy_generate, make_decode_step, make_prefill_step
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import (
    abstract_batch,
    init_train_state,
    make_train_step,
    state_from_leaves,
    state_leaves,
)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--arch", "yi-6b", "--reduced", "--batch", "2", "--seq", "16", "--log-every", "100"]


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_cli_learns_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "gemma-2b", "--reduced"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "(LEARNING)" in proc.stderr and "arch=gemma-2b-smoke" in proc.stderr


def _leaves_at(directory: Path, step: int, names) -> dict:
    return CheckpointManager(str(directory)).restore(names, step=step)


def test_an_interrupted_run_resumes_bit_for_bit(tmp_path):
    argv = SMALL + ["--steps", "6", "--checkpoint-every", "3"]  # too short to judge learning: the exit code is not
    train_cli.main(argv + ["--checkpoint-dir", str(tmp_path / "whole")])
    # the same run, stopped after its step-3 checkpoint: drop what came later, then run again
    cut = tmp_path / "cut"
    train_cli.main(argv + ["--checkpoint-dir", str(cut)])
    for d in cut.iterdir():
        if d.name == "step_00000006":
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
    (cut / "LATEST").write_text("3")
    train_cli.main(argv + ["--checkpoint-dir", str(cut)])
    model = build_model(get_config("yi-6b").reduced())
    names = list(state_leaves(init_train_state(prng.key(0), model, AdamW(), "cpu")))
    whole, resumed = _leaves_at(tmp_path / "whole", 6, names), _leaves_at(cut, 6, names)
    assert int(whole[".step"]) == 6 and int(whole[".opt__.count"]) == 6
    for name in names:
        assert whole[name].dtype == resumed[name].dtype and whole[name].tobytes() == resumed[name].tobytes(), name


def _ref_state_target(arch: str):
    model = ref_build_model(ref_get_config(arch).reduced())
    return model, jax.eval_shape(lambda k: ref_init_train_state(k, model, RefAdamW()), jax.random.key(0))


def test_the_reference_restores_a_port_checkpoint(tmp_path):
    train_cli.main(SMALL + ["--steps", "6", "--checkpoint-dir", str(tmp_path)])
    _, target = _ref_state_target("yi-6b")
    restored = RefCheckpointManager(str(tmp_path)).restore(target)
    model = build_model(get_config("yi-6b").reduced())
    names = list(state_leaves(init_train_state(prng.key(0), model, AdamW(), "cpu")))
    mine = _leaves_at(tmp_path, 6, names)
    got = jax.tree.leaves(restored)
    assert len(got) == len(names)
    for name, leaf in zip(names, got):  # both in the reference's leaf order
        assert np.asarray(leaf).dtype == mine[name].dtype and np.asarray(leaf).tobytes() == mine[name].tobytes()
    assert int(restored.step) == 6


def test_the_port_restores_a_reference_checkpoint_and_trains_on(tmp_path):
    ref_model, _ = _ref_state_target("gemma-2b")
    state = ref_init_train_state(jax.random.key(1), ref_model, RefAdamW())
    rng = np.random.default_rng(6)  # moments and counters as a trained state has them
    moment = lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype)
    state = dataclasses.replace(state, step=jnp.asarray(1, jnp.int32), opt=dataclasses.replace(
        state.opt, mu=jax.tree.map(moment, state.params), nu=jax.tree.map(lambda p: moment(p) ** 2, state.params),
        count=jnp.asarray(1, jnp.int32)))
    batch = train_cli.synthetic_lm_batch(train_cli.step_generator(0, 0), get_config("gemma-2b").reduced(), 2, 16)
    manager = RefCheckpointManager(str(tmp_path), async_writes=False)
    manager.save(1, state)
    model = build_model(get_config("gemma-2b").reduced())
    opt = AdamW(learning_rate=1e-3)
    like = init_train_state(prng.key(0), model, opt, "cpu")
    mine = state_from_leaves(CheckpointManager(str(tmp_path)).restore(state_leaves(like)), like)
    want = jax.tree.leaves(jax.tree.map(np.asarray, state))
    got = list(state_leaves(mine).values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.tobytes()
    mine, metrics = make_train_step(model, opt)(mine, batch)
    assert int(mine.step) == 2 and np.isfinite(float(metrics["loss"]))


def test_the_example_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location("examples_torch_lm_train", ROOT / "examples_torch" / "lm_train.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--device", "cpu", "--steps", "10", "--log-every", "5"]) == 0


@pytest.mark.parametrize("argv, error, match", [
    (SMALL + ["--model-parallel", "2"], NotImplementedError, "item 9"),
    (["--arch", "yi-6b", "--reduced"], RuntimeError, "no CUDA device"),
])
def test_the_cli_refuses_what_it_cannot_run(argv, error, match):
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(error, match=match):
        train_cli.main(argv)


def test_greedy_generation_gives_the_reference_tokens():
    arch = "yi-6b"
    ref_model = ref_build_model(ref_get_config(arch).reduced().replace(activation_dtype="float32"))
    ref_params = ref_model.init(jax.random.key(2))
    model = build_model(get_config(arch).reduced().replace(activation_dtype="float32"))
    params = lm_params_from_tree(jax.tree.map(np.asarray, ref_params))
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt), steps=5, max_len=12))
    got = greedy_generate(model, params, torch.from_numpy(prompt), steps=5, max_len=12)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    # sampling with an explicit generator: the same draws for the same seed
    cache = model.init_cache(2, 12, "cpu")
    logits, cache = make_prefill_step(model)(params, torch.from_numpy(prompt), cache)
    step = make_decode_step(model, temperature=0.7)
    tok = got[:, :1]
    draws = [step(params, tok, cache, torch.tensor(6, dtype=torch.int32), torch.Generator().manual_seed(s))[0]
             for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 1)


def test_batches_and_reexports_match_the_reference():
    cfg = get_config("hubert-xlarge").reduced()
    for c in (cfg, get_config("gemma-2b").reduced()):
        mine, want = abstract_batch(c, 4, 32), ref_abstract_batch(ref_get_config(c.name[:-6]).reduced(), 4, 32)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in mine.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        b1 = train_cli.synthetic_lm_batch(train_cli.step_generator(0, 3), c, 4, 32)
        b2 = train_cli.synthetic_lm_batch(train_cli.step_generator(0, 3), c, 4, 32)
        assert all(torch.equal(b1[k], b2[k]) for k in b1)
        assert {k: v.dtype for k, v in b1.items()} == {k: getattr(torch, str(v.dtype).split(".")[1])
                                                       for k, v in mine.items()}
    tokens = train_cli.synthetic_lm_batch(train_cli.step_generator(0, 0), get_config("gemma-2b").reduced(), 2, 8)
    assert torch.equal(tokens["labels"][:, :-1], tokens["inputs"][:, 1:]) and not tokens["mask"][:, -1].any()
    assert training_serve.PosteriorPredictor is serve.PosteriorPredictor
