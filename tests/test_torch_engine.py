"""The port's slice as a whole: engine, predictor, CLI, conversion, import rules.

On test_posterior_quality's task (150 x 80, nnz 4000, noise 0.3, seed 7;
K=8, 10 sweeps, burn-in 3, pads (8, 32, 128)):

* with the gamma seam filled by JAX's draw, the port's per-sweep RMSEs match
  ``repro``'s BPMFEngine to 1e-4 and the final U, V to 1e-3 (observed on
  CPU: 1.2e-7 on the RMSEs, 2.7e-6 on U and V; both end at 0.7603);
* with the port's own gamma, the RMSE lands in the recorded band;
* ``predict`` / ``return_std`` / ``top_k`` match ``repro``'s
  PosteriorPredictor on the same posterior (1e-6, equal ids).
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bpmf as jbpmf
from repro.core import gibbs as jgibbs
from repro.core import types as jtypes
from repro.core.prediction import PredictionState as JPredictionState
from repro.data.sparse import RatingsCOO as JRatingsCOO
from repro.data.sparse import build_bpmf_data as j_build
from repro.serve import ArtifactMeta as JArtifactMeta
from repro.serve import PosteriorPredictor as JPredictor
from repro_torch import convert
from repro_torch.bpmf import BPMFConfig, BPMFEngine, available_backends, load_dataset
from repro_torch.core import prng
from repro_torch.launch import bpmf as cli

RMSE_BAND = (0.70, 0.82)  # tests/test_posterior_quality.py's recorded band
ROOT = Path(__file__).resolve().parents[1]
CFG = dict(K=8, num_sweeps=10, burn_in=3, bucket_pads=(8, 32, 128), keep_factor_samples=4)
TASK = dict(num_users=150, num_movies=80, nnz=4000, noise_std=0.3, seed=7)


def _jax_gamma(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """JAX's gamma draw for the port's key words: the parity tests' seam."""
    k = jax.random.wrap_key_data(jnp.asarray(convert.key_to_data(key)))
    return torch.from_numpy(np.array(jax.random.gamma(k, jnp.asarray(a.numpy()))))


@pytest.fixture(scope="module")
def reference():
    return jbpmf.BPMFEngine(jbpmf.BPMFConfig().replace(**CFG)).fit(jbpmf.load_dataset("synthetic", **TASK))


@pytest.fixture(scope="module")
def port_with_seam():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prng, "gamma", _jax_gamma)
        return BPMFEngine(BPMFConfig().replace(**CFG), device="cpu").fit(load_dataset("synthetic", **TASK))


@pytest.fixture(scope="module")
def port():
    return BPMFEngine(BPMFConfig().replace(**CFG), device="cpu").fit(load_dataset("synthetic", **TASK))


def test_engine_matches_reference_with_gamma_seam(reference, port_with_seam):
    want = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in reference.history])
    got = np.array([[m.rmse_sample, m.rmse_avg, m.sweep] for m in port_with_seam.history])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for a, b in zip(port_with_seam.factors(), reference.factors()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_engine_rmse_in_band_with_own_gamma(port):
    lo, hi = RMSE_BAND
    assert lo < port.rmse < hi, f"observed RMSE {port.rmse:.4f} left the band {RMSE_BAND}"
    assert port.num_sweeps_done == 10 and len(port.history) == 10
    assert port.history[-1].rmse_avg < port.history[0].rmse_avg


def test_predictor_matches_reference_predictor(port):
    meta, arrays = port._artifact_payload()
    assert meta.num_mean_samples == 7 and meta.num_kept_samples == 4
    theirs = JPredictor(JArtifactMeta(**dataclasses.asdict(meta)), arrays)
    ours = port.predictor()
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 150, 64), rng.integers(0, 80, 64)
    p, s = ours.predict(rows, cols, return_std=True)
    pj, sj = theirs.predict(rows, cols, return_std=True)
    np.testing.assert_allclose(p, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.predict(rows, cols), pj, rtol=0, atol=1e-6)
    users = np.arange(0, 150, 7)
    ids, vals = ours.top_k(users, 10)
    ids_j, vals_j = theirs.top_k(users, 10, sharded=False)
    np.testing.assert_array_equal(ids, np.asarray(ids_j))
    np.testing.assert_allclose(vals, np.asarray(vals_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.top_k(3, 5)[0], np.asarray(theirs.top_k(3, 5, sharded=False)[0]))


def test_top_k_orders_ties_by_item_id():
    """Clipped scores tie; the lower item id comes first, as merge_topk orders them."""
    from repro_torch.serve.artifact import ArtifactMeta
    from repro_torch.serve.predictor import PosteriorPredictor

    V = np.array([[1.0], [5.0], [5.0], [0.0], [5.0]], np.float32)
    U = np.ones((1, 1), np.float32)
    meta = ArtifactMeta(1, 5, 1, 0.0, 0.0, 3.0, 1, 0, "sequential", 1, 0)
    empty = np.zeros((0, 1, 1), np.float32)
    pred = PosteriorPredictor(meta, {"U_mean": U, "V_mean": V, "U_samples": empty, "V_samples": empty}, "cpu")
    ids, vals = pred.top_k(0, 4)
    np.testing.assert_array_equal(ids, [1, 2, 4, 0])
    np.testing.assert_array_equal(vals, [3.0, 3.0, 3.0, 1.0])


def test_convert_round_trips():
    jc = jbpmf.load_dataset("synthetic", num_users=40, num_movies=20, nnz=300, seed=1)
    jdata = j_build(JRatingsCOO(jc.rows, jc.cols, jc.vals, 40, 20), pads=(8, 32))
    cfg = jtypes.BPMFConfig(K=4, bucket_pads=(8, 32), gram_impl="xla")
    key = jax.random.key(2)
    jstate = jgibbs.init_state(key, 40, 20, cfg)
    jaccum = jtypes.PosteriorAccum.init(40, 20, 4, keep=3)
    jpred = JPredictionState.init(jdata.test.rows.shape[0])
    for tree_of, from_tree in [
        (jstate, convert.state_from_tree),
        (jaccum, convert.accum_from_tree),
        (jpred, convert.prediction_from_tree),
        (jdata, convert.data_from_tree),
    ]:
        tree = dataclasses.asdict(tree_of)
        back = convert.to_tree(from_tree(tree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, tree)
        )
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    # a port state goes back into a reference state that the JAX sweep accepts
    t = convert.to_tree(convert.state_from_tree(dataclasses.asdict(jstate)))
    back = jtypes.BPMFState(
        U=jnp.asarray(t["U"]), V=jnp.asarray(t["V"]),
        hyper_U=jtypes.HyperParams(**t["hyper_U"]), hyper_V=jtypes.HyperParams(**t["hyper_V"]),
        sweep=jnp.asarray(t["sweep"]),
    )
    jgibbs.gibbs_sweep(key, back, jpred, jdata, cfg)
    k = convert.key_from_data(jax.random.key_data(key))
    np.testing.assert_array_equal(convert.key_to_data(k), np.asarray(jax.random.key_data(key)))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPMFEngine(BPMFConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPMFEngine(BPMFConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--sweeps", "1", "--users", "20", "--movies", "10", "--nnz", "100"])
    assert BPMFEngine(BPMFConfig(), device="cpu").device.type == "cpu"


def test_unported_features_raise_naming_the_roadmap_item():
    # ported: every backend of the JAX package's registry constructs
    for name in ("ring", "ring_async", "allgather", "posterior_merge"):
        assert BPMFEngine(BPMFConfig().replace(name=name), device="cpu").backend.name == name
    assert available_backends() == ["allgather", "posterior_merge", "ring", "ring_async", "sequential"]
    # pipeline_blocks > 1 runs (tests/test_torch_pipeline.py holds it to depth 1)
    piped = BPMFEngine(BPMFConfig().replace(pipeline_blocks=2, K=4, num_sweeps=3, sweeps_per_block=1),
                       device="cpu").fit(load_dataset("synthetic", num_users=40, num_movies=20, nnz=300))
    assert piped.num_sweeps_done == 3 and [m.sweep for m in piped.history] == [1.0, 2.0, 3.0]
    # checkpoints and export are ported (Queue 1 items 5 and 6): an engine
    # with a checkpoint directory constructs, and without data its calls
    # raise for the missing data, not for a missing port
    engine = BPMFEngine(BPMFConfig().replace(checkpoint_dir="ckpt", checkpoint_every=2), device="cpu")
    for call in (engine.save, engine.restore, lambda: engine.export("art")):
        with pytest.raises(RuntimeError, match="no data"):
            call()
    from repro_torch.serve import ArtifactMeta, PosteriorPredictor

    one = np.ones((1, 1), np.float32)
    arrays = {"U_mean": one, "V_mean": one, "U_samples": one[None], "V_samples": one[None]}
    meta = ArtifactMeta(1, 1, 1, 0.0, 0.0, 3.0, 1, 1, "sequential", 1, 0)
    # the item-sharded top-k is ported (Queue 1 item 9): it answers as the replicated scan
    sharded = PosteriorPredictor(meta, arrays, "cpu", topk_mode="sharded")
    replicated = PosteriorPredictor(meta, arrays, "cpu", topk_mode="replicated")
    for got, want in zip(sharded.top_k(0, 1), replicated.top_k(0, 1)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(replicated.top_k(0, 1, sharded=True), replicated.top_k(0, 1)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        BPMFEngine(BPMFConfig().replace(name="nope"), device="cpu")


def test_cli_runs_on_cpu(capsys):
    args = ["--device", "cpu", "--sweeps", "3", "--burn-in", "1", "--K", "4",
            "--users", "60", "--movies", "30", "--nnz", "600", "--sweeps-per-block", "2"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("sweep ") == 3 and "final rmse(avg)=" in out
    # the queue and the donation flags give the same run
    assert cli.main(args + ["--sweeps-per-block", "1", "--pipeline-blocks", "2", "--donate-blocks", "off"]) == 0
    assert capsys.readouterr().out.splitlines()[1:4] == out.splitlines()[1:4]
    parsed = cli.build_parser().parse_args(["--pipeline-blocks", "4", "--donate-blocks", "on"])
    assert (parsed.pipeline_blocks, parsed.donate_blocks) == (4, "on")


def test_cli_runs_posterior_merge_on_cpu(capsys):
    assert cli.main([
        "--device", "cpu", "--backend", "posterior_merge", "--num-partitions", "2",
        "--merge-method", "pool", "--sweeps", "3", "--burn-in", "1", "--K", "4",
        "--users", "60", "--movies", "30", "--nnz", "600",
    ]) == 0
    out = capsys.readouterr().out
    assert "backend=posterior_merge partitions=2 device=cpu" in out
    assert out.count("sweep ") == 3 and "final rmse(avg)=" in out


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert {"src/repro_torch/core/subset_merge.py", "src/repro_torch/data/movielens.py"} <= {
        f.relative_to(ROOT).as_posix() for f in files}
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
