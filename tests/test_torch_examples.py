"""The port's examples (``examples_torch/``) on the CPU at small sizes, and what the new files import.

Each example keeps the reference's self-checks (served answers equal the
engine's, the backends' RMSE parity, the RMSE bound) and prints ``ok``;
here each runs with ``--device cpu`` and flags that shrink it. Without
``--device cpu`` and without a card each raises before it computes
anything on the CPU. The drivers, examples and scripts of the port import
neither ``jax`` nor ``repro``.
"""
import ast
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EXAMPLES = {
    "quickstart": ["--sweeps", "10"],
    "distributed_bpmf": ["--users", "300", "--movies", "120", "--nnz", "4000", "--sweeps", "4",
                         "--num-shards", "4"],
    "bpmf_chembl": ["--scale", "0.002", "--sweeps", "4", "--k", "8", "--checkpoint-every", "2"],
}


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_and_checks_itself(name, tmp_path, capsys):
    argv = ["--device", "cpu", *EXAMPLES[name]]
    if name == "bpmf_chembl":
        argv += ["--checkpoint-dir", str(tmp_path / "ckpt")]
    _example(name).main(argv)
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("ok"), out[-2000:]
    if name == "bpmf_chembl":
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir() if p.name.startswith("step_")) == [
            "step_00000002", "step_00000004"]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(EXAMPLES[name])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_drivers_examples_and_scripts_import_neither_jax_nor_repro():
    files = (sorted((ROOT / "benchmarks_torch").glob("*.py")) + sorted((ROOT / "examples_torch").glob("*.py"))
             + [ROOT / "scripts" / "check_bench_schema_torch.py", ROOT / "scripts" / "check_docstrings_torch.py"])
    assert {"run.py", "fig4_scaling.py", "quickstart.py"} <= {f.name for f in files}
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
