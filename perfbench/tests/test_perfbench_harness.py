"""The benchmark harness on the CPU: cells resolve by name, new files are found, runs report and refuse."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import bench
from perfbench.tests import tiny

ROOT = bench.ROOT
SPEC = bench.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell = bench.load_cell(name)
    assert cell.config["data"]["num_users"] > 0
    assert (ROOT / "perfbench" / "windows" / f"{cell.traffic['window']}.py").exists()
    assert w["config"] in {c["name"] for c in SPEC["configs"]}
    for m in bench.cell_metrics(name, False) + bench.cell_metrics(name, True):
        assert hasattr(bench.metric_reader(m["name"]), "read")
    reported = {m["name"] for m in bench.cell_metrics(name, False)}
    assert {"setup_s", "peak_mem_gb"} <= reported and len(reported) >= 3
    assert {m["moves"] for m in bench.cell_metrics(name, True)} <= reported


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_file_declares_what_benchmark_json_says(m):
    reader = bench.metric_reader(m["name"])
    assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (m["unit"], m["better"], m["source"])
    if "layer" in m:
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_config_files_name_their_sources():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert config["model"]["dtype"] == "float32"
        assert c["reduced"] == []


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files only run through the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    files = root / "perfbench"
    config = json.loads((files / "configs" / "ml20m-k32.json").read_text())
    config["data"].update(num_users=80, num_movies=50, nnz=1500)
    config["model"]["K"] = 4
    (files / "configs" / "tiny-k4.json").write_text(json.dumps(config))
    traffic = json.loads((files / "traffic" / "gibbs.json").read_text())
    traffic.update(sweeps_per_block=3, checked_sweeps=3, burn_in=1)
    (files / "traffic" / "short-blocks.json").write_text(json.dumps(traffic))
    (files / "limits" / "tiny.short").with_suffix(".short.json").write_text(
        (files / "limits" / "ml20m.gibbs.json").read_text())
    (files / "metrics" / "blocks_done.py").write_text(
        'UNIT = "blocks"\nBETTER = "higher"\nSOURCE = "host_clock"\n\n\n'
        "def read(run):\n    return run.counts['sweeps'] / 3\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][0], "name": "tiny-k4", "file": "perfbench/configs/tiny-k4.json"})
    spec["workloads"].append({"name": "tiny.short", "config": "tiny-k4", "traffic": "short-blocks", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"].append({"name": "blocks_done", "unit": "blocks", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["tiny.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = bench.load_cell("tiny.short", root)
    assert cell.traffic["sweeps_per_block"] == 3 and cell.config["data"]["nnz"] == 1500
    out = tiny.run("tiny.short", c=cell)
    assert out["correct"] and out["attempted"] % 3 == 0
    assert out["metrics"]["blocks_done"]["value"] == out["attempted"] / 3
    assert set(out["metrics"]) == {"blocks_done", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(name):
    out = tiny.run(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in bench.cell_metrics(name, False)}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = bench.load_cell(name).limits
    assert set(out["checks"]) == set(limits)
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_traced_tiny_run_carries_window_and_breakdown():
    cell = tiny.cell("ml20m.gibbs")
    cell.traffic["trace_blocks"] = 1
    out = tiny.run("ml20m.gibbs", trace=True, c=cell)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["metrics"]["build_s"]["value"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in bench.cell_metrics("ml20m.gibbs", True)}


def test_a_run_without_a_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the test is of a machine without one")
    env = {**os.environ, "BENCH_RUN": "1"}
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "ml20m.gibbs", "--seed", str(tiny.SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch.bpmf", "torch", "jaxtyping", "flaxen"]) == []
    assert bench.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        assert "repro_torch" not in found
    assert not found & {"benchmarks", "benchmarks_torch"}
