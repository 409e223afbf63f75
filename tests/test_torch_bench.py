"""The port's benchmark scripts (``benchmarks_torch/``) on the CPU at their smoke size.

Each benchmark's ``run(smoke=True, out_path=..., device="cpu")`` runs in
process, writes only where it is told (the fig2 benchmark's autotune cache
beside its output, never the committed one), and its JSON passes the
port's schema gate (``scripts/check_bench_schema_torch.py``), which the
committed full-size files pass as well.
"""
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks_torch import (  # noqa: E402
    common,
    fig2_item_update,
    fig3_multicore,
    fig4_scaling,
    fig5_overlap,
    fig_merge_comm,
    rmse_convergence,
    serve_latency,
    sweep_throughput,
)


def _schema():
    spec = importlib.util.spec_from_file_location("check_bench_schema_torch",
                                                  ROOT / "scripts" / "check_bench_schema_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# name -> the driver's in-process run(smoke, out_path, device). fig4's
# process sweep runs 1 and 2 gloo processes under a timeout: the slice's one
# subprocess test
BENCHMARKS = {
    "fig2_item_update": fig2_item_update.run,
    "fig3_multicore": fig3_multicore.run,
    "fig4_scaling": lambda **kw: fig4_scaling.run(processes=(1, 2), timeout=240, **kw),
    "fig5_overlap": fig5_overlap.run,
    "fig_merge_comm": fig_merge_comm.run,
    "rmse_convergence": rmse_convergence.run,
    "serve_latency": serve_latency.run,
    "serve_load": lambda **kw: serve_latency.run(load=True, **kw),
    "sweep_throughput": sweep_throughput.run,
}


@pytest.fixture(autouse=True)
def one_thread():
    """The benchmarks' thousands of small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(BENCHMARKS))
def test_benchmark_smoke_run_passes_the_schema_gate(name, tmp_path):
    out = tmp_path / f"{name}.json"
    committed = Path(common.OUT_DIR) / f"{name}.json"
    before = committed.read_bytes() if committed.exists() else None
    payload = BENCHMARKS[name](smoke=True, out_path=str(out), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload, default=str))
    assert (committed.read_bytes() if committed.exists() else None) == before  # never the committed file
    assert payload["smoke"] is True and payload["device"] == "cpu" and payload["card"] == "cpu"
    schema = _schema()
    assert schema.check(name, payload, committed=False) == []
    assert schema.check(name, payload, committed=True) != []  # a smoke run is no committed file
    if name == "fig2_item_update":
        cache = json.loads((tmp_path / "gram_cuda.json").read_text())
        assert schema.check("gram_cuda", cache, committed=False) == []
        assert len(cache["entries"]) == len(payload["kernel_sweep"]) == 2
    if name == "rmse_convergence":
        assert payload["parity_ok"] and payload["max_trajectory_gap"] < payload["parity_tol"]
    if name == "fig5_overlap":
        assert payload["ring_async_bitwise"] and payload["parity_ok"]
    if name == "fig4_scaling":
        ps = payload["process_sweep"]
        assert ps["ring_bytes_per_sweep"]["model_matches"]
        assert [r["processes"] for r in ps["layouts"]] == [1, 2]
        assert all(r["rotation_model_matches"] for r in ps["layouts"])
    if name == "fig_merge_comm":
        assert payload["zero_comm_ok"]
    if name == "serve_load":
        assert all(e["errors"] == 0 and e["dropped"] == 0 for e in payload["load"].values())


@pytest.mark.parametrize("name", ["fig2_item_update", "sweep_throughput", "rmse_convergence", "gram_cuda",
                                  "fig3_multicore", "fig4_scaling", "fig5_overlap", "fig_merge_comm",
                                  "serve_latency", "serve_load"])
def test_committed_files_pass_the_schema_gate(name):
    schema = _schema()
    path = Path(schema.PATHS[name])
    payload = json.loads(path.read_text())
    assert schema.check(name, payload, committed=True) == []
    assert payload.get("device", "gpu") == "gpu"  # the committed numbers are the card's
