"""The cell ``ml20m-k128.gibbs`` on the CPU at its rank, and the reader of ``solve_roofline``.

The tiny cell keeps K = 128 (``tiny.cell`` cuts it to 4): the port through
the harness is ``correct`` against the reference under the cell's limits,
and the TF32 control is not. ``solve_roofline``'s need is checked by hand
at K = 32 and 128, and the reader gives ``None`` without phase records and
where the captured sweep factored fewer rows than the two sides have.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from perfbench import bench, datagen
from perfbench.reference import bpmf as ref
from perfbench.tests import tiny
from perfbench.windows import gibbs

CELL = "ml20m-k128.gibbs"
H100 = "NVIDIA H100 80GB HBM3"
ML20M_ROWS = 138_493 + 27_278


def _cell_at_rank() -> bench.Cell:
    cell = tiny.cell(CELL)
    cell.config["model"]["K"] = bench.load_cell(CELL).config["model"]["K"]
    return cell


def test_the_cell_runs_at_rank_128():
    assert bench.load_cell(CELL).config["model"]["K"] == 128
    assert bench.load_cell(CELL).config["data"] == bench.load_cell("ml20m.gibbs").config["data"]


def test_the_port_at_rank_128_is_correct_through_the_harness():
    cell = _cell_at_rank()
    out = tiny.run(CELL, c=cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(cell.limits)


def test_the_control_at_rank_128_fails_a_limit():
    ctx = bench.Context(_cell_at_rank(), tiny.SEED, 0.0, False, tiny.CPU, time.perf_counter())
    ratings = datagen.ratings(ctx.cell.config["data"], ctx.seed)
    got = gibbs.compare(gibbs.reference(ctx, ratings, ref.CONTROL), gibbs.reference(ctx, ratings))
    assert any(v > ctx.cell.limits[k] for k, v in got.items())


@pytest.mark.parametrize("K,bytes_,flops", [
    # a row: K^2 + 2K floats; K^3 / 3 + 4 K^2 + 2 K flops
    (32, 4 * (1024 + 64), 32768 / 3 + 4096 + 64),
    (128, 4 * (16384 + 256), 2097152 / 3 + 65536 + 256),
])
def test_solve_need_by_hand(K, bytes_, flops):
    need = bench.metric_reader("solve_roofline").need
    assert need(1, K) == pytest.approx((bytes_, flops))
    assert need(ML20M_ROWS, K) == pytest.approx((ML20M_ROWS * bytes_, ML20M_ROWS * flops))


def _run(solve_ms: float | None, factored: int | None, K: int = 32) -> bench.Run:
    blocks = []
    if solve_ms is not None:
        blocks = [SimpleNamespace(first_sweep=1, sweeps=8, clock="device", wall_ms=30.0, plain_ms=None,
                                  phase_ms={"solve": solve_ms})]
    graph = SimpleNamespace() if factored is None else SimpleNamespace(factor_rows_per_replay=factored)
    engine = SimpleNamespace(blocks=blocks, backend=SimpleNamespace(graph=graph))
    return bench.Run(kind="gibbs", setup_s=0.0, window_s=1.0, counts={"sweeps": 8}, attempted=8, failed=0,
                     peak_bytes=0, finish=dict, program={"engine": engine}, device_kind=H100,
                     shapes={"num_users": 138_493, "num_movies": 27_278, "K": K})


def test_solve_roofline_reads_the_bound_over_the_solve_phase():
    read = bench.metric_reader("solve_roofline").read
    # K = 32: 165,771 rows of 4,352 bytes over 3.35 TB/s (the bytes bound it) in 8.93 ms
    assert read(_run(8.93, ML20M_ROWS)) == pytest.approx(100 * ML20M_ROWS * 4352 / 3.35e12 / 8.93e-3)
    assert read(_run(8.93, ML20M_ROWS)) == pytest.approx(2.4116, abs=1e-4)
    # K = 128: the bytes still bound it, 11.0 GB
    assert read(_run(50.0, ML20M_ROWS + 7, K=128)) == pytest.approx(100 * ML20M_ROWS * 66560 / 3.35e12 / 50e-3)


def test_solve_roofline_is_none_without_records_or_rows():
    read = bench.metric_reader("solve_roofline").read
    assert read(_run(None, ML20M_ROWS)) is None  # no phase records
    assert read(_run(8.93, None)) is None  # a program without the counter
    assert read(_run(8.93, ML20M_ROWS - 1)) is None  # a sweep that factored too few rows
    assert read(bench.Run(kind="gibbs", setup_s=0.0, window_s=1.0, counts={"sweeps": 8}, attempted=8,
                          failed=0, peak_bytes=0, finish=dict)) is None  # no program, no shapes
    unknown = _run(8.93, ML20M_ROWS)
    unknown.device_kind = "cpu"
    assert read(unknown) is None  # no peak for the device
