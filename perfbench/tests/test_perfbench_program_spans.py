"""The readers of the program's own records: the engine's block records and the predictor's call records.

Each reader gives ``None`` on a run without records (a program that keeps
none, the CPU's host-clock records, no program at all) and, on a
``bench.Run`` built with fake records, the value of the window's blocks or
calls alone: records older than the window's ``counts`` are not read.
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import bench

SWEEP_READERS = ("replay_ms", "dispatch_gap_ms_per_sweep", "noise_ms_per_sweep", "solve_ms_per_sweep",
                 "hyper_ms_per_sweep")
TOPK_READERS = ("topk_score_us_per_user", "topk_sort_us_per_user")


def _run(program: dict, counts: dict, window_s: float = 1.0) -> bench.Run:
    return bench.Run(kind="fake", setup_s=0.0, window_s=window_s, counts=counts, attempted=0, failed=0,
                     peak_bytes=0, finish=dict, program=program)


def _block(first, sweeps, wall, clock="device", plain=None, **phases):
    ms = {"hyper": 1.0, "gram": 2.0, "solve": 3.0, "noise": 4.0, "predict": 0.5, "accum": 0.25}
    ms.update(phases)
    return SimpleNamespace(first_sweep=first, sweeps=sweeps, clock=clock, phase_ms=ms if clock else None,
                           wall_ms=wall if clock else None, plain_ms=plain if clock else None)


def _call(call, users, score, sort, copy=0.1, clock="device"):
    return SimpleNamespace(call=call, users=users, clock=clock, score_ms=score, sort_ms=sort, copy_ms=copy)


def _engine_run(blocks, sweeps, window_s=1.0):
    return _run({"engine": SimpleNamespace(blocks=blocks)}, {"sweeps": sweeps}, window_s)


@pytest.mark.parametrize("name", SWEEP_READERS + TOPK_READERS)
def test_none_without_records(name):
    read = bench.metric_reader(name).read
    assert read(_run({}, {"sweeps": 8, "calls": 2, "users": 8})) is None
    # the parent's program: an engine or a predictor that keeps no records
    assert read(_run({"engine": SimpleNamespace(), "predictor": SimpleNamespace()}, {"sweeps": 8, "calls": 2})) is None
    # records on the host's clock (an eager sweep, a CPU call) are not device time
    host = {"engine": SimpleNamespace(blocks=[_block(1, 8, 30.0, clock="host")]),
            "predictor": SimpleNamespace(calls=[_call(0, 4, 1.0, 1.0, clock="host")])}
    assert read(_run(host, {"sweeps": 8, "calls": 1})) is None
    # unsampled blocks only
    assert read(_engine_run([_block(1, 8, None, clock=None)], 8)) is None


def test_sweep_readers_read_only_the_window():
    # a set-up block (sweeps 1-8, far slower) and then the window's two blocks, one unsampled
    blocks = [_block(1, 8, 500.0, noise=400.0), _block(9, 8, 30.0, noise=12.0, solve=4.0, hyper=2.0),
              _block(17, 8, None, clock=None), _block(25, 8, 34.0, noise=14.0, solve=5.0, hyper=3.0)]
    run = _engine_run(blocks, sweeps=24, window_s=0.888)
    read = {name: bench.metric_reader(name).read(run) for name in SWEEP_READERS}
    assert read["replay_ms"] == pytest.approx(32.0)
    assert read["noise_ms_per_sweep"] == pytest.approx(13.0)
    assert read["solve_ms_per_sweep"] == pytest.approx(4.5)
    assert read["hyper_ms_per_sweep"] == pytest.approx(2.5)
    # 888 ms over 24 sweeps is 37 ms a sweep, 32 of them inside the replay
    assert read["dispatch_gap_ms_per_sweep"] == pytest.approx(5.0)
    assert read["replay_ms"] + read["dispatch_gap_ms_per_sweep"] == pytest.approx(1e3 * 0.888 / 24)


def test_replay_ms_weighs_the_plain_replays_of_a_block():
    # 7 plain replays of 30 ms and the timed one at 38 ms: 31 ms a sweep, not the timed 38
    run = _engine_run([_block(1, 8, 38.0, plain=30.0), _block(9, 8, 38.0, plain=30.0)], sweeps=8, window_s=0.256)
    assert bench.metric_reader("replay_ms").read(run) == pytest.approx(31.0)
    assert bench.metric_reader("dispatch_gap_ms_per_sweep").read(run) == pytest.approx(1.0)
    # the phases are the timed sweep's
    assert bench.metric_reader("noise_ms_per_sweep").read(run) == pytest.approx(4.0)


def test_topk_readers_read_only_the_window():
    # two set-up calls (the warm-up of both batch shapes), then three window calls
    calls = [_call(0, 4096, 500.0, 500.0), _call(1, 3, 100.0, 100.0),
             _call(2, 4096, 22.0, 8.0), _call(3, 4096, 21.0, 9.0), _call(4, 2048, 11.0, 4.0)]
    run = _run({"predictor": SimpleNamespace(calls=calls)}, {"calls": 3, "users": 10240})
    assert bench.metric_reader("topk_score_us_per_user").read(run) == pytest.approx(1e3 * 54.0 / 10240)
    assert bench.metric_reader("topk_sort_us_per_user").read(run) == pytest.approx(1e3 * 21.0 / 10240)


def test_records_of_a_real_engine_on_the_cpu_are_not_read():
    """A CPU run keeps host-clock records, which no reader takes for device time."""
    from perfbench.tests import tiny

    cell = tiny.cell("ml20m.gibbs")
    cell.traffic["trace_blocks"] = 1
    out = tiny.run("ml20m.gibbs", trace=True, c=cell)
    assert not set(out["metrics"]) & set(SWEEP_READERS)
