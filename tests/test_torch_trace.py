"""The port's tracing (``repro_torch.trace``): host spans, the sweep's phase clock, block and call records.

On the CPU:

* a span opens a ``record_function`` only while a profiler records, and
  adds to its total either way;
* an eager sweep under ``torch.profiler`` shows every phase span, on both
  sides, in order (sequential and the ring);
* factors, hyper-parameters and RMSEs are the same bits with the profiler
  on and off;
* the engine's block records and the predictor's call records stay bounded
  and carry their ids; blocks in flight together are each sampled, and a
  replay that a later block reaches before it has completed is unsampled;
* ``prepare_seconds``, ``host_blocked_s`` and ``Ring.host_seconds`` hold
  their spans' times.

Marked ``cuda`` (skipped without a card; run on one with ``PYTHONPATH=src
python -m pytest -m cuda tests/test_torch_trace.py``): a graph captured
with and without phase events launches the same kernels per replay and
draws the same samples; a sampled sweep's phases sum to its replay's
device wall, and the plain replay beside it is timed; at
``pipeline_blocks = 1`` every block is sampled, and at 3, behind a busy
card, a read that a later block would spoil is skipped;
``warmup_seconds``, ``capture_seconds`` and ``timed_capture_seconds``
hold their spans' times, and the launch counters count the timed
capture's first replay; the top-k's call records come from CUDA events.
This file imports no JAX.
"""
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core.sweep_graph import SweepGraph, launch_counts, tensors
from repro_torch.serve import PosteriorPredictor

TASK = dict(num_users=90, num_movies=50, nnz=1500, noise_std=0.3, seed=5)
LETTERS = {"hyper": "H", "gram": "G", "solve": "S", "noise": "N", "predict": "P", "accum": "A"}
# one sweep: per side the hyper draw, then per bucket gram, solve, noise,
# solve (the ring: the steps' Gram terms, then per shard solve, noise, solve)
SWEEP = re.compile(r"(HGSNS(?:GSNS|NS)*){2}PA")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured sweep runs only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(name="sequential", device="cpu", **kw) -> BPMFEngine:
    kw = dict(dict(name=name, num_shards=2, K=4, burn_in=1, num_sweeps=4, sweeps_per_block=2,
                   bucket_pads=(8, 32, 128), keep_factor_samples=2), **kw)
    engine = BPMFEngine(BPMFConfig().replace(**kw), device=device)
    engine.prepare(load_dataset("synthetic", **TASK))
    return engine


def _program_spans(prof) -> list[str]:
    events = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    return [e.name()[len(trace.PREFIX):] for e in events
            if e.name().startswith(trace.PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU]


def test_span_records_a_function_only_under_a_profiler(monkeypatch):
    opened = []

    class Recorder(trace.record_function):
        def __init__(self, name, args=None):
            opened.append((name, args))
            super().__init__(name, args)

    monkeypatch.setattr(trace, "record_function", Recorder)
    trace.reset_totals()
    with trace.span("test.quiet", sweep=3) as quiet:
        pass
    assert opened == [] and quiet.seconds >= 0.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.loud", sweep=4) as loud:
            pass
    assert opened == [("repro_torch: test.loud", "sweep=4")]
    assert _program_spans(prof) == ["test.loud"]
    totals = trace.totals()
    assert totals["test.quiet"] == (1, quiet.seconds) and totals["test.loud"] == (1, loud.seconds)


@pytest.mark.parametrize("name", ["sequential", "ring"])
def test_eager_sweep_shows_every_phase_span_in_order(name):
    engine = _engine(name, num_sweeps=1, sweeps_per_block=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.fit()
    spans = _program_spans(prof)
    assert spans[0] == "engine.dispatch" and spans[-2:] == ["engine.drain", "engine.metrics_wait"]
    phases = "".join(LETTERS[s.split(".")[1]] for s in spans if s.startswith("sweep."))
    assert SWEEP.fullmatch(phases), phases
    if name == "ring":
        assert [s for s in spans if s == "ring.step"] == ["ring.step"] * 4  # S = 2 steps, both sides


@pytest.mark.parametrize("name", ["sequential", "ring"])
def test_profiler_changes_no_number(name):
    quiet = _engine(name).fit()
    with profile(activities=[ProfilerActivity.CPU]):
        loud = _engine(name).fit()
    for a, b in zip(quiet.factors(), loud.factors()):
        np.testing.assert_array_equal(a, b)
    for side in ("hyper_U", "hyper_V"):
        for field in ("mu", "Lam"):
            assert torch.equal(getattr(getattr(quiet.state, side), field), getattr(getattr(loud.state, side), field))
    assert quiet.history == loud.history


def test_block_records_are_bounded_and_carry_their_first_sweep(monkeypatch):
    monkeypatch.setattr(trace, "BLOCK_RECORDS", 2)
    engine = _engine(num_sweeps=6, sweeps_per_block=2).fit()
    assert [(b.first_sweep, b.sweeps, b.clock) for b in engine.blocks] == [(3, 2, "host"), (5, 2, "host")]
    for b in engine.blocks:
        assert set(b.phase_ms) == set(trace.PHASES) and all(v > 0 for v in b.phase_ms.values())
        assert sum(b.phase_ms.values()) <= b.wall_ms and b.plain_ms is None


def test_blocks_in_flight_together_are_each_sampled():
    engine = _engine(num_sweeps=6, sweeps_per_block=2, pipeline_blocks=2).fit()
    assert [(b.first_sweep, b.clock) for b in engine.blocks] == [(1, "host"), (3, "host"), (5, "host")]


class _Events:
    """A timed capture's events, which have completed once ``finished`` says so."""

    def __init__(self):
        self.finished = False

    def done(self) -> bool:
        return self.finished

    def read(self):
        return dict.fromkeys(trace.PHASES, 1.0), 6.0


def test_a_block_whose_clock_a_later_block_replays_is_unsampled():
    engine = _engine(num_sweeps=6, sweeps_per_block=2, pipeline_blocks=2)
    events, replays = _Events(), []

    def phase_clock():
        # as the graph does before it replays the events again; the second block has completed
        # when the third reaches them, the first had not when the second did
        events.finished = len(replays) == 2
        if replays:
            replays[-1].settle()
        replays.append(trace.TimedReplay(events, None))
        return replays[-1]

    engine.backend.phase_clock = phase_clock
    engine.fit()
    assert [(b.first_sweep, b.clock) for b in engine.blocks] == [(1, None), (3, "device"), (5, "device")]
    assert engine.blocks[0].phase_ms is None and engine.blocks[0].wall_ms is None
    assert engine.blocks[2].wall_ms == 6.0 and engine.blocks[2].plain_ms is None


def test_a_settled_replay_keeps_its_reading():
    events = _Events()
    early, late = trace.TimedReplay(events, None), trace.TimedReplay(events, None)
    early.settle()  # reached while still running: unsampled for good
    events.finished = True
    late.settle()
    events.finished = False  # a later replay of the same events no longer moves it
    assert early.reading() == (None, None, None, None)
    assert late.reading() == ("device", dict.fromkeys(trace.PHASES, 1.0), 6.0, None)


def test_call_records_are_bounded_and_carry_their_ids(monkeypatch):
    monkeypatch.setattr(trace, "CALL_RECORDS", 2)
    predictor = PosteriorPredictor.from_engine(_engine().fit())
    for users in ([0, 1, 2], [3], [4, 5], [6, 7, 8, 9]):
        predictor.top_k(np.asarray(users), 3)
    predictor.top_k(np.asarray([1, 2]), 3, sharded=True)  # the item-sharded scan keeps no record
    assert [(c.call, c.users, c.clock) for c in predictor.calls] == [(2, 2, "host"), (3, 4, "host")]
    assert all(c.score_ms > 0 and c.sort_ms > 0 and c.copy_ms > 0 for c in predictor.calls)


@pytest.mark.parametrize("name", ["sequential", "ring"])
def test_program_timers_hold_their_spans(name):
    trace.reset_totals()
    engine = _engine(name).fit()
    totals = trace.totals()
    assert engine.backend.prepare_seconds == {"build": totals["backend.build"][1],
                                              "upload": totals["backend.upload"][1]}
    assert engine.backend.prepare_seconds["build"] > 0
    assert engine.host_blocked_s == pytest.approx(totals["engine.metrics_wait"][1], rel=1e-12)
    assert totals["engine.metrics_wait"][0] == totals["engine.drain"][0] == 2
    if name == "ring":
        # one process: nothing crosses processes, so no ring span adds to it
        assert engine.backend.ring.host_seconds == 0.0


# ---------------------------------------------------------------- on the card


def _capture_pair(engine):
    b = engine.backend
    carry = (b.init_state(engine._k_init), b.init_pred(), b.init_accum())
    graphs = [SweepGraph(b._sweep, engine._k_run, carry, phase_events=flag) for flag in (True, False)]
    return carry, graphs


def _kernels_per_replay(graph, key, carry) -> int:
    graph.run(key, carry, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.run(key, carry, 1)
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
               and not e.name().startswith(("Memcpy", "Memset")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "ring"])
def test_phase_events_add_no_kernel_and_change_no_sample(cuda, name):
    engine = _engine(name, device=cuda)
    carry, (timed, plain) = _capture_pair(engine)
    assert timed.timed is not None and plain.timed is None
    outs = [g.run(engine._k_run, carry, 3, donate=False) for g in (timed, plain)]
    assert isinstance(timed.phases, trace.TimedReplay) and plain.phases is None
    for a, b in zip(tensors(outs[0]), tensors(outs[1]), strict=True):
        assert torch.equal(a, b)
    assert _kernels_per_replay(timed, engine._k_run, carry) == _kernels_per_replay(plain, engine._k_run, carry)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "ring"])
def test_sampled_phases_sum_to_the_replay(cuda, name):
    engine = _engine(name, device=cuda, num_sweeps=11, sweeps_per_block=4).fit()
    assert [(b.first_sweep, b.clock) for b in engine.blocks] == [(1, "device"), (5, "device"), (9, "device")]
    # a block of 3 times its second sweep; one of 2 would find the card idle, and times none
    assert engine.blocks[2].plain_ms is not None
    for b in engine.blocks:
        assert all(b.phase_ms[p] > 0 for p in trace.PHASES)
        assert sum(b.phase_ms.values()) == pytest.approx(b.wall_ms, rel=0.02)
        # the plain replay has the same kernels and none of the events
        assert 0 < b.plain_ms <= 1.1 * b.wall_ms


@pytest.mark.cuda
@pytest.mark.parametrize("depth, sampled", [(1, [True] * 4), (3, [False, False, None, True])])
def test_a_read_a_later_block_would_spoil_is_skipped(cuda, depth, sampled):
    """A block's events are read when the next block reaches them, if the block has completed by then.

    The card sleeps first, so the first blocks are still queued when the
    next ones reach the events; the third block may or may not have ended
    when the fourth does; the last is read once the fit has read it back.
    """
    engine = _engine(device=cuda, num_sweeps=8, pipeline_blocks=depth)
    engine.fit()  # builds and captures; its blocks are not the ones checked
    engine.cfg = engine.cfg.replace(num_sweeps=16)
    torch.cuda._sleep(int(5e8))
    list(engine.sample())
    blocks = engine.blocks[4:]
    assert [b.first_sweep for b in blocks] == [9, 11, 13, 15]
    for b, want in zip(blocks, sampled, strict=True):
        assert b.clock in ("device", None) and (want is None or (b.clock == "device") == want)
        assert b.plain_ms is None  # blocks of 2: the plain replay finds the card idle, and is not timed


@pytest.mark.cuda
def test_graph_timers_hold_their_spans(cuda):
    trace.reset_totals()
    before = launch_counts()
    engine = _engine(device=cuda).fit()
    totals, graph = trace.totals(), engine.backend.graph
    # the warm-up, the timed capture's first replay and the run's replays each launch the kernels once
    assert graph.setup_sweeps == 2 and sum(graph.launches_per_replay.values()) > 0
    assert {k: v - before[k] for k, v in launch_counts().items()} == {
        k: (graph.setup_sweeps + graph.replays) * v for k, v in graph.launches_per_replay.items()}
    assert graph.warmup_seconds == totals["sweep_graph.warmup"][1] > 0
    assert graph.capture_seconds == totals["sweep_graph.capture"][1] > 0
    assert graph.timed_capture_seconds == totals["sweep_graph.timed_capture"][1] > 0
    assert totals["sweep_graph.launch"][0] == graph.replays == 4 and graph.runs == 2


@pytest.mark.cuda
def test_call_records_come_from_events_on_the_card(cuda):
    predictor = PosteriorPredictor.from_engine(_engine(device=cuda).fit())
    side = torch.cuda.Stream()
    for call in range(5):
        if call == 2:  # on another stream than the events': no record, then none for the switch back
            with torch.cuda.stream(side):
                ids, _ = predictor.top_k(np.arange(20 + call), 5)
        else:
            ids, _ = predictor.top_k(np.arange(20 + call), 5)
        assert ids.shape == (20 + call, 5)
    assert [(c.call, c.users, c.clock) for c in predictor.calls] == [(0, 20, "device"), (1, 21, "device"),
                                                                      (4, 24, "device")]
    assert all(c.score_ms > 0 and c.sort_ms > 0 and c.copy_ms > 0 for c in predictor.calls)
