"""The captured sweep's device wall: the mean over the window's sampled blocks of a sweep's in-graph time.

Reads the engine's block records (``BPMFEngine.blocks``,
``repro_torch.trace.BlockRecord``). The window's blocks are the newest
records that hold the window's ``run.counts["sweeps"]`` sweeps; a block is
sampled when the engine read its last replay's events (every block at
``pipeline_blocks = 1``). Of a block's ``n`` sweeps, ``n - 1`` replay the
plain capture (``plain_ms``, one of them timed by events on the stream
around it) and the last replays the capture with the phase events
(``wall_ms``, its first event to its last), so a block's sweep reads
``((n - 1) * plain_ms + wall_ms) / n``: the events' own cost stays inside
the replays, and out of ``dispatch_gap_ms_per_sweep``. ``None`` where no
such record is found (a program without the phase clock, or sweeps that
were not replayed).
"""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sweep program"
MOVES = "sweep_ms"


def window_records(run) -> list:
    """The window's sampled block records on the device's clock."""
    blocks = getattr(run.program.get("engine"), "blocks", None)
    sweeps = run.counts.get("sweeps")
    if not blocks or not sweeps:
        return []
    window, n = [], 0
    for record in reversed(blocks):
        if n >= sweeps:
            break
        window.append(record)
        n += record.sweeps
    return [r for r in window if r.clock == "device"]


def phase_ms(run, name: str):
    """Mean device milliseconds of phase ``name`` over the window's sampled sweeps."""
    records = window_records(run)
    return sum(r.phase_ms[name] for r in records) / len(records) if records else None


def sweep_ms(record) -> float:
    """A sampled block's mean in-graph device milliseconds a sweep."""
    if record.plain_ms is None:
        return record.wall_ms
    return ((record.sweeps - 1) * record.plain_ms + record.wall_ms) / record.sweeps


def read(run):
    records = window_records(run)
    return sum(sweep_ms(r) for r in records) / len(records) if records else None
