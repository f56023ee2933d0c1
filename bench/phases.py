"""What the phase and set-up metrics read.

The program's train steps launch an empty kernel at each phase boundary
(`repro_torch.kernels.marks`: `PHASES` in order, each kernel named
`kernel_name(phase)`): before the forward, the backward, the consensus,
the optimizer and the state write, and one after the last write. The
marks are nodes of the captured step's graph, so they replay in order
every step, on the device's clock, in the traced window's operations.
A phase lasts from its mark's start to the next mark's start; the batch
copy and the gap between steps lie after "step_end" and count to no
phase.

The set-up of the step's program (`graph.setup_seconds`) is the host
seconds its first call spent in the eager first run, the allocator's
cache releases and the graph capture; the program keeps them past its
own life, so they are read after the run has freed it.

A program that has neither (an older checkout) gives nothing to read:
the readers return None.
"""
from __future__ import annotations

PROGRAM = "dist.step"       # the name the train step registers under


def _marks():
    try:
        from repro_torch.kernels import marks
    except ImportError:
        return None
    return marks


def mark_starts(trace) -> list | None:
    """Per traced step, the start (us) of each mark in `PHASES` order; None
    unless the window holds one whole run of the marks, in order, a
    step."""
    marks = _marks()
    if marks is None or not trace.steps:
        return None
    index = {marks.kernel_name(p): i for i, p in enumerate(marks.PHASES)}
    found = [(index[name], start) for name, start, _ in trace.ops
             if name in index]
    k = len(marks.PHASES)
    if [i for i, _ in found] != list(range(k)) * trace.steps:
        return None
    return [[start for _, start in found[s * k:(s + 1) * k]]
            for s in range(trace.steps)]


def phase_ms(trace, phase: str) -> float | None:
    """The mean device milliseconds a traced step spent in `phase`: from
    its mark's start to the next mark's start."""
    starts = mark_starts(trace)
    if starts is None:
        return None
    j = _marks().PHASES.index(phase)
    return 1e-3 * sum(s[j + 1] - s[j] for s in starts) / len(starts)


def setup_s(piece: str) -> float | None:
    """The host seconds of `piece` ("first_run", "release_cache",
    "capture") in the first calls of the train step's program; None where
    the program keeps no such totals or its step never ran."""
    try:
        from repro_torch import graph
    except ImportError:
        return None
    read = getattr(graph, "setup_seconds", None)
    if read is None:
        return None
    secs = read(PROGRAM)
    if not any(secs.values()):
        return None
    return secs[piece]
