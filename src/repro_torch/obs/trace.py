"""Chrome trace-event exporter (port of `repro.obs.trace`): obs events →
`trace.json` for Perfetto.

`ChromeTraceSink` converts each obs event to the Trace Event Format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
and writes `{"traceEvents": [...]}` on close — drag the file into
https://ui.perfetto.dev (or chrome://tracing) to browse the span tree.
Spans become complete ("X") events with microsecond ts/dur; counters,
gauges and histogram samples become counter ("C") tracks. `validate_trace`
is the schema check the tests and `chip_smoke.py` gate the emitted file
on, so "loads in Perfetto" is asserted structurally, not
by eyeball.

`start_profiler_trace` / `stop_profiler_trace` wrap the optional
`torch.profiler` passthrough (the card's kernels and copies next to the
host-side spans; the reference wraps `jax.profiler.trace`). They degrade
to a no-op with a recorded reason whenever the profiler is missing or
refuses to start: a run must not crash for want of a device trace.
"""
from __future__ import annotations

import json
import os
from typing import Union

_US = 1e6                     # seconds -> microseconds
_PHASES = {"B", "E", "X", "C", "M", "I", "i", "b", "e", "n", "s", "t", "f"}


def to_trace_event(event: dict) -> Union[dict, None]:
    """One obs event → one Chrome trace event (None: not representable)."""
    etype = event.get("type")
    pid = int(event.get("pid", 0))
    tid = int(event.get("tid", 0))
    ts = float(event.get("ts", 0.0)) * _US
    if etype == "span":
        return {"name": event["name"], "ph": "X", "ts": ts,
                "dur": float(event.get("dur", 0.0)) * _US,
                "pid": pid, "tid": tid,
                "cat": "span", "args": dict(event.get("attrs") or {})}
    if etype in ("counter", "gauge", "hist"):
        return {"name": event["name"], "ph": "C", "ts": ts,
                "pid": pid, "tid": tid, "cat": etype,
                "args": {"value": float(event.get("value", 0.0))}}
    if etype == "meta":
        return {"name": event["name"], "ph": "i", "ts": ts,
                "pid": pid, "tid": tid, "s": "g",
                "cat": "meta", "args": dict(event.get("data") or {})}
    return None


def build_trace(events, process_name: str = "repro_torch") -> dict:
    """Full Chrome trace document from a list of obs events."""
    pids = sorted({int(e.get("pid", 0)) for e in events}) or [os.getpid()]
    trace_events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "args": {"name": process_name}} for pid in pids]
    for e in events:
        te = to_trace_event(e)
        if te is not None:
            trace_events.append(te)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


class ChromeTraceSink:
    """Accumulates converted events; writes the trace document on close."""

    def __init__(self, path: str, process_name: str = "repro_torch"):
        self.path = path
        self.process_name = process_name
        self._events: list[dict] = []

    def emit(self, event: dict) -> None:
        te = to_trace_event(event)
        if te is not None:
            self._events.append(te)

    def close(self) -> None:
        pids = sorted({e["pid"] for e in self._events}) or [os.getpid()]
        doc = {"traceEvents":
               [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": self.process_name}} for pid in pids]
               + self._events,
               "displayTimeUnit": "ms"}
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(doc, f)


def validate_trace(trace: Union[str, dict, list]) -> int:
    """Assert `trace` (a path, document dict, or bare event list) is valid
    Chrome trace-event JSON; returns the event count. Raises ValueError
    with every violation found — the structural stand-in for "opens in
    ui.perfetto.dev"."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace document must carry a 'traceEvents' list")
    elif isinstance(trace, list):
        events = trace
    else:
        raise ValueError(f"not a trace document: {type(trace)}")
    problems = []
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: bad phase {ph!r}")
            continue
        if "name" not in e:
            problems.append(f"event {i}: missing name")
        if ph in ("X", "B", "E", "C", "I", "i"):
            if not isinstance(e.get("ts"), (int, float)):
                problems.append(f"event {i} ({ph}): missing numeric ts")
            if "pid" not in e:
                problems.append(f"event {i} ({ph}): missing pid")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0")
        if ph == "C" and not isinstance(e.get("args"), dict):
            problems.append(f"event {i}: C event needs numeric args")
    if problems:
        raise ValueError("invalid Chrome trace: " + "; ".join(problems[:10]))
    return len(events)


def start_profiler_trace() -> tuple:
    """Best-effort start of a `torch.profiler` trace of the CPU and, with a
    card, CUDA activity; (the running profile or None, reason-if-not)."""
    try:
        import torch                                   # noqa: PLC0415
        from torch import profiler                     # noqa: PLC0415
        acts = [profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(profiler.ProfilerActivity.CUDA)
        prof = profiler.profile(activities=acts)
        prof.start()
        return prof, None
    except Exception as e:
        # no profiler build, a trace already running, a missing module:
        # all mean "no device trace", never "crash the run"
        return None, f"{type(e).__name__}: {e}"


def stop_profiler_trace(prof, trace_dir: str) -> tuple:
    """Best-effort stop of `prof`; writes `<trace_dir>/profiler_trace.json`
    (Chrome format); (ok, reason-if-not)."""
    try:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "profiler_trace.json"))
        return True, None
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
