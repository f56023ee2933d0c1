"""A traced window: `torch.profiler` over a stretch of the timed path, and
what the per-layer metrics read from it.

The device's operations (kernels, copies, fills) come from the
profiler's trace, with their names, starts and lengths. The host marks
what it is doing with `torch.profiler.record_function` labels (`span`);
an idle gap on the device is put down to the label the host was inside
when the gap began. `window_s` is the host's clock around the window,
which ends in a synchronize; `busy_s` the time in it covered by at least
one device operation.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def span(label: str):
    """A host label for what the host does inside a traced window."""
    return torch.profiler.record_function(label)


@dataclasses.dataclass
class Trace:
    """One traced window and the cell it ran in."""
    cell: dict
    steps: int                      # timed-path steps inside the window
    window_s: float
    ops: list                       # [(name, start_us, dur_us)], in time
    gaps: list                      # [(host label, seconds)], in time
    host: dict                      # host-clock readings of the run

    @property
    def busy_s(self) -> float:
        return _union_s(self.ops)

    def op_seconds(self, names=None, exclude=False) -> float:
        """Seconds of device operations whose name holds one of `names`
        (every operation where None; those that hold none with
        `exclude`)."""
        total = 0.0
        for name, _, dur in self.ops:
            if names is None or any(n in name for n in names) != exclude:
                total += dur * 1e-6
        return total


def _union_s(ops: list) -> float:
    busy, end = 0.0, None
    for _, start, dur in ops:
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy * 1e-6


def record(fn, device: torch.device) -> tuple:
    """Run fn() under the profiler: (window_s, device ops, idle gaps by
    host label). fn must leave the device synchronized."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with span(WINDOW):
            fn()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return (window_s,) + _reduce(events)


def _reduce(events: list) -> tuple:
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    lo = window[0]["ts"] if window else None
    hi = lo + window[0]["dur"] if window else None
    ops = sorted((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                 for e in events if e.get("cat") in DEVICE_CATS
                 and e.get("ph") == "X")
    ops = [(n, max(s, lo), min(s + d, hi) - max(s, lo)) for n, s, d in ops
           if lo is None or (s + d > lo and s < hi)]
    ops.sort(key=lambda o: o[1])
    labels = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name") != WINDOW), key=lambda x: x[0])
    gaps = []
    end = lo
    for _, start, dur in ops:
        if end is not None and start > end:
            gaps.append((_label_at(labels, end), (start - end) * 1e-6))
        end = start + dur if end is None else max(end, start + dur)
    if hi is not None and end is not None and hi > end:
        gaps.append((_label_at(labels, end), (hi - end) * 1e-6))
    return ops, gaps


def _label_at(labels: list, t: float) -> str:
    """The innermost host label open at time t."""
    best = None
    for start, stop, name in labels:
        if start > t:
            break
        if stop >= t and (best is None or start >= best[0]):
            best = (start, name)
    return best[1] if best else "host outside a label"


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing (ten labels with the most), in seconds."""
    by_op: dict = {}
    for name, _, dur in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + dur * 1e-6
    by_gap: dict = {}
    for label, secs in trace.gaps:
        by_gap[label] = by_gap.get(label, 0.0) + secs
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
