"""Spans, counters, gauges, histograms — zero overhead when disabled (port
of `repro.obs.core`, the same event schema and session stack).

The module-level API (`span`, `counter`, `gauge`, `histogram`, `traced`)
reads one global: the currently active `Obs` session. Disabled (the
default) every call is a global load + an early return — `span` hands back
a shared no-op context manager, the metric calls return before touching
their arguments — so instrumentation can live permanently on the host-side
hot paths. Spans time the host's view of a call (`time.perf_counter`),
which includes device work only insofar as the call blocks; pair with the
`torch.profiler` passthrough (`enable(profiler_trace_dir=...)`, where the
reference has `jax_trace_dir=`) for the card's timeline.

The contract the tests pin: enabling obs changes no numerics (params, EF,
ledger, tokens bitwise equal with it disabled). Everything here observes
from the host and never reads a tensor's values.

Sessions nest as a stack: `enable()` pushes a new session (innermost
wins), `disable()` pops and closes it (flushing JSONL, writing
trace.json); `use(obs)` activates an existing session for a scope without
owning its lifetime; `suspended()` blanks the stack for a scope — how an
overhead measurement keeps its disabled arm clean inside an enabled
session.

While a `torch.profiler` trace is on, every span also enters a
`record_function` label of its name (`label`), so the spans stand in the
profiler's trace beside the device's operations, on one clock; the
program's own host phases (`graph.fill`, `graph.replay`, ...) are such
labels alone, which emit no event. With neither a session nor a profiler,
`span` is the shared no-op.

One departure from the reference's summary: its `jax_trace` block is
`profiler_trace` here.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs import costs as costs_lib
from repro_torch.obs import recompile
from repro_torch.obs import report as report_lib
from repro_torch.obs import sinks as sinks_lib
from repro_torch.obs import trace as trace_lib

_STACK: list["Obs"] = []          # innermost active session last
_ACTIVE: Optional["Obs"] = None   # == _STACK[-1] (None: disabled)


class _NoopSpan:
    """The shared disabled-path span: enter/exit do nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def label(name: str):
    """A `torch.profiler.record_function` label `name` while the profiler
    is on, else `NOOP_SPAN`: a host span on the profiler's clock that
    emits no obs event."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NOOP_SPAN


class Span:
    """A wall-clock span; emits one event on exit, and stands in a running
    profiler's trace as `label(name)`. Use via `obs.span(...)`."""
    __slots__ = ("_obs", "name", "attrs", "_t0", "_label")

    def __init__(self, obs: "Obs", name: str, attrs: dict):
        self._obs = obs
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tls = self._obs._tls
        tls.depth = getattr(tls, "depth", 0) + 1
        self._label = label(self.name)
        self._label.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._label.__exit__(*exc)
        o = self._obs
        depth = o._tls.depth
        o._tls.depth = depth - 1
        o.emit({"type": "span", "name": self.name,
                "ts": self._t0 - o._epoch, "dur": t1 - self._t0,
                "pid": o._pid, "tid": threading.get_ident() & 0x7FFFFFFF,
                "depth": depth, "attrs": self.attrs})
        return False


class Obs:
    """One telemetry session: an event clock, a sink list, and a recompile
    baseline. Construct directly for tests, or via `enable()`."""

    def __init__(self, sinks=(), profiler_trace_dir: Optional[str] = None,
                 costs: bool = True):
        self.sinks = list(sinks)
        self.costs_enabled = costs
        self._cost_captures: dict = {}   # sig -> capture record (costs.py)
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._tls = threading.local()
        self._pinned: list = []       # programs registered while active
        self._baseline = recompile.counts()
        self._summary: Optional[dict] = None
        self.closed = False
        self.profiler_trace_active = False
        self.profiler_trace_error: Optional[str] = None
        self._profiler = None
        self._profiler_dir = profiler_trace_dir
        if profiler_trace_dir is not None:
            self._profiler, why = trace_lib.start_profiler_trace()
            self.profiler_trace_active = self._profiler is not None
            self.profiler_trace_error = why
        recompile.add_callback(self._on_register)

    # -- recompile pinning ---------------------------------------------------
    def _on_register(self, name: str, fn) -> None:
        # keep programs registered during this session alive until the
        # summary reads their last cache size (their owner may be garbage
        # before the summary is built)
        self._pinned.append(fn)

    # -- emission ------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def emit(self, event: dict) -> None:
        for s in self.sinks:
            s.emit(event)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _metric(self, etype: str, name: str, value, attrs: dict) -> None:
        self.emit({"type": etype, "name": name, "ts": self.now(),
                   "value": float(value), "pid": self._pid,
                   "tid": threading.get_ident() & 0x7FFFFFFF,
                   "attrs": attrs})

    def counter(self, name: str, value=1, **attrs) -> None:
        self._metric("counter", name, value, attrs)

    def gauge(self, name: str, value, **attrs) -> None:
        self._metric("gauge", name, value, attrs)

    def histogram(self, name: str, value, **attrs) -> None:
        self._metric("hist", name, value, attrs)

    def meta(self, name: str, **data) -> None:
        self.emit({"type": "meta", "name": name, "ts": self.now(),
                   "pid": self._pid, "tid": 0, "data": data})

    # -- cost capture --------------------------------------------------------
    def observe_call(self, name: str, fn, args, kwargs=None, *,
                     static=None, span: Optional[str] = None,
                     wire_bytes=None) -> None:
        """Record one observed call of a named program for the cost model
        (abstract signature + call count + analytic wire bytes). Never
        executes anything, never reads a tensor's values, never raises."""
        if not self.costs_enabled:
            return
        try:
            costs_lib.record_call(self._cost_captures, name, fn, args,
                                  kwargs, static=static, span=span,
                                  wire_bytes=wire_bytes)
        except Exception:
            pass                          # the cost model must never crash

    def costs(self, *, compile_ok: bool = False) -> dict:
        """Per-program cost snapshot of every specialization observed while
        this session was active (see `repro_torch.obs.costs.snapshot`):
        analytic bytes and operations for the kernels, the reason for every
        other program (eager torch has no compiler cost analysis)."""
        return costs_lib.snapshot(self._cost_captures, compile_ok=compile_ok)

    # -- readback ------------------------------------------------------------
    def memory_events(self) -> list:
        for s in self.sinks:
            if isinstance(s, sinks_lib.MemorySink):
                return s.events
        return []

    def recompiles(self) -> dict:
        """Per-program specializations since this session was enabled."""
        return recompile.delta(self._baseline, recompile.counts())

    def summary(self) -> dict:
        """Aggregate view (spans/metrics from the memory sink, recompile
        deltas, profiler-trace status). Cached at close time."""
        if self._summary is not None:
            return self._summary
        s = report_lib.summarize(self.memory_events(),
                                 recompiles=self.recompiles())
        s["profiler_trace"] = {"active": self.profiler_trace_active,
                               "error": self.profiler_trace_error}
        if self.costs_enabled:
            try:
                snap = self.costs()
                s["costs"] = snap
                costs_lib.attach_attrib(s, snap)
            except Exception as e:        # degrade, never crash a summary
                s["costs"] = {"error": f"{type(e).__name__}: {e}",
                              "programs": {}}
        if self.closed:
            self._summary = s
        return s

    def close(self) -> dict:
        """Stop the profiler trace, freeze the summary, flush/close every
        sink, release pinned programs. Idempotent; returns the summary."""
        if self.closed:
            return self.summary()
        if self.profiler_trace_active:
            ok, why = trace_lib.stop_profiler_trace(self._profiler,
                                                    self._profiler_dir)
            self.profiler_trace_active = False
            self._profiler = None
            if not ok:
                self.profiler_trace_error = why
        recompile.remove_callback(self._on_register)
        self.closed = True
        s = self.summary()          # caches (pins still alive here)
        # surface attribution as counter tracks in the Chrome trace: one
        # final sample per attributed span (after the cached summary, so
        # these synthetic events never pollute the aggregates)
        for span_name, sp in s["spans"].items():
            at = sp.get("attrib") or {}
            for key in ("roofline_frac", "flops_per_s_achieved",
                        "wire_min_bytes_per_s"):
                if at.get(key) is not None:
                    self._metric("gauge", f"attrib.{span_name}.{key}",
                                 at[key], {})
        self.meta("obs.summary", **{"spans": len(s["spans"]),
                                    "events": s["events"]})
        for sink in self.sinks:
            sink.close()
        self._pinned.clear()
        return s


# ---------------------------------------------------------------------------
# The module-global session stack
# ---------------------------------------------------------------------------
def enabled() -> bool:
    return _ACTIVE is not None


def get() -> Optional[Obs]:
    """The innermost active session, or None when disabled."""
    return _ACTIVE


def _set_active(obs: Optional[Obs]) -> None:
    global _ACTIVE
    _ACTIVE = obs


def enable(*, memory: bool = True, jsonl: Optional[str] = None,
           trace: Optional[str] = None,
           profiler_trace_dir: Optional[str] = None, sinks=(),
           costs: bool = True) -> Obs:
    """Activate a new session. `memory=True` keeps events in-process for
    `summary()`; `jsonl=`/`trace=` add file sinks (the trace file is
    written at `disable()`); `profiler_trace_dir=` starts the optional
    `torch.profiler` passthrough (no-op with a recorded reason when the
    profiler is unavailable); `costs=True` (default) captures per-program
    call signatures for the cost model (`session.costs()`, and the
    `costs`/`attrib` blocks of the summary). Returns the session (keep it:
    `summary()` stays readable after `disable()`)."""
    built = list(sinks)
    if memory:
        built.append(sinks_lib.MemorySink())
    if jsonl is not None:
        built.append(sinks_lib.JsonlSink(jsonl))
    if trace is not None:
        built.append(trace_lib.ChromeTraceSink(trace))
    obs = Obs(built, profiler_trace_dir=profiler_trace_dir, costs=costs)
    _STACK.append(obs)
    _set_active(obs)
    return obs


def disable() -> Optional[Obs]:
    """Close and pop the innermost session; returns it (summary intact)."""
    if not _STACK:
        return None
    obs = _STACK.pop()
    _set_active(_STACK[-1] if _STACK else None)
    obs.close()
    return obs


@contextlib.contextmanager
def use(obs: Obs):
    """Activate an existing session for a scope (does NOT close it)."""
    _STACK.append(obs)
    _set_active(obs)
    try:
        yield obs
    finally:
        if _STACK and _STACK[-1] is obs:
            _STACK.pop()
        elif obs in _STACK:          # exception unwound past inner enables
            _STACK.remove(obs)
        _set_active(_STACK[-1] if _STACK else None)


@contextlib.contextmanager
def suspended():
    """Disable observability for a scope without closing any session."""
    global _STACK
    saved, _STACK = _STACK, []
    _set_active(None)
    try:
        yield
    finally:
        _STACK = saved
        _set_active(_STACK[-1] if _STACK else None)


def reset() -> None:
    """Close every active session (test teardown hygiene)."""
    while _STACK:
        disable()


# -- the disabled-fast-path module API --------------------------------------
def span(name: str, **attrs):
    o = _ACTIVE
    if o is None:
        return label(name)
    return o.span(name, **attrs)


def counter(name: str, value=1, **attrs) -> None:
    o = _ACTIVE
    if o is not None:
        o._metric("counter", name, value, attrs)


def gauge(name: str, value, **attrs) -> None:
    o = _ACTIVE
    if o is not None:
        o._metric("gauge", name, value, attrs)


def histogram(name: str, value, **attrs) -> None:
    o = _ACTIVE
    if o is not None:
        o._metric("hist", name, value, attrs)


def observe_program_call(name: str, fn, args, kwargs=None, *,
                         static=None, span: Optional[str] = None,
                         wire_bytes=None) -> None:
    """Cost-model capture hook for instrumented call sites: record that the
    named program is about to run with these arguments, the arguments the
    program itself is called with (a `repro_torch.graph.Program` keys its
    specializations on the same leaves: tensors by shape and dtype, Python
    scalars by type), and whether it is such a captured program (its
    cost record says so). Disabled sessions
    (and sessions with `costs=False`) cost one global load + early return;
    active capture is one dict probe per call (no execution)."""
    o = _ACTIVE
    if o is None:
        return
    o.observe_call(name, fn, args, kwargs, static=static, span=span,
                   wire_bytes=wire_bytes)


def traced(name: Optional[str] = None, **attrs):
    """Decorator form of `span`: times every call of the wrapped function
    under `name` (default: its qualname). Disabled sessions cost one global
    load per call."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            o = _ACTIVE
            if o is None:
                return fn(*args, **kwargs)
            with o.span(label, **attrs):
                return fn(*args, **kwargs)
        return wrapper
    return deco
