"""repro_torch.obs — zero-overhead-when-disabled telemetry (port of
`repro.obs`, the same public names, event schema and summary).

Spans (context manager + decorator on monotonic `perf_counter`), typed
counters/gauges/histograms, a JSONL event sink + an in-memory sink, a
Chrome/Perfetto trace exporter (open `trace.json` in ui.perfetto.dev), an
optional `torch.profiler` passthrough, a program registry under the
reference's names (`recompile`), and a cost model (`costs`) that gives
the kernels' dispatches their analytic bytes and operations.

    from repro_torch import obs

    session = obs.enable(jsonl="events.jsonl", trace="trace.json")
    with obs.span("fed.round", round=0):
        obs.counter("fed.wire_bytes", 1234)
    obs.disable()                       # flushes JSONL, writes trace.json
    print(obs.report.render(session.summary()))

Disabled (the default), every instrumentation call is a global load + an
early return. The instrumented layers (`fed.rounds`, `fed.server`,
`fed.mesh`, `dist.step`, `kernels.ops`, `serve.engine`,
`serve.prefixcache`) emit the reference's span, counter and program names
with its attribute keys, so one report reads either package. Four
departures from the reference: `kernels.dispatch` counts every launch
(eager dispatch; the reference counts once per trace); the summary's
`jax_trace` block is `profiler_trace`; costs exist only for the
kernels (eager torch has no compiler cost analysis); and the model
counts what the reference does not, each attention call's block pairs
computed and skipped (`attn.<kind>.pairs_computed`, `.pairs_skipped`)
and each routing's capacity (`moe.capacity`, `moe.slots`).
"""
from repro_torch.obs import (costs, history, recompile, regress, report,
                             sinks, trace)
from repro_torch.obs.core import (NOOP_SPAN, Obs, Span, counter, disable,
                                  enable, enabled, gauge, get, histogram,
                                  observe_program_call, reset, span,
                                  suspended, traced, use)
from repro_torch.obs.sinks import EventList, JsonlSink, MemorySink, load_jsonl
from repro_torch.obs.trace import ChromeTraceSink, build_trace, validate_trace

__all__ = [
    "ChromeTraceSink", "EventList", "JsonlSink", "MemorySink", "NOOP_SPAN",
    "Obs", "Span", "build_trace", "costs", "counter", "disable", "enable",
    "enabled", "gauge", "get", "histogram", "history", "load_jsonl",
    "observe_program_call", "recompile", "regress", "report", "reset",
    "sinks", "span", "suspended", "trace", "traced", "use",
    "validate_trace",
]
