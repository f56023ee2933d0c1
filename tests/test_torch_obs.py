"""repro_torch.obs against repro.obs on the CPU.

Units (ports of tests/test_obs.py, test_obs_costs.py and
test_obs_history.py without the JAX-only parts): the disabled path, the
session stack, sinks, the Chrome trace, the profiler passthrough, the
program registry, the cost capture (the kernels' analytic bytes and
operations, every other program unavailable with its reason), and
`history` / `regress` fed the same inputs as the reference's, giving equal
records (but for the environment fingerprint, whose keys differ by design)
and equal verdicts.

Workloads, each run once per module under both packages: a federation
(vmap; tests/test_obs_bitexact.py's problem, m 4, dim 24), two `dist.step`
steps of the reduced yi-6b, and `serve.Engine` on the reduced yi-6b with a
prefix and the 8-bit KV cache (so its kernels dispatch). The port's runs
with obs on are bitwise its runs with obs off. Against the reference's runs: the ordered (type, name, attribute keys) of
every event but the kernels' is equal, the integer counters are equal in
value, the kernels' (name, attribute keys) are equal as a set, and the
programs registered are the same names. Events are compared up to the
session's close (the gauges `close` derives from the cost model differ by
design: eager torch has no compiler cost analysis). The serve
programs' specializations equal the reference's for the same workload
(they are captured programs); the fed and dist programs count none, as
they still run eagerly. `kernels.dispatch`
counts every launch in the port; here, on the CPU, it is held against the
calls of each public `kernels.ops` function, and on the card (chip_smoke
phase 14) against `ops.launch_counts()`.
"""
import collections
import copy
import dataclasses
import gc
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import fed as jfed
from repro.dist import step as jstep
from repro.dist.gradcomp import GradCompConfig as JGradCompConfig
from repro.fed import server as jserver
from repro.models import model as jmodel
from repro.obs import core as jobs
from repro.obs import history as jhistory
from repro.obs import recompile as jrecompile
from repro.obs import regress as jregress
from repro.optimizer import optim as joptim
from repro.serve import engine as jengine
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import fed as tfed
from repro_torch import obs as tobs
from repro_torch import tree as tree_lib
from repro_torch.dist import step as tstep
from repro_torch.dist.gradcomp import GradCompConfig
from repro_torch.fed import mesh as tmesh
from repro_torch.fed import server as tserver
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.obs import core as obs
from repro_torch.obs import costs, history, recompile, regress, report
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.sinks import EventList, MemorySink, load_jsonl
from repro_torch.optimizer import optim as toptim
from repro_torch.serve import engine as tengine


@pytest.fixture(autouse=True)
def _port_obs_isolation():
    yield
    obs.reset()


# ---------------------------------------------------------------------------
# disabled path, sessions, sinks, summary
# ---------------------------------------------------------------------------
def test_public_names_match_the_reference():
    import repro.obs as jpkg
    assert sorted(tobs.__all__) == sorted(jpkg.__all__)


def test_disabled_is_noop():
    assert not obs.enabled() and obs.get() is None
    assert obs.span("x") is obs.NOOP_SPAN
    with obs.span("x", k=1):
        pass
    obs.counter("c", 1, k=2)
    obs.gauge("g", 3.0)
    obs.histogram("h", 0.5)
    obs.observe_program_call("p", lambda x: x, (torch.ones(4),))


def test_traced_decorator_passthrough_when_disabled():
    calls = []

    @obs.traced("my.fn", tag="t")
    def fn(a, b=2):
        calls.append((a, b))
        return a + b

    assert fn(1, b=3) == 4
    o = obs.enable()
    assert fn(5) == 7
    obs.disable()
    assert calls == [(1, 3), (5, 2)]
    spans = [e for e in o.memory_events() if e["type"] == "span"]
    assert [s["name"] for s in spans] == ["my.fn"]
    assert spans[0]["attrs"] == {"tag": "t"}


def test_enable_disable_stack_use_and_suspended():
    o1 = obs.enable()
    o2 = obs.enable()
    assert obs.get() is o2
    obs.counter("inner", 1)
    obs.disable()
    assert obs.get() is o1
    obs.counter("outer", 1)
    obs.disable()
    assert not obs.enabled()
    assert [e["name"] for e in o2.memory_events()
            if e["type"] == "counter"] == ["inner"]
    assert [e["name"] for e in o1.memory_events()
            if e["type"] == "counter"] == ["outer"]
    session = obs.Obs(sinks=(MemorySink(),))
    with obs.use(session):
        obs.counter("a", 1)
        with obs.suspended():
            assert not obs.enabled()
            obs.counter("ghost", 1)
        obs.counter("b", 1)
    assert not obs.enabled()
    assert [e["name"] for e in session.memory_events()] == ["a", "b"]
    session.close()


def test_span_nesting_depth_and_duration():
    o = obs.enable()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    obs.disable()
    spans = {e["name"]: e for e in o.memory_events() if e["type"] == "span"}
    assert spans["inner"]["depth"] == 2 and spans["outer"]["depth"] == 1
    assert spans["outer"]["dur"] >= spans["inner"]["dur"] >= 0.0
    assert spans["outer"]["tid"] == threading.get_ident() & 0x7FFFFFFF


def test_jsonl_sink_roundtrip(tmp_path):
    path = str(tmp_path / "sub" / "events.jsonl")
    obs.enable(jsonl=path)
    obs.counter("c", 2, op="fwht")
    with obs.span("s", k=1):
        pass
    obs.disable()
    events = load_jsonl(path)
    assert [e["type"] for e in events] == ["counter", "span", "meta"]
    assert events[0]["value"] == 2.0 and events[0]["attrs"]["op"] == "fwht"
    assert events[-1]["name"] == "obs.summary"


def test_summary_aggregates_survives_disable_and_is_sorted():
    o = obs.enable()
    for v in (1.0, 3.0):
        obs.counter("c", v)
        obs.histogram("h", v)
    for v in range(101):
        obs.histogram("lat", float(v))
    for name in ("zeta", "alpha"):
        obs.gauge("g." + name, 7.0)
        with obs.span("s." + name):
            pass
    obs.disable()
    s = o.summary()
    assert s["counters"]["c"] == {"total": 4.0, "count": 2}
    assert s["hists"]["h"]["count"] == 2 and s["hists"]["h"]["max"] == 3.0
    assert (s["hists"]["lat"]["p50"], s["hists"]["lat"]["p95"],
            s["hists"]["lat"]["p99"]) == (50.0, 95.0, 99.0)
    assert s["gauges"]["g.zeta"]["last"] == 7.0
    assert s is o.summary()
    for table in ("counters", "gauges", "hists", "spans", "recompiles"):
        assert list(s[table]) == sorted(s[table])
    assert "s.alpha" in report.render(s)


def _write_events(path, n=3):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"type": "counter", "name": f"c{i}",
                                "ts": float(i), "value": 1.0}) + "\n")


@pytest.mark.parametrize("tail,truncated,raises", [
    ("", False, False),
    ('{"type": "counter", "name": "c3", "ts": 3.0, "val', True, False),
    ('{"broken": \n{"type": "counter", "name": "after"}\n', None, True),
], ids=["intact", "torn-last-line", "mid-file-corruption"])
def test_load_jsonl_truncation_rules(tmp_path, tail, truncated, raises):
    path = str(tmp_path / "e.jsonl")
    _write_events(path)
    with open(path, "a") as f:
        f.write(tail)
    if raises:
        with pytest.raises(json.JSONDecodeError):
            load_jsonl(path)
        return
    events = load_jsonl(path)
    assert isinstance(events, EventList) and events.truncated is truncated
    assert [e["name"] for e in events] == ["c0", "c1", "c2"]
    if truncated:
        with pytest.raises(json.JSONDecodeError):
            load_jsonl(path, strict=True)


def test_chrome_trace_is_valid_with_interleaved_spans(tmp_path):
    path = str(tmp_path / "trace.json")
    o = obs.enable(trace=path)
    with obs.span("outer", k=1):
        a, b = o.span("stream.a"), o.span("stream.b")
        a.__enter__()
        b.__enter__()
        for i in range(4):
            obs.counter("track.bytes", 128 * (i + 1))
            obs.gauge("track.depth", i)
        a.__exit__(None, None, None)
        b.__exit__(None, None, None)
    obs.disable()
    n = trace_lib.validate_trace(path)
    doc = json.load(open(path))
    assert n == len(doc["traceEvents"])
    assert {"M", "X", "C"} <= {e["ph"] for e in doc["traceEvents"]}
    assert {"outer", "stream.a", "stream.b"} <= {
        e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    tracks = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e["ph"] == "C":
            tracks[e["name"]].append(e["ts"])
    assert len(tracks["track.bytes"]) == 4
    assert all(ts == sorted(ts) for ts in tracks.values())


def test_validate_trace_rejects_malformed():
    with pytest.raises(ValueError, match="bad phase"):
        trace_lib.validate_trace([{"ph": "Z", "name": "x"}])
    with pytest.raises(ValueError, match="dur"):
        trace_lib.validate_trace(
            [{"ph": "X", "name": "x", "ts": 0.0, "pid": 0}])
    with pytest.raises(ValueError, match="traceEvents"):
        trace_lib.validate_trace({})


def test_profiler_unavailable_is_recorded_not_raised(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no profiler build")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    o = obs.enable(profiler_trace_dir=str(tmp_path / "prof"))
    obs.counter("still.works", 1)
    obs.disable()
    s = o.summary()
    assert s["profiler_trace"]["active"] is False
    assert "no profiler build" in s["profiler_trace"]["error"]
    assert s["counters"]["still.works"]["total"] == 1.0
    assert "jax_trace" not in s


# ---------------------------------------------------------------------------
# the program registry
# ---------------------------------------------------------------------------
class _Program:
    """A callable that exposes `_cache_size()`, as a graph-capturing
    program will."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x):
        self.shapes.add(tuple(x.shape))
        return x * 2

    def _cache_size(self):
        return len(self.shapes)


def test_recompile_registry_counts_delta_and_eager_programs():
    fn = recompile.register("t.obs.toy", _Program())
    eager = recompile.register("t.obs.eager", lambda x: x)
    assert recompile.cache_size(eager) is None
    before = recompile.counts()
    fn(torch.ones(4))
    fn(torch.ones(8))
    fn(torch.ones(8))
    after = recompile.counts()
    assert recompile.delta(before, after) == {"t.obs.toy": 2}
    assert after["t.obs.eager"] == 0


def test_recompile_counts_survive_gc():
    o = obs.enable()
    fn = recompile.register("t.obs.dying", _Program())
    fn(torch.ones(4))
    del fn
    gc.collect()
    obs.disable()
    assert o.summary()["recompiles"]["t.obs.dying"] == 1


# ---------------------------------------------------------------------------
# kernels.ops hooks
# ---------------------------------------------------------------------------
def test_kernel_dispatch_counter_and_analytic_cost():
    o = obs.enable()
    ops.encode(torch.ones(2, 64), torch.ones(64), 4)
    ops.fwht(torch.ones(3, 128))
    obs.disable()
    events = [e for e in o.memory_events() if e["name"] == "kernels.dispatch"]
    assert [e["attrs"] for e in events] == [
        {"op": "encode", "path": "ref", "n": 64, "forced": False},
        {"op": "fwht", "path": "ref", "n": 128, "forced": False}]
    progs = o.costs()["programs"]
    spec = progs["kernels.encode.ref"]["specializations"][0]
    assert "static=('bits', 4)" in spec["sig"]
    assert spec["available"] and spec["source"] == "analytic"
    assert (spec["bytes_accessed"], spec["flops"]) == kcost.encode(
        128, 2, 64, 4)
    assert progs["kernels.fwht.ref"]["bytes_total"] == 3 * 128 * 8


def test_refused_cuda_kernel_counts_forced_error_and_raises(monkeypatch):
    def refuse(x):
        raise ValueError("CUDA FWHT needs a power-of-2 N, got 3")

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "fwht_cuda", refuse)
    o = obs.enable()
    with pytest.raises(ValueError, match="power-of-2"):
        ops.fwht(torch.ones(1, 3))
    obs.disable()
    names = [e["name"] for e in o.memory_events() if e["type"] == "counter"]
    assert names == ["kernels.forced_error"]
    assert o.memory_events()[0]["attrs"] == {"op": "fwht", "n": 3}


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
def test_capture_dedupes_keys_scalars_by_type_and_static_by_tag():
    store = {}
    x, y = torch.ones(8, 8), torch.ones(16, 16)
    for i in range(3):
        costs.record_call(store, "t.toy", None, (x, i), wire_bytes=10.0)
    costs.record_call(store, "t.toy", None, (y, 0))
    for bits in (1, 4):
        costs.record_call(store, "t.bits", None, (x,), static=("bits", bits))
    assert len(store) == 4
    rec = next(r for r in store.values()
               if r["name"] == "t.toy" and r["args"][0].shape == (8, 8))
    assert rec["calls"] == 3 and rec["wire_bytes"] == 30.0
    assert isinstance(rec["args"][0], costs.TensorSpec)


@pytest.mark.parametrize("compile_ok", [False, True])
def test_eager_program_degrades_with_reason(compile_ok):
    store = {}
    costs.record_call(store, "fed.round.cohort", lambda *a: None,
                      ({"x": torch.ones(4)}, 3))
    snap = costs.snapshot(store, compile_ok=compile_ok)
    prog = snap["programs"]["fed.round.cohort"]
    spec = prog["specializations"][0]
    assert spec["available"] is False and spec["reason"] == costs.EAGER_REASON
    assert spec["argument_bytes"] == 16.0 and prog["cost_coverage"] == 0.0


def test_peaks_h100_row_and_env_override(monkeypatch):
    pk = costs.peaks(backend="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert pk["source"] == "device_table"
    assert (pk["flops_per_s"], pk["bytes_per_s"]) == (67e12, 3.35e12)
    assert costs.peaks(backend="cpu", device_kind=None)["source"] == \
        "backend_default"
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("REPRO_PEAK_BYTES", "1e11")
    pk = costs.peaks()
    assert (pk["flops_per_s"], pk["bytes_per_s"], pk["source"]) == (
        2e12, 1e11, "env")


def test_attach_attrib_roofline_math_and_skips():
    summary = {"spans": {"work": {"count": 1, "total_s": 2.0},
                         "lonely": {"count": 1, "total_s": 1.0}}}
    snap = {"peaks": {"flops_per_s": 100.0, "bytes_per_s": 10.0},
            "programs": {"prog": {"span": "work", "calls": 4,
                                  "wire_bytes": 40.0, "flops_total": 100.0,
                                  "bytes_total": 5.0, "cost_coverage": 1.0,
                                  "specializations": []}}}
    costs.attach_attrib(summary, snap)
    at = summary["spans"]["work"]["attrib"]
    assert (at["t_flops_s"], at["t_bytes_s"], at["t_model_s"]) == (
        1.0, 0.5, 1.0)
    assert at["bound"] == "flops" and at["roofline_frac"] == 0.5
    assert at["wire_min_bytes_per_s"] == 20.0
    assert at["flops_per_s_achieved"] == 50.0
    assert "attrib" not in summary["spans"]["lonely"]


def test_session_costs_attrib_and_costs_off():
    o = obs.enable()
    with obs.span("t.work"):
        obs.observe_program_call("kernels.fwht.ref", None,
                                 (torch.ones(4, 256),), span="t.work",
                                 wire_bytes=64.0)
    obs.disable()
    s = o.summary()
    prog = s["costs"]["programs"]["kernels.fwht.ref"]
    assert prog["calls"] == 1 and prog["wire_bytes"] == 64.0
    at = s["spans"]["t.work"]["attrib"]
    assert at["roofline_frac"] is not None and at["cost_coverage"] == 1.0
    assert "attrib (roofline)" in report.render(s)
    assert "attrib.t.work.roofline_frac" in {
        e["name"] for e in o.memory_events() if e["type"] == "gauge"}
    o = obs.enable(costs=False)
    obs.observe_program_call("kernels.fwht.ref", None, (torch.ones(4),))
    obs.disable()
    assert "costs" not in o.summary() and o._cost_captures == {}


@pytest.mark.parametrize("bad", [object(), {"weird": object(), 3: 1}])
def test_capture_never_raises_from_odd_args(bad):
    o = obs.enable()
    o.observe_call("t.odd", lambda x: x, (bad,))
    obs.disable()


# ---------------------------------------------------------------------------
# history and the sentinel: the same inputs as the reference's
# ---------------------------------------------------------------------------
def _payload(seconds=1.0, *, tput=None, repeat=None, ok=True,
             directions=None):
    rec = {"name": "fed", "ok": ok, "seconds": seconds,
           "headline": {"rate_bits": 4.0, "note": "text", "flag": True},
           "repeat_seconds": repeat, "directions": directions}
    if tput is not None:
        rec["headline"]["tput"] = tput
    return {"schema_version": 3, "tiny": True,
            "env": {"python": "3.12.3", "jax": "0.9.0", "jaxlib": "0.9.0",
                    "torch": "2.11.0", "cuda": "12.8", "backend": "gpu",
                    "device_kind": "NVIDIA H100 80GB HBM3",
                    "device_count": 1, "git_sha": "abc123",
                    "git_dirty": False},
            "failed": [] if ok else ["fed"], "benchmarks": [rec]}


def _unfingerprinted(recs):
    return [{k: v for k, v in r.items() if k != "fingerprint"}
            for r in recs]


def test_history_records_equal_the_reference_but_the_fingerprint():
    p = _payload(1.5, tput=3.0, repeat=[1.4, 1.5, 1.6],
                 directions={"tput": "higher"})
    ours, theirs = (history.records_from_payload(p),
                    jhistory.records_from_payload(p))
    assert _unfingerprinted(ours) == _unfingerprinted(theirs)
    env = p["env"]
    base = history.env_fingerprint(env, tiny=True)
    assert history.env_fingerprint(dict(env, torch="2.12"), True) != base
    assert history.env_fingerprint(dict(env, cuda="13.0"), True) != base
    assert history.env_fingerprint(dict(env, jax="0.10"), True) == base


def test_history_files_load_as_the_reference_loads_them(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    assert history.load(path) == [] == jhistory.load(path)
    rows = [r for v in (1.0, 1.1)
            for r in history.records_from_payload(_payload(v))]
    assert history.append(path, rows) == len(rows)
    with open(path, "a") as f:
        f.write(json.dumps({"schema_version": 99, "benchmark": "fed",
                            "metric": "seconds", "value": 9.9}) + "\n")
        f.write(json.dumps(["not", "a", "dict"]) + "\n")
        f.write('{"schema_version": 1, "benchmark": "fed", "metr')
    ours, theirs = history.load(path), jhistory.load(path)
    assert ours == theirs and ours.truncated is theirs.truncated is True
    assert [r["value"] for r in ours if r["metric"] == "seconds"] == [1.0,
                                                                      1.1]


_SENTINEL_CASES = {
    "2x-slowdown": ([1.0, 0.98, 1.02, 1.01, 0.99], {}, {"seconds": 2.0}),
    "small-drift": ([1.0, 0.98, 1.02, 1.01, 0.99], {}, {"seconds": 1.05}),
    "higher-drop": ([1.0] * 4, {"tput": 100.0, "directions": {
        "tput": "higher"}}, {"seconds": 1.0, "tput": 40.0,
                             "directions": {"tput": "higher"}}),
    "noise-floor": ([1.0] * 4, {}, {"seconds": 1.5,
                                    "repeat": [0.7, 1.5, 2.2]}),
    "calm-repeats": ([1.0] * 4, {}, {"seconds": 1.5,
                                     "repeat": [1.49, 1.5, 1.51]}),
    "thin-history": ([1.0, 1.0], {}, {"seconds": 9.0}),
    "failed-run": ([1.0] * 5, {}, {"seconds": 9.0, "ok": False}),
    "blessed": ([1.0] * 5 + [2.0] * 3, {}, {"seconds": 2.0}),
}


@pytest.mark.parametrize("case", sorted(_SENTINEL_CASES))
def test_sentinel_verdicts_equal_the_reference(case):
    values, hist_kw, cur_kw = _SENTINEL_CASES[case]
    results = []
    for hist_lib, reg in ((history, regress), (jhistory, jregress)):
        rows = [r for v in values
                for r in hist_lib.records_from_payload(_payload(v, **hist_kw))]
        if case == "blessed":
            rows = copy.deepcopy(rows)
            for r in rows[10:12]:         # the first slow run's 2 records
                r["blessed"] = True
        cur = hist_lib.records_from_payload(_payload(**cur_kw))
        res = reg.check(rows, cur)
        worst = reg.worst(res)
        results.append((
            [{k: v for k, v in f.items() if k != "fingerprint"}
             for f in res["findings"]], res["checked"], res["skipped"],
            reg.render(res), worst and worst["metric"]))
    assert results[0] == results[1]
    assert regress.trimmed_mean([1.0, 1.0, 1.0, 1.0, 50.0]) == 1.0


# ---------------------------------------------------------------------------
# workloads under both packages
# ---------------------------------------------------------------------------
# the reference's extra specialization on a train step's first call
FIRST_CALL_PLACEMENT = {"dist.step": 1}
PUBLIC_OPS = ("fwht", "quantize_pack", "unpack_dequant", "encode",
              "encode_ef", "quant_decode_attention", "sum_squares",
              "adamw_update", "sgd_update")
INT_COUNTERS = ("fed.rounds", "fed.wire_bytes", "fed.analytic_bytes",
                "fed.stragglers", "fed.reallocs", "dist.payload_bytes",
                "serve.tokens", "serve.submitted", "serve.prefix.hit",
                "serve.prefix.miss")


def _fed_problem(m=4, dim=24, n=16, seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, n, dim)) / np.sqrt(n)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    return [{"a": a[i], "b": (a[i] @ x_true).astype(np.float32)}
            for i in range(m)]


def _fed_run(pkg):
    port = pkg == "port"
    fed, codecs_ = (tfed, tcodecs) if port else (jfed, jcodecs)
    shards = _fed_problem()
    if port:
        def loss_fn(p, batch):
            r = batch["a"] @ p["x"] - batch["b"]
            return 0.5 * torch.mean(r * r)
        data = [tree_lib.map(torch.from_numpy, s) for s in shards]
        params, kw = {"x": torch.zeros(24)}, {"device": "cpu"}
    else:
        def loss_fn(p, batch):
            r = batch["a"] @ p["x"] - batch["b"]
            return 0.5 * jnp.mean(r * r)
        data = [tree_lib.map(jnp.asarray, s) for s in shards]
        params, kw = {"x": jnp.zeros(24)}, {}
    f = fed.Federation(loss_fn, params, data,
                       codecs_.make("ndsc", 4.0, chunk=32),
                       fed.ClientConfig(local_steps=2, lr=0.2),
                       fed.ServerConfig(aggregator="fedavg"), seed=5, **kw)
    hist = f.run(fed.FedConfig(num_rounds=4, participation=0.9, dropout=0.2,
                               seed=11))
    return {"hist": hist, "params": f.server.params,
            "ef": [s.ef for s in f.states]}


_TOKENS = np.random.default_rng(7).integers(0, 256, (2, 17)).astype(np.int32)


def _dist_run(pkg):
    if pkg == "port":
        cfg = tconfigs.get_reduced("yi-6b")
        gc_ = GradCompConfig(bits=4, chunk=256, strategy="allgather_packed")
        opt = toptim.sgd(1e-2, momentum=0.9)
        fn = tstep.make_train_step(cfg, opt, gc_)
        p, o, ef = tstep.init_train_state(cfg, opt, gc_, device="cpu")
        batch = {"tokens": torch.from_numpy(_TOKENS)}
    else:
        from repro.launch.mesh import make_host_mesh
        cfg = jconfigs.get_reduced("yi-6b")
        gc_ = JGradCompConfig(bits=4, chunk=256, strategy="allgather_packed")
        opt = joptim.sgd(1e-2, momentum=0.9)
        mesh = make_host_mesh(data=1, model=1)
        fn = jstep.make_train_step(cfg, opt, gc_, mesh)
        p, o, ef = jstep.init_train_state(cfg, opt, gc_, mesh)
        batch = {"tokens": jnp.asarray(_TOKENS)}
    losses = []
    for _ in range(2):
        p, o, ef, metrics = fn(p, o, ef, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": p, "ef": ef, "program": fn}


def _serve_run(pkg):
    prefix = np.arange(9, dtype=np.int32) + 2
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(4)]
    if pkg == "port":
        from repro_torch.serve import Engine, Request, ServeConfig
        cfg = dataclasses.replace(tconfigs.get_reduced("yi-6b"),
                                  kv_quant_bits=8)
        params = tmodel.init_params(0, cfg, "cpu")
        eng = Engine(cfg, params, ServeConfig(slots=2, max_seq=48),
                     device="cpu")
    else:
        from repro.serve import Engine, Request, ServeConfig
        cfg = dataclasses.replace(jconfigs.get_reduced("yi-6b"),
                                  kv_quant_bits=8)
        params = jmodel.init_params(jax.random.key(0), cfg)
        eng = Engine(cfg, params, ServeConfig(slots=2, max_seq=48))
        prompts = [jnp.asarray(p) for p in prompts]
    eng.register_prefix("sys", prefix, prefill=True)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4,
                           prefix_id="sys" if i % 2 else None))
    finished = eng.run_to_completion()
    return {"out": [(r.rid, r.admission, r.tokens_out) for r in finished],
            "state": (eng.state.caches, eng.state.pos)}


WORKLOADS = {"fed": _fed_run, "dist": _dist_run, "serve": _serve_run}


def _observed(pkg, workload):
    """Run `workload` under a fresh session of `pkg`'s obs: (result,
    events up to the close, names registered during the run). The
    process-wide program caches are cleared first, so each package
    registers (and the reference traces) the run's programs anew."""
    if pkg == "port":
        core, rec = obs, recompile
        for cached in (tserver._stacked_mean_fn, tserver._stacked_memory_fn,
                       tmesh._mesh_mean_fn, tengine._programs):
            cached.cache_clear()
    else:
        core, rec = jobs, jrecompile
        for cached in (jserver._stacked_mean_fn, jserver._stacked_memory_fn,
                       jengine._compiled):
            cached.cache_clear()
    names = []
    cb = lambda name, fn: names.append(name)   # noqa: E731
    rec.add_callback(cb)
    session = core.enable(costs=pkg == "port")
    try:
        result = WORKLOADS[workload](pkg)
        events = list(session.memory_events())
    finally:
        core.disable()
        rec.remove_callback(cb)
    return result, events, set(names), session


@pytest.fixture(scope="module")
def runs():
    """Each workload: the reference under its obs; the port with obs off,
    then on, with every public ops call counted."""
    out = {}
    for workload in WORKLOADS:
        ref = _observed("reference", workload)
        off = WORKLOADS[workload]("port")
        calls = collections.Counter()
        with pytest.MonkeyPatch.context() as mp:
            for name in PUBLIC_OPS:
                fn = getattr(ops, name)

                def counting(*a, _fn=fn, _name=name, **k):
                    calls[_name] += 1
                    return _fn(*a, **k)

                mp.setattr(ops, name, counting)
            on = _observed("port", workload)
        out[workload] = {"ref": ref, "off": off, "on": on, "calls": calls}
    return out


def _bitwise(a, b) -> bool:
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_obs_leaves_results_bitwise(runs, workload):
    off, on = runs[workload]["off"], runs[workload]["on"][0]
    if workload == "fed":
        assert on["hist"] == off["hist"]
        assert _bitwise(on["params"], off["params"])
        assert _bitwise(on["ef"], off["ef"])
    elif workload == "dist":
        assert on["losses"] == off["losses"]
        assert _bitwise(on["params"], off["params"])
        assert _bitwise(on["ef"], off["ef"])
    else:
        assert on["out"] == off["out"]
        assert _bitwise(on["state"], off["state"])


def _schema(e) -> tuple:
    keys = e.get("data") if e["type"] == "meta" else e.get("attrs")
    return (e["type"], e["name"], tuple(sorted(keys or {})))


# the model's counters of attention block pairs and MoE capacity, which
# the reference has not (a departure `repro_torch.obs` names)
PORT_ONLY = ("attn.", "moe.")


def _split(events):
    kernels = [e for e in events if e["name"].startswith("kernels.")]
    return [e for e in events
            if not e["name"].startswith(("kernels.",) + PORT_ONLY)], kernels


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_event_sequence_equals_the_reference(runs, workload):
    ref_events, port_events = runs[workload]["ref"][1], runs[workload]["on"][1]
    ours, theirs = _split(port_events)[0], _split(ref_events)[0]
    assert [_schema(e) for e in ours] == [_schema(e) for e in theirs]
    assert ours, "the workload emitted nothing"
    assert not [e for e in ref_events if e["name"].startswith(PORT_ONLY)]
    if workload != "fed":       # the model's forward counts its pairs
        assert {e["name"] for e in port_events} >= {
            "attn.full.pairs_computed", "attn.full.pairs_skipped"}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_integer_counters_equal_the_reference(runs, workload):
    def totals(events):
        t = collections.Counter()
        for e in events:
            if e["type"] == "counter" and e["name"] in INT_COUNTERS:
                t[e["name"]] += e["value"]
        return t

    ours = totals(runs[workload]["on"][1])
    assert ours and ours == totals(runs[workload]["ref"][1])


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_kernel_events_equal_the_reference_and_count_every_call(runs,
                                                                workload):
    ours = _split(runs[workload]["on"][1])[1]
    theirs = _split(runs[workload]["ref"][1])[1]
    assert {(e["name"], tuple(sorted(e["attrs"]))) for e in ours} == {
        (e["name"], tuple(sorted(e["attrs"]))) for e in theirs}
    per_op = collections.Counter(e["attrs"]["op"] for e in ours
                                 if e["name"] == "kernels.dispatch")
    assert per_op and per_op == +runs[workload]["calls"]
    assert {e["attrs"]["path"] for e in ours} == {"ref"}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_registered_programs_equal_the_reference(runs, workload):
    ours, theirs = runs[workload]["on"][2], runs[workload]["ref"][2]
    assert ours and ours == theirs
    # the serve, fed and dist programs are captured (repro_torch.graph)
    # and count the reference's specializations for the same workload,
    # but for the train step's first call, which the reference compiles
    # once more: init_train_state spells the state's placement
    # P(None, ...), the step returns it as P() (ROADMAP §3)
    session = runs[workload]["on"][3]
    got = session.summary()["recompiles"]
    want = runs[workload]["ref"][3].summary()["recompiles"]
    assert {name: got.get(name, 0) for name in ours} == {
        name: want.get(name, 0) - FIRST_CALL_PLACEMENT.get(name, 0)
        for name in ours}
    assert any(got.get(name) for name in ours)
    programs = session.costs()["programs"]
    for name, prog in programs.items():
        available = {s["available"] for s in prog["specializations"]}
        assert available == {name.startswith("kernels.")}, name
