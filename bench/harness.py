"""What every cell shares: finding a cell's files by name, the result line,
and the checks a run ends with.

A cell is an entry of `workloads` in BENCHMARK.json. It names a
configuration (`bench/configs/<config>.json`: the model's sizes as run,
and its training settings), a traffic mix (`bench/traffic/<traffic>.json`:
`mode` and the mix's parameters, read by the mode's generator in
`bench/<mode>.py`) and has `bench/workloads/<cell>.json` of its own: the
limits its correctness check holds each compared number to. A per-layer
metric is `bench/metrics/<metric>.py`: `LAYER`, `MOVES`, and
`read(trace)`, which returns the metric's value from a traced window
(`bench.tracing.Trace`) or None where it finds nothing to read. Adding a
configuration, a mix, a cell or a metric adds files and entries and edits
none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# top-level module names a run must not have loaded: the JAX package the
# port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """One run of a cell, as a mode's driver (`bench/<mode>.py`) takes it:
    `run(Run)` returns the pieces of the result line."""
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object                  # torch.device
    t_start: float                  # the process's start (perf_counter)
    fault: str | None = None        # tests: a broken timed path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of the checkout at `root`, with its configuration,
    traffic and limits loaded: {"name", "config", "traffic", "chips",
    "cfg", "mix", "limits", "end_to_end", "per_layer"} (the metric
    entries it reports)."""
    benchmark = spec(root)
    found = [w for w in benchmark["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    bench = root / "bench"
    w["cfg"] = load_json(bench / "configs" / f"{w['config']}.json")
    w["mix"] = load_json(bench / "traffic" / f"{w['traffic']}.json")
    w["limits"] = load_json(bench / "workloads" / f"{name}.json")["limits"]

    def reports(metric):
        return name in metric.get("workloads", [name])

    w["end_to_end"] = [m for m in benchmark["end_to_end"] if reports(m)]
    w["per_layer"] = [m for m in benchmark["per_layer"] if reports(m)]
    return w


def metric_reader(name: str, root: Path = ROOT):
    """The module of per-layer metric `name` (`bench/metrics/<name>.py`),
    loaded by path: a metric's name may hold a dot."""
    path = root / "bench" / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    found = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one a run must not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def judge(gaps: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit; a number
    that is not finite fails."""
    checks = {}
    ok = True
    for key, limit in limits.items():
        value = gaps[key]
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        checks[key] = {"value": value, "limit": limit}
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None
                ) -> str:
    """The run's last line of standard output, `checks` its last key."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def print_checks(checks: dict) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
