"""Append-only benchmark history (port of `repro.obs.history`): the perf
trajectory behind the sentinel.

A history file holds one flat record per (benchmark, metric) per run,
keyed by an environment fingerprint (python/torch/cuda/backend/device —
the things that make two timings comparable) and the git SHA that
produced it. A runner appends its payload after every run; the sentinel
(`repro_torch.obs.regress`) compares the current payload against the
trailing window of comparable history before anything is appended, so a
run is never its own baseline. No benchmark of the port calls these yet.

Record schema (HISTORY_SCHEMA_VERSION = 1):

  {"schema_version": 1, "benchmark": "fed", "metric": "seconds",
   "value": 1.23, "direction": "lower" | "higher" | null,
   "fingerprint": "ab12…", "git_sha": "…" | null, "git_dirty": bool|null,
   "tiny": bool, "ok": bool, "repeat_values": [..] | null,
   "payload_schema_version": 3, "blessed": bool}

`direction` is the regression sign: "lower" means smaller is better
(seconds), "higher" means larger is better (throughput headlines); null
metrics are recorded for trajectory but never gated. `blessed` marks an
intentional perf change: the sentinel only baselines records at or after
the most recent blessed one, so `--bless` resets the comparison window
without rewriting history. Loading tolerates a truncated final line
(crashed writer) and skips records from a FUTURE schema version — old
readers keep working when the schema grows.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from repro_torch.obs import sinks as sinks_lib

HISTORY_SCHEMA_VERSION = 1

# env keys that make two timings comparable: same interpreter, same torch
# and CUDA, same device story (the reference's jax/jaxlib become
# torch/cuda; the port has no forced-kernel switch). Deliberately excludes
# platform minutiae (hostname, exact kernel) so runners share a baseline.
_FINGERPRINT_KEYS = ("python", "torch", "cuda", "backend", "device_kind",
                     "device_count")

# metric name -> regression direction, for metrics every benchmark shares.
# Headline metrics ("headline.<key>") default to ungated (direction None)
# unless the payload record carries its own "directions" hint.
DEFAULT_DIRECTIONS = {"seconds": "lower"}


def env_fingerprint(env: dict, tiny: Optional[bool] = None) -> str:
    """Stable short hash of the comparability-relevant env fields (+ the
    --tiny flag: tiny and full sweeps must never share a baseline)."""
    basis = {k: env.get(k) for k in _FINGERPRINT_KEYS}
    if tiny is not None:
        basis["tiny"] = bool(tiny)
    blob = json.dumps(basis, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def records_from_payload(payload: dict) -> list[dict]:
    """Flatten a benchmark runner's JSON payload (schema v2 or v3 — v2
    simply lacks git_sha/git_dirty) into history records: one per
    (benchmark, metric). Metrics: "seconds" always; every numeric
    `headline.<key>`; numeric directions come from the benchmark record's
    optional "directions" {key: "lower"|"higher"} hint."""
    env = payload.get("env", {})
    tiny = bool(payload.get("tiny"))
    fp = env_fingerprint(env, tiny)
    out = []
    for rec in payload.get("benchmarks", []):
        name = rec.get("name")
        if not name:
            continue
        hints = rec.get("directions") or {}
        metrics: dict = {}
        if isinstance(rec.get("seconds"), (int, float)):
            metrics["seconds"] = float(rec["seconds"])
        headline = rec.get("headline")
        if isinstance(headline, dict):
            for key, value in headline.items():
                if (isinstance(value, (int, float))
                        and not isinstance(value, bool)):
                    metrics[f"headline.{key}"] = float(value)
        for metric, value in sorted(metrics.items()):
            short = metric.split(".", 1)[-1]
            direction = (hints.get(metric) or hints.get(short)
                         or DEFAULT_DIRECTIONS.get(metric))
            repeats = rec.get("repeat_seconds") if metric == "seconds" \
                else None
            out.append({
                "schema_version": HISTORY_SCHEMA_VERSION,
                "benchmark": name, "metric": metric, "value": value,
                "direction": direction, "fingerprint": fp,
                "git_sha": env.get("git_sha"),
                "git_dirty": env.get("git_dirty"),
                "tiny": tiny, "ok": bool(rec.get("ok")),
                "repeat_values": list(repeats) if repeats else None,
                "payload_schema_version": payload.get("schema_version"),
                "blessed": False,
            })
    return out


def append(path: str, records: list[dict]) -> int:
    """Append records to the history file (created on first use); returns
    how many were written."""
    if not records:
        return 0
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True,
                               separators=(",", ":")) + "\n")
    return len(records)


def load(path: str) -> sinks_lib.EventList:
    """Load history records in file (= chronological) order. Missing file →
    empty list; truncated final line → parsed prefix with
    `.truncated=True`; records from a future schema version or without the
    required keys are skipped (old reader, new writer)."""
    out = sinks_lib.EventList()
    if not os.path.exists(path):
        return out
    raw = sinks_lib.load_jsonl(path)
    out.truncated = raw.truncated
    for rec in raw:
        if not isinstance(rec, dict):
            continue
        if rec.get("schema_version", 0) > HISTORY_SCHEMA_VERSION:
            continue
        if "benchmark" in rec and "metric" in rec and "value" in rec:
            out.append(rec)
    return out
