"""Regression sentinel (port of `repro.obs.regress`): gate current
benchmark numbers against history.

`check()` compares each current record (from
`history.records_from_payload`) against the trailing window of COMPARABLE
history — same benchmark, same metric, same env fingerprint, same
direction, `ok` runs only, truncated at the most recent blessed record
(how an intentional perf change resets its baseline). The baseline is a
trimmed mean over that window, so one historical outlier can't poison the
gate; the tolerance is a relative threshold plus a noise floor of
`noise_sigmas`× the within-run repeat standard deviation, so benchmarks
too noisy to measure never alarm on noise alone. Direction-aware: a
"lower"-is-better metric regresses only above `baseline * (1 + rel)`, a
"higher"-is-better one only below `baseline * (1 - rel)`; direction-less
metrics are recorded in history but never gated.

The reference exposes it as `python -m benchmarks.run
--check-regressions`; no benchmark of the port calls it yet.
"""
from __future__ import annotations

import math
from typing import Optional


def trimmed_mean(values, trim: float = 0.2) -> float:
    """Mean with `trim` fraction dropped from EACH end (rounded down, and
    only once there are enough samples that trimming leaves some)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("trimmed_mean of no values")
    k = int(len(vals) * trim)
    if len(vals) - 2 * k >= 1:
        vals = vals[k:len(vals) - k] if k else vals
    return sum(vals) / len(vals)


def _stdev(values) -> float:
    vals = [float(v) for v in values]
    if len(vals) < 2:
        return 0.0
    mean = sum(vals) / len(vals)
    return math.sqrt(sum((v - mean) ** 2 for v in vals) / (len(vals) - 1))


def _comparable(history, cur) -> list:
    """History rows this record can be judged against, oldest first,
    restarted at the most recent blessed row."""
    rows = [h for h in history
            if h.get("benchmark") == cur.get("benchmark")
            and h.get("metric") == cur.get("metric")
            and h.get("fingerprint") == cur.get("fingerprint")
            and h.get("direction") == cur.get("direction")
            and h.get("ok", True)]
    for i in range(len(rows) - 1, -1, -1):
        if rows[i].get("blessed"):
            return rows[i:]
    return rows


def check(history, current, *, window: int = 8, rel_threshold: float = 0.35,
          min_baseline: int = 3, noise_sigmas: float = 3.0,
          trim: float = 0.2) -> dict:
    """Gate `current` records against `history`.

    Returns {"findings": [...], "checked": n, "skipped": [(key, why)]}.
    A finding means: the current value is past the relative threshold AND
    past the repeat-noise floor, against the trimmed mean of the last
    `window` comparable runs (needing at least `min_baseline` of them —
    young histories never alarm).
    """
    findings = []
    skipped = []
    checked = 0
    for cur in current:
        key = f"{cur.get('benchmark')}/{cur.get('metric')}"
        direction = cur.get("direction")
        if direction not in ("lower", "higher"):
            skipped.append((key, "no direction (recorded, not gated)"))
            continue
        if not cur.get("ok", True):
            skipped.append((key, "benchmark failed (gated by CI already)"))
            continue
        base_rows = _comparable(history, cur)[-window:]
        if len(base_rows) < min_baseline:
            skipped.append((key, f"insufficient history "
                                 f"({len(base_rows)}/{min_baseline})"))
            continue
        baseline = trimmed_mean([h["value"] for h in base_rows], trim=trim)
        noise = noise_sigmas * _stdev(cur.get("repeat_values") or [])
        value = float(cur["value"])
        checked += 1
        if direction == "lower":
            limit = baseline * (1.0 + rel_threshold) + noise
            regressed = value > limit
        else:
            limit = baseline * (1.0 - rel_threshold) - noise
            regressed = value < limit
        if regressed:
            findings.append({
                "benchmark": cur.get("benchmark"),
                "metric": cur.get("metric"),
                "value": value, "baseline": baseline, "limit": limit,
                "ratio": (value / baseline if baseline else math.inf),
                "direction": direction, "n_baseline": len(base_rows),
                "noise_floor": noise,
                "fingerprint": cur.get("fingerprint"),
            })
    findings.sort(key=lambda f: (f["benchmark"], f["metric"]))
    return {"findings": findings, "checked": checked, "skipped": skipped}


def render(result: dict, title: str = "regression sentinel") -> str:
    """Human-readable report of a `check()` result."""
    findings = result.get("findings", [])
    lines = [f"== {title}: {len(findings)} regression(s), "
             f"{result.get('checked', 0)} metric(s) checked =="]
    if findings:
        lines.append(f"  {'benchmark/metric':<36} {'value':>12} "
                     f"{'baseline':>12} {'limit':>12} {'ratio':>7}")
        for f in findings:
            lines.append(f"  {f['benchmark'] + '/' + f['metric']:<36} "
                         f"{f['value']:>12.4g} {f['baseline']:>12.4g} "
                         f"{f['limit']:>12.4g} {f['ratio']:>7.2f}")
    for key, why in result.get("skipped", []):
        lines.append(f"  skipped {key}: {why}")
    return "\n".join(lines)


def worst(result: dict) -> Optional[dict]:
    """The finding with the largest relative excursion, or None."""
    findings = result.get("findings", [])
    if not findings:
        return None
    return max(findings, key=lambda f: (f["ratio"] if f["direction"] ==
                                        "lower" else 1.0 / max(f["ratio"],
                                                               1e-30)))
