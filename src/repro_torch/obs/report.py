"""Aggregate obs events into a per-run summary (dict + rendered table);
port of `repro.obs.report`, the same summary schema.

`summarize` folds a flat event list (from a MemorySink or a JSONL file)
into per-name statistics; `render` formats the result as a text table.
The dict is JSON-able as-is, and a summary of either package reads the
same way.
"""
from __future__ import annotations


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(events, recompiles=None) -> dict:
    """Fold events into {"spans", "counters", "gauges", "hists",
    "recompiles", "events"}.

    spans:    per name — count, total_s, mean_s, max_s
    counters: per name — total (sum of values), count
    gauges:   per name — last, min, max
    hists:    per name — count, mean, p50, p95, p99, min, max

    Every per-name dict is key-sorted so summaries (and their JSON dumps)
    diff cleanly across runs.
    """
    spans: dict = {}
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for e in events:
        etype, name = e.get("type"), e.get("name")
        if etype == "span":
            s = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "max_s": 0.0})
            dur = float(e.get("dur", 0.0))
            s["count"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
        elif etype == "counter":
            c = counters.setdefault(name, {"total": 0.0, "count": 0})
            c["total"] += float(e.get("value", 0.0))
            c["count"] += 1
        elif etype == "gauge":
            v = float(e.get("value", 0.0))
            g = gauges.setdefault(name, {"last": v, "min": v, "max": v})
            g["last"] = v
            g["min"] = min(g["min"], v)
            g["max"] = max(g["max"], v)
        elif etype == "hist":
            hists.setdefault(name, []).append(float(e.get("value", 0.0)))
    for s in spans.values():
        s["mean_s"] = s["total_s"] / s["count"] if s["count"] else 0.0
    hstats = {}
    for name, vals in hists.items():
        vals.sort()
        hstats[name] = {"count": len(vals),
                        "mean": sum(vals) / len(vals),
                        "p50": _percentile(vals, 0.50),
                        "p95": _percentile(vals, 0.95),
                        "p99": _percentile(vals, 0.99),
                        "min": vals[0], "max": vals[-1]}

    def _sorted(d):
        return {k: d[k] for k in sorted(d)}

    rec = dict(recompiles or {})
    return {"events": len(events), "spans": _sorted(spans),
            "counters": _sorted(counters), "gauges": _sorted(gauges),
            "hists": _sorted(hstats), "recompiles": _sorted(rec)}


def render(summary: dict, title: str = "obs summary") -> str:
    """Human-readable table of a `summarize` result."""
    lines = [f"== {title} ({summary.get('events', 0)} events) =="]
    spans = summary.get("spans", {})
    if spans:
        lines.append(f"  {'span':<28} {'count':>7} {'total ms':>10} "
                     f"{'mean ms':>10} {'max ms':>10}")
        for name in sorted(spans):
            s = spans[name]
            lines.append(f"  {name:<28} {s['count']:>7} "
                         f"{s['total_s'] * 1e3:>10.2f} "
                         f"{s['mean_s'] * 1e3:>10.3f} "
                         f"{s['max_s'] * 1e3:>10.2f}")
    counters = summary.get("counters", {})
    if counters:
        lines.append(f"  {'counter':<38} {'total':>14} {'events':>8}")
        for name in sorted(counters):
            c = counters[name]
            lines.append(f"  {name:<38} {c['total']:>14g} {c['count']:>8}")
    gauges = summary.get("gauges", {})
    if gauges:
        lines.append(f"  {'gauge':<38} {'last':>10} {'min':>10} {'max':>10}")
        for name in sorted(gauges):
            g = gauges[name]
            lines.append(f"  {name:<38} {g['last']:>10g} {g['min']:>10g} "
                         f"{g['max']:>10g}")
    hists = summary.get("hists", {})
    if hists:
        lines.append(f"  {'histogram':<30} {'count':>7} {'mean':>10} "
                     f"{'p50':>10} {'p95':>10} {'p99':>10}")
        for name in sorted(hists):
            h = hists[name]
            lines.append(f"  {name:<30} {h['count']:>7} {h['mean']:>10.4g} "
                         f"{h['p50']:>10.4g} {h['p95']:>10.4g} "
                         f"{h.get('p99', h['max']):>10.4g}")
    attrib = {name: sp["attrib"] for name, sp in spans.items()
              if isinstance(sp, dict) and sp.get("attrib")}
    if attrib:
        lines.append(f"  {'attrib (roofline)':<24} {'meas ms':>9} "
                     f"{'model ms':>9} {'frac':>7} {'bound':>6} "
                     f"{'GF/s':>8} {'wire B/s':>10} {'cov':>5}")
        for name in sorted(attrib):
            a = attrib[name]

            def g(key, scale=1.0, fmt="{:.3g}", a=a):
                v = a.get(key)
                return fmt.format(v * scale) if v is not None else "-"

            lines.append(
                f"  {name:<24} {a['measured_s'] * 1e3:>9.2f} "
                f"{g('t_model_s', 1e3, '{:.3f}'):>9} "
                f"{g('roofline_frac', 1.0, '{:.3g}'):>7} "
                f"{(a.get('bound') or '-'):>6} "
                f"{g('flops_per_s_achieved', 1e-9):>8} "
                f"{g('wire_min_bytes_per_s'):>10} "
                f"{a.get('cost_coverage', 0.0):>5.2f}")
    costs = summary.get("costs", {})
    programs = costs.get("programs", {}) if isinstance(costs, dict) else {}
    if programs:
        pk = costs.get("peaks", {})
        lines.append(f"  costs (peaks: {pk.get('source', '?')} "
                     f"{pk.get('flops_per_s', 0):.3g} FLOP/s, "
                     f"{pk.get('bytes_per_s', 0):.3g} B/s)")
        lines.append(f"  {'program':<28} {'calls':>7} {'specs':>6} "
                     f"{'GFLOP':>9} {'GB acc':>9} {'wire MB':>9}")
        for name in sorted(programs):
            p = programs[name]
            lines.append(
                f"  {name:<28} {p['calls']:>7} "
                f"{len(p['specializations']):>6} "
                f"{p['flops_total'] / 1e9:>9.4g} "
                f"{p['bytes_total'] / 1e9:>9.4g} "
                f"{p['wire_bytes'] / 1e6:>9.4g}")
        degraded = sorted({f"{name}: {s['reason']}"
                           for name, p in programs.items()
                           for s in p["specializations"]
                           if not s["available"] and s.get("reason")})
        for msg in degraded:
            lines.append(f"    (cost unavailable) {msg}")
    recompiles = summary.get("recompiles", {})
    if recompiles:
        lines.append(f"  {'program (compiles this session)':<44} {'n':>5}")
        for name in sorted(recompiles):
            lines.append(f"  {name:<44} {recompiles[name]:>5}")
    return "\n".join(lines)
