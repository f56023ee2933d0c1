"""Per-program cost model + roofline-fraction attribution (port of
`repro.obs.costs`: the same capture, snapshot schema and attribution).

A measured span is half a result; this module supplies the analytic half.
Capture observes the calls the instrumented layers already make: one record
per (program name, abstract signature, static tag), each sighting bumping
its call count and the analytic wire bytes the codec audit charges it. A
peak table then turns (measured seconds, modeled operations and bytes)
into a roofline fraction per instrumented span.

Extraction never runs, re-runs or times anything, and never reads a
tensor's values. The reference asks XLA's cost analysis of each lowered
program; eager torch has none, so here:

  * `kernels.<op>.<path>` programs (the six kernels' dispatch in
    `repro_torch.kernels.ops`) get their bytes and operations from their
    argument shapes: the counts of `repro_torch.kernels.cost`, which
    `chip_smoke.py`'s bounds divide too;
  * every other program degrades to `available: False` with its reason,
    as the reference degrades on a backend without cost analysis: an
    eager callable, or a captured program (`repro_torch.graph.Program`,
    which exposes `_cache_size`), whose graph records eager torch ops.
    `compile_ok=True` has no compiler to ask and degrades the same way.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

from repro_torch import tree as tree_lib
from repro_torch.kernels import cost

# ---------------------------------------------------------------------------
# Peak table (device-name prefix first, backend fallback): dense f32 FLOP/s
# and memory bytes/s. The port's models run f32 with TF32 off, so the f32
# peak is the roof. Override with REPRO_PEAK_FLOPS / REPRO_PEAK_BYTES.
# ---------------------------------------------------------------------------
DEVICE_PEAKS = (
    ("NVIDIA H100", cost.PEAK_F32_FLOP_S, cost.PEAK_BYTES_S),
)
BACKEND_PEAKS = {
    "gpu": (1.0e14, 2.0e12),
    "cpu": (1.0e11, 5.0e10),   # one AVX-ish core complex + DDR stream
}
EAGER_REASON = "eager torch program: no compiler cost analysis"
GRAPH_REASON = ("captured program (a CUDA graph of eager torch ops): no "
                "compiler cost analysis")


def peaks(backend: Optional[str] = None,
          device_kind: Optional[str] = None) -> dict:
    """{"flops_per_s", "bytes_per_s", "backend", "device_kind", "source"}.

    Resolution order: env override → device-name prefix in DEVICE_PEAKS →
    backend default → cpu default. Never raises: without a card the cpu
    row is used, with the source recorded."""
    if backend is None or device_kind is None:
        try:
            import torch                                # noqa: PLC0415
            has_card = torch.cuda.is_available()
            backend = backend or ("gpu" if has_card else "cpu")
            if device_kind is None:
                device_kind = (torch.cuda.get_device_name(0) if has_card
                               else None)
        except Exception:
            pass
    env_f = os.environ.get("REPRO_PEAK_FLOPS")
    env_b = os.environ.get("REPRO_PEAK_BYTES")
    if env_f is not None and env_b is not None:
        return {"flops_per_s": float(env_f), "bytes_per_s": float(env_b),
                "backend": backend, "device_kind": device_kind,
                "source": "env"}
    if device_kind:
        for prefix, fl, by in DEVICE_PEAKS:
            if str(device_kind).startswith(prefix):
                return {"flops_per_s": fl, "bytes_per_s": by,
                        "backend": backend, "device_kind": device_kind,
                        "source": "device_table"}
    fl, by = BACKEND_PEAKS.get(backend or "cpu", BACKEND_PEAKS["cpu"])
    return {"flops_per_s": fl, "bytes_per_s": by, "backend": backend,
            "device_kind": device_kind, "source": "backend_default"}


# ---------------------------------------------------------------------------
# Call capture: one record per (program name, abstract signature, statics)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A captured tensor argument: its shape, dtype name and item size
    (the reference keeps a `jax.ShapeDtypeStruct`)."""
    shape: tuple
    dtype: str
    itemsize: int


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_sig(x):
    """Hashable per-leaf signature component. Tensors key by shape/dtype;
    python scalars key by TYPE only, so a round index does not mint a
    specialization per value."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(shape), _dtype_name(dtype))
    if isinstance(x, (bool, int, float)):
        return (type(x).__name__,)
    return ("other", type(x).__qualname__)


def _abstractify(x):
    """Tensors (and numpy arrays) → TensorSpec; anything else passes
    through. Capture never retains a live tensor."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return x
    itemsize = getattr(dtype, "itemsize", None)
    return TensorSpec(tuple(shape), _dtype_name(dtype), int(itemsize or 0))


def record_call(store: dict, name: str, fn, args, kwargs=None, *,
                static=None, span: Optional[str] = None,
                wire_bytes=None) -> None:
    """Observe one call of `fn` under program `name`.

    `store` is the owning Obs session's capture dict. First sighting of a
    signature abstracts and stores the args; every sighting bumps the call
    count and accumulates `wire_bytes` (the analytic minimum-traffic bytes
    this call puts on the wire, from the codec audit). `static` is a
    hashable tag for parameters closed over by `fn` (e.g. quantizer bits)
    so differently-specialized closures don't collide. `span` names the
    host-side obs span this program's time is attributed to (default: the
    program name). `fn` is not kept: nothing here is lowered (the
    reference's `jit_wrap` flag has no counterpart)."""
    kwargs = kwargs or {}
    leaves, spec = tree_lib.flatten((args, kwargs))
    sig = (name, spec, tuple(_leaf_sig(x) for x in leaves), static)
    rec = store.get(sig)
    if rec is None:
        a_args, a_kwargs = tree_lib.unflatten(
            spec, [_abstractify(x) for x in leaves])
        store[sig] = rec = {
            "name": name, "args": a_args, "kwargs": a_kwargs,
            "static": static, "span": span,
            "captured": getattr(fn, "_cache_size", None) is not None,
            "calls": 0, "wire_bytes": 0.0, "cost": None,
        }
    rec["calls"] += 1
    if wire_bytes:
        rec["wire_bytes"] += float(wire_bytes)


# ---------------------------------------------------------------------------
# Extraction (cached per capture record)
# ---------------------------------------------------------------------------
def _leaf_bytes(tree) -> float:
    return float(sum(math.prod(x.shape) * x.itemsize
                     for x in tree_lib.leaves(tree)
                     if isinstance(x, TensorSpec)))


def _kernel_op(name: str) -> Optional[str]:
    parts = name.split(".")
    return parts[1] if len(parts) == 3 and parts[0] == "kernels" else None


def _extract(rec: dict) -> dict:
    """Cost of one captured specialization: analytic for a kernel, else
    unavailable with the reason. Any failure degrades to available=False
    with the reason recorded."""
    if rec["cost"] is not None:
        return rec["cost"]
    out = {"sig": _sig_str(rec), "calls": 0, "available": False,
           "reason": None, "source": None, "flops": None,
           "bytes_accessed": None, "argument_bytes": None,
           "output_bytes": None, "temp_bytes": None, "peak_bytes": None}
    try:
        out["argument_bytes"] = _leaf_bytes((rec["args"], rec["kwargs"]))
        op = _kernel_op(rec["name"])
        if op is None:
            out["reason"] = GRAPH_REASON if rec["captured"] else EAGER_REASON
        else:
            nbytes, flops = cost.program_cost(op, rec["args"],
                                              rec["kwargs"], rec["static"])
            out.update(source="analytic", flops=float(flops),
                       bytes_accessed=float(nbytes), available=True)
    except Exception as e:
        out["reason"] = f"{type(e).__name__}: {e}"
    rec["cost"] = out
    return out


def _sig_str(rec: dict) -> str:
    parts = []
    for leaf in tree_lib.leaves((rec["args"], rec["kwargs"])):
        if isinstance(leaf, TensorSpec):
            parts.append(f"{leaf.dtype}[{','.join(map(str, leaf.shape))}]")
        else:
            parts.append(type(leaf).__name__)
    tail = f" static={rec['static']!r}" if rec["static"] is not None else ""
    return f"({', '.join(parts)}){tail}"


def snapshot(captures: dict, *, compile_ok: bool = False,
             peak_info: Optional[dict] = None) -> dict:
    """Fold a session's captures into the per-program cost table.

    {"peaks": {...}, "programs": {name: {"span", "calls", "wire_bytes",
    "flops_total", "bytes_total", "cost_coverage", "specializations":
    [...]}}}. Totals weight each specialization's cost by its observed
    call count; `cost_coverage` is the fraction of observed calls whose
    specialization has a cost (1.0 = fully modeled). `compile_ok` has no
    compiler to ask here and changes nothing."""
    from repro_torch.obs import recompile as recompile_lib  # noqa: PLC0415
    annotations = recompile_lib.annotations_by_name()
    programs: dict = {}
    for rec in captures.values():
        name = rec["name"]
        ann = annotations.get(name, {})
        prog = programs.setdefault(name, {
            "span": rec["span"] or ann.get("span") or name,
            "calls": 0, "wire_bytes": 0.0, "flops_total": 0.0,
            "bytes_total": 0.0, "covered_calls": 0,
            "annotations": {k: v for k, v in ann.items() if k != "span"},
            "specializations": []})
        spec = dict(_extract(rec))
        spec["calls"] = rec["calls"]
        prog["specializations"].append(spec)
        prog["calls"] += rec["calls"]
        prog["wire_bytes"] += rec["wire_bytes"]
        if spec["available"]:
            prog["covered_calls"] += rec["calls"]
            if spec["flops"] is not None:
                prog["flops_total"] += spec["flops"] * rec["calls"]
            if spec["bytes_accessed"] is not None:
                prog["bytes_total"] += spec["bytes_accessed"] * rec["calls"]
    for prog in programs.values():
        prog["specializations"].sort(key=lambda s: s["sig"])
        prog["cost_coverage"] = (prog.pop("covered_calls") / prog["calls"]
                                 if prog["calls"] else 0.0)
    return {"peaks": peak_info or peaks(),
            "programs": {k: programs[k] for k in sorted(programs)}}


# ---------------------------------------------------------------------------
# Roofline-fraction attribution onto measured spans
# ---------------------------------------------------------------------------
def attach_attrib(summary: dict, snap: dict) -> dict:
    """Mutate `summary` (a `report.summarize` result): every span that a
    cost-modeled program attributes to gains an `attrib` block — measured
    seconds vs the model-predicted FLOP time and byte time from the peak
    table, the achieved roofline fraction, which roof binds, and achieved
    wire-bytes/s against the analytic R·n minimum-traffic bytes."""
    spans = summary.get("spans", {})
    pk = snap.get("peaks", {})
    by_span: dict = {}
    for name, prog in snap.get("programs", {}).items():
        by_span.setdefault(prog.get("span") or name, []).append((name, prog))
    for span_name in sorted(by_span):
        sp = spans.get(span_name)
        if sp is None:
            continue
        group = by_span[span_name]
        flops = sum(p["flops_total"] for _, p in group)
        nbytes = sum(p["bytes_total"] for _, p in group)
        wire = sum(p["wire_bytes"] for _, p in group)
        calls = sum(p["calls"] for _, p in group)
        covered = sum(p["cost_coverage"] * p["calls"] for _, p in group)
        measured = sp.get("total_s", 0.0)
        t_flops = flops / pk["flops_per_s"] if pk.get("flops_per_s") else None
        t_bytes = nbytes / pk["bytes_per_s"] if pk.get("bytes_per_s") else None
        t_model = max(t_flops or 0.0, t_bytes or 0.0) or None
        attrib = {
            "programs": sorted(n for n, _ in group),
            "calls_observed": calls,
            "cost_coverage": (covered / calls) if calls else 0.0,
            "flops_total": flops or None,
            "bytes_total": nbytes or None,
            "measured_s": measured,
            "t_flops_s": t_flops if flops else None,
            "t_bytes_s": t_bytes if nbytes else None,
            "t_model_s": t_model if (flops or nbytes) else None,
            "roofline_frac": None, "bound": None,
            "flops_per_s_achieved": (flops / measured
                                     if flops and measured > 0 else None),
            "bytes_per_s_achieved": (nbytes / measured
                                     if nbytes and measured > 0 else None),
            "wire_min_bytes": wire or None,
            "wire_min_bytes_per_s": (wire / measured
                                     if wire and measured > 0 else None),
        }
        if attrib["t_model_s"] and measured > 0:
            attrib["roofline_frac"] = attrib["t_model_s"] / measured
            attrib["bound"] = ("flops" if (t_flops or 0.0) >= (t_bytes or 0.0)
                               else "bytes")
        sp["attrib"] = attrib
    return summary
