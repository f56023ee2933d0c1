"""Host microseconds per call of the FWHT, encoder and quantpack wrappers
on one card.

    python3 tools/wrapper_host_us.py [SRC ...]

Each SRC is a directory that holds a `repro_torch` package to time
(default: this checkout's `src`). All trees are loaded into one process,
each with its own modules and built libraries, and timed in turns: each
of 5 runs times every tree once, in an order that alternates from run to
run, so that two trees share the process's state (its core, its clocks)
and are compared within it. Timed: the FWHT at the serve path's shapes
(chip_smoke.FWHT_TIME_SHAPES) and a dense `x @ H` at the same shapes,
encode_ef on 16 rows of 256, quantize_pack (8 bits) at the decode K/V
shape (4, 1, 4, 128) and unpack_dequant on 16 rows of 32 words (4 bits,
chunk 256). Each figure is the median over the runs of 1000 calls, then one
synchronize. At these sizes the card finishes a call before the host
launches the next, so the figure is the host's cost of a call. Prints one
JSON object: each key maps to one figure per SRC, in the order given.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

SHAPES = (("decode_kv", (4, 1, 4, 128)), ("decode_q", (4, 4, 8, 128)),
          ("prefill_kv", (1, 80, 4, 128)))
RUNS = 5


def call_us(fn, calls=1000) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def per_call_us(fns) -> list:
    """Median µs per call of each of fns, timed in turns."""
    for fn in fns:
        fn()
    runs = [[] for _ in fns]
    for r in range(RUNS):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            runs[i].append(call_us(fns[i]))
    return [statistics.median(t) for t in runs]


def load(src: Path):
    """The `ops` module of the repro_torch tree at src, imported beside any
    tree loaded before (each keeps its modules)."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(src.resolve()))
    try:
        from repro_torch.kernels import ops
    finally:
        sys.path.pop(0)
    return ops


def main() -> int:
    if not torch.cuda.is_available():
        print("wrapper_host_us: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    srcs = [Path(a) for a in sys.argv[1:]] or [
        Path(__file__).resolve().parents[1] / "src"]
    opss = [load(src) for src in srcs]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    h = opss[0].fwht(torch.eye(128, device=dev))
    out = {"src": [str(s) for s in srcs],
           "card": torch.cuda.get_device_name(0)}
    for tag, shape in SHAPES:
        x = torch.randn(shape, generator=g, device=dev)
        out[f"fwht/{tag}"] = per_call_us(
            [lambda o=o: o.fwht(x) for o in opss])
        out[f"x@H/{tag}"] = per_call_us([lambda: x @ h])
    u = torch.randn(16, 256, generator=g, device=dev)
    signs = torch.ones(256, device=dev)
    out["encode_ef/16x256"] = per_call_us(
        [lambda o=o: o.encode_ef(u, signs, 4) for o in opss])
    x = torch.randn(SHAPES[0][1], generator=g, device=dev)
    scale = x.abs().amax(-1, keepdim=True)
    out["quantize_pack/decode_kv"] = per_call_us(
        [lambda o=o: o.quantize_pack(x, scale, 8) for o in opss])
    words, wscale = opss[0].encode(u, signs, 4)
    out["unpack_dequant/16x32"] = per_call_us(
        [lambda o=o: o.unpack_dequant(words, wscale, 4, 256) for o in opss])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
