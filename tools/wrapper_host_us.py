"""Host microseconds per call of the FWHT and encoder wrappers on one card.

    python3 tools/wrapper_host_us.py [SRC]

SRC is the directory that holds the `repro_torch` package to time (default:
this checkout's `src`), so two trees can be timed in turns on one card. For
the FWHT at the serve path's shapes (chip_smoke.FWHT_TIME_SHAPES), for a
dense `x @ H` at the same shapes, and for encode_ef on 16 rows of 256: 1000
calls, then one synchronize; the median of 5 such runs. Prints one JSON
object. At these sizes the card finishes a call before the host issues the
next, so the figure is the host's cost of a call.
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


def per_call_us(fn, calls=1000, runs=5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / calls * 1e6)
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("wrapper_host_us: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        Path(__file__).resolve().parents[1] / "src")
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    h = ref.fwht(torch.eye(128, device=dev))
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    for tag, shape in SHAPES:
        x = torch.randn(shape, generator=g, device=dev)
        out[f"fwht/{tag}"] = per_call_us(lambda: ops.fwht(x))
        out[f"x@H/{tag}"] = per_call_us(lambda: x @ h)
    u = torch.randn(16, 256, generator=g, device=dev)
    signs = torch.ones(256, device=dev)
    out["encode_ef/16x256"] = per_call_us(lambda: ops.encode_ef(u, signs, 4))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
