"""Time of quantize_pack on one card, for one or several source trees.

    python3 tools/pack_time.py [SRC ...]

Each SRC is a directory that holds a `repro_torch` package (default: this
checkout's `src`); each is timed in a process of its own, in the order
given, so `tools/pack_time.py build/parent/src src src build/parent/src`
compares two trees on one card in turns. The shapes are chip_smoke.py's:
the serve run's decode and prefill rows of 128 at 8 bits
(PACK_TIME_SHAPES) and the RATQ train shape (the 12 leaves of the 4-layer
yi-6b tree in chunks of 128 at 2 bits, one RATQ encode's 12 launches,
`time_quantize_pack_ratq`). Each is checked bitwise against the plain
version, then timed by CUDA events (median of 20 at the serve shapes, 5
at the RATQ shape) beside its bound; at the decode shape also the device
time per call under torch.profiler and the host's microseconds per call.
Prints one JSON object per SRC.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

BITS = cs.SERVE_BITS


def time_tree(src: Path) -> dict:
    sys.path.insert(0, str(src.resolve()))
    from repro_torch import configs
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for tag, shape in cs.PACK_TIME_SHAPES:
        x = torch.randn(shape, generator=g, device=dev)
        scale = x.abs().amax(-1, keepdim=True)

        def call():
            return ops.quantize_pack(x, scale, BITS)

        if not torch.equal(call(), ref.quantize_pack(x, scale, BITS)):
            raise AssertionError(f"quantize_pack differs at {shape}")
        coords, rows = x.numel(), x.numel() // shape[-1]
        b, by = cs.bound_ms(coords * (4 + BITS / 8) + rows * 4, coords * 10)
        out[tag] = {"shape": list(shape), "ms": cs.timed(call, 20),
                    "bound_ms": b, "bound_by": by}
        if tag == "decode":
            out[tag]["device_ms"] = cs.device_ms(call)
            out[tag]["host_us"] = cs.host_us(call)
        del x, scale
        torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(configs.get("yi-6b"), num_layers=4)
    ratq = cs.time_quantize_pack_ratq(ops, ref, dev, cfg4)
    out["ratq_train"] = {k: ratq[k] for k in ("rows", "launches_per_encode",
                                              "ms", "bound_ms", "bound_by")}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pack_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    srcs = sys.argv[1:] or [str(ROOT / "src")]
    if len(srcs) == 1:
        print(json.dumps(time_tree(Path(srcs[0]))), flush=True)
        return 0
    for src in srcs:                   # one process per tree
        rc = subprocess.run([sys.executable, __file__, src]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
