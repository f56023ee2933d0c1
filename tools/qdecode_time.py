"""Device and host time of the KV-cache decode attention on one card.

    python3 tools/qdecode_time.py [--blocks-per-sm N] [SRC ...]

Each SRC is a directory that holds a `repro_torch` package (default: this
checkout's `src`); each is timed in a process of its own, in the order
given, so `tools/qdecode_time.py build/parent/src src src build/parent/src`
compares two trees on one card in turns. Shapes and timers are
chip_smoke.py's (ATTN_TIME_SHAPES: yi-6b's K 4, G 8, dh 128, 8 bits, at
the serve shape B 4, C 512 with kv_len 512 and 96, and at B 32, C 32768):
each shape is checked against the plain version, then timed by CUDA
events (median of 20, one call between the events, so at small shapes it
holds the host's launch time) and by torch.profiler (the kernels' own
time per call over 20 calls, by kernel); the host's microseconds per call
(1000 calls, then one synchronize) at the serve shape. Prints one JSON
object per SRC. --blocks-per-sm sets `quantdecode.BLOCKS_PER_SM` of each
tree (the blocks per SM its split plan aims for) before timing it.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

KH, G, DH, BITS, TOL = 4, 8, 128, 8, 2e-4


def kernel_ms(fn, calls: int = 20) -> dict:
    """Device milliseconds per call of each kernel fn launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def time_tree(src: Path, blocks_per_sm: int | None = None) -> dict:
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import checks, ops, quantdecode, ref

    if blocks_per_sm is not None:
        quantdecode.BLOCKS_PER_SM = blocks_per_sm
        quantdecode.plan.cache_clear()
    dev = torch.device("cuda")
    out = {"src": str(src), "card": torch.cuda.get_device_name(0),
           "blocks_per_sm": getattr(quantdecode, "BLOCKS_PER_SM", None)}
    for tag, (b, c, n) in cs.ATTN_TIME_SHAPES:
        args = checks.attention_inputs(b, c, KH, G, DH, BITS, c, dev,
                                       lens=[n] * b)

        def call():
            return ops.quant_decode_attention(*args, bits=BITS)

        got, want = call(), ref.quant_decode_attention(*args, bits=BITS)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"{tag}: max abs err {err}")
        del got, want
        by_kernel = kernel_ms(call)
        out[tag] = {"ms": cs.timed(call, 20),
                    "device_ms": sum(by_kernel.values()) if by_kernel
                    else "not measured",
                    "device_ms_by_kernel": by_kernel, "max_abs_err": err}
        if tag == "serve":
            out[tag]["host_us"] = cs.host_us(call)
        del args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("qdecode_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    opt = []
    if args[:1] == ["--blocks-per-sm"]:
        opt, args = args[:2], args[2:]
    srcs = args or [str(ROOT / "src")]
    if len(srcs) == 1:
        bps = int(opt[1]) if opt else None
        print(json.dumps(time_tree(Path(srcs[0]), bps)), flush=True)
        return 0
    for src in srcs:                   # one process per tree
        rc = subprocess.run([sys.executable, __file__, *opt, src]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
