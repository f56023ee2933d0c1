"""Where encode_row_kernel's time goes: variants of it timed side by side on
one card.

    python3 tools/encode_row_variants.py

Each variant is `csrc/quantencode.cu` and its headers with one textual
change (in `row_fwht.cuh` where the row schedule is concerned), built
with nvcc into `build/encode_row_variants/<name>/` and bound with ctypes
like the port's own library. Two are other designs
of the kernel and must give its bits ("exact"): `u_per_value` reads u for
the residual from device memory value by value instead of one bulk copy
into shared memory, and `one_block` runs 2^14 at one block per SM with
the whole next row staged (the first design). The rest remove one cost
and give wrong bits, so only their time means something: `no_u` drops u
from the residual, `no_shuffle` the five shuffle stages, `mul_for_div`
multiplies in the quantizer where it divides. Each variant's encode_ef
(f32 residual) and encode (dither, keep-0.5 mask) run on one tensor of
chip_smoke.py phase 3f's rows (42,563 of 2^14, 21,283 of 2^15) at R 4,
timed by CUDA events (median of 5) beside the bound of kernels/cost.py.
Prints the card's name and power limit, then one JSON object per
(n, variant).
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, cost  # noqa: E402
from repro_torch.kernels.fwht import inv_sqrt  # noqa: E402

OUT = ROOT / "build" / "encode_row_variants"
SHAPES = ((16384, 42563), (32768, 21283))   # 3f's rows at each chunk
BITS = 4


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise AssertionError(f"variant patch not found: {old!r}")
    return text.replace(old, new)


def variants() -> dict:
    """name -> ({source file: its text where it differs}, exact)."""
    src = (_build.CSRC / "quantencode.cu").read_text()
    hdr = (_build.CSRC / "ndsc_common.cuh").read_text()
    row = (_build.CSRC / "row_fwht.cuh").read_text()
    u_in_buf = "rr[p] = __fsub_rn(buf[p], y);"
    per_value = _sub(_sub(_sub(
        src, "    if (tid == 0) bulk_load(buf, xr, N * 4, &bar_u);\n", ""),
        "    mbar_wait(&bar_u, parity_u);\n", ""),
        u_in_buf, "rr[p] = __fsub_rn(xr[p], y);")
    one_block = _sub(_sub(
        row, "static constexpr int STAGE = N / 2;",
        "static constexpr int STAGE = LOG2N == 14 ? N : N / 2;"),
        "static constexpr int BLOCKS = LOG2N == 14 ? 2 : 1;",
        "static constexpr int BLOCKS = 1;")
    return {
        "kernel": ({}, True),
        "u_per_value": ({"quantencode.cu": per_value}, True),
        "one_block": ({"row_fwht.cuh": one_block}, True),
        "no_u": ({"quantencode.cu": _sub(src, u_in_buf,
                                         "rr[p] = __fsub_rn(0.0f, y);")},
                 False),
        "no_shuffle": ({"row_fwht.cuh": _sub(
            row, "for (int o = 1; o < 32; o <<= 1) {",
            "for (int o = 32; o < 32; o <<= 1) {")}, False),
        "mul_for_div": ({"ndsc_common.cuh": _sub(
            hdr, "__fdiv_rn(v, denom)", "__fmul_rn(v, denom)")}, False),
    }


def build(vs: dict) -> dict:
    """Every variant compiled at once; name -> its ndsc_encode."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (files, _) in vs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.HEADERS + ("quantencode.cu",):
            shutil.copy(_build.CSRC / f, d / f)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "quantencode.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).ndsc_encode
        fn.argtypes = _build._SIGNATURES["quantencode"]["ndsc_encode"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_row_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    vs = variants()
    fns = build(vs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, rows in SHAPES:
        x = torch.randn(rows, n, generator=g, device=dev) * 1e-3
        signs = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                            1.0, -1.0)
        dither = (torch.rand(rows, n, generator=g, device=dev) - 0.5) / 8
        mask = (torch.rand(rows, 1, generator=g, device=dev) < 0.5).float()
        words = torch.empty(rows, n * BITS // 32, dtype=torch.int32,
                            device=dev)
        scale = torch.empty(rows, 1, device=dev)
        resid = torch.empty_like(x)
        bounds = {"encode_ef": cs.bound_ms(*cost.encode_ef(
                      x.numel(), rows, n, BITS))[0],
                  "encode": cs.bound_ms(*cost.encode(
                      x.numel(), rows, n, BITS, dither=True, mask=True))[0]}
        want = None
        for name, fn in fns.items():
            def call(ef: bool, fn=fn):
                rc = fn(x.data_ptr(), signs.data_ptr(),
                        None if ef else dither.data_ptr(),
                        None if ef else mask.data_ptr(), words.data_ptr(),
                        scale.data_ptr(), resid.data_ptr() if ef else None,
                        rows, n, BITS, inv_sqrt(n), 0, 1.0, 0, stream)
                _build.check(rc, name)

            out = {"n": n, "rows": rows, "variant": name,
                   "exact": vs[name][1]}
            for kind, ef in (("encode_ef", True), ("encode", False)):
                ms = cs.timed(lambda: call(ef), 5)
                out[kind] = {"ms": ms, "bound_ms": bounds[kind],
                             "share_of_bound": bounds[kind] / ms}
            call(True)
            got = [t.clone() for t in (words, scale, resid)]
            if name == "kernel":
                want = got
            elif vs[name][1] and not all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from the kernel at "
                                     f"n {n}")
            print(json.dumps(out), flush=True)
        del x, dither, resid
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
