"""Build and load the CUDA sources of `repro_torch/csrc/` (route: nvcc into
plain-C shared libraries, bound with ctypes).

Each `csrc/<name>.cu` becomes `build/repro_torch/lib<name>-<hash>.so` under
the checkout's root; the hash covers the sources, the header and the flags,
so an edited source is rebuilt and an unchanged one is reused. All missing
libraries are compiled at once, one `nvcc` process per source. Nothing is
built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fwht", "quantpack", "quantencode", "quantdecode", "marks",
           "optim")
HEADERS = ("ndsc_common.cuh", "warp_rows.cuh", "row_fwht.cuh")
# No --use_fast_math: the payload path relies on IEEE rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# library: {exported C function: argtypes}
_SIGNATURES = {
    "fwht": {
        "ndsc_fwht": [_P, _P, _I64, _I, _F, _P],
        "ndsc_fwht_pass": [_P, _P, _P, _P, _I, _F, _P, _P, _P, _I, _I64, _I,
                           _I, _I, _I, _I, _F, _P],
    },
    "quantpack": {
        "ndsc_unpack_flat": [_P, _P, _P, _I64, _I, _I, _P],
        "ndsc_unpack_rows": [_P, _P, _P, _I64, _I, _I, _I, _P],
        "ndsc_quantize_pack": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    },
    "quantencode": {
        "ndsc_encode": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _F, _I,
                        _F, _I, _P],
        "ndsc_encode_cluster_fit": [_I, _P],
    },
    "quantdecode": {
        "ndsc_quant_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _P],
    },
    "marks": {
        "repro_mark": [_I, _P],
    },
    "optim": {
        "repro_sum_squares": [_P, _P, _P, _I, _P, _I64, _P, _P],
        "repro_adamw_update": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I64, _P,
                               _P, _P, _P, _F, _F, _F, _F, _F, _F, _P],
        "repro_sgd_update": [_P, _I, _P, _P, _P, _I, _I64, _P, _P, _I, _F,
                             _P],
    },
}

_loaded: dict = {}
build_log: dict = {}          # name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every library of `names` not yet built, all in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str):
    """The loaded library `name` (building it on first use), with argtypes
    and an int return type set on each of its exported functions."""
    if name not in _loaded:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _short_name(mangled: str) -> str:
    """`encode_warp_kernel<8,4>` for an Itanium-mangled kernel name (its
    last name component and its int template arguments)."""
    rest = mangled[2:].lstrip("N")
    name = mangled
    while (d := re.match(r"\d+", rest)):
        cut = len(d.group()) + int(d.group())
        name, rest = rest[len(d.group()):cut], rest[cut:]
    args = re.match(r"I((?:Li\d+E)+)E", rest)
    if args:
        name += "<" + ",".join(re.findall(r"\d+", args.group(1))) + ">"
    return name


def register_report(name: str) -> list:
    """[(kernel, registers, spill bytes stored + loaded)] for each kernel of
    library `name`, read from ptxas's report in its last build's log."""
    out, fn, spill = [], None, 0
    for line in build_log.get(name, "").splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn, spill = _short_name(m.group(1)), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out
