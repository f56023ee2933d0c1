"""Designs of encode_cluster_kernel (the encoders' "cluster" route, N = 2^16
and 2^17) timed side by side on one card.

    python3 tools/encode_cluster_variants.py

Each variant is `csrc/quantencode.cu` and its headers with one textual
change, built with nvcc into `build/encode_cluster_variants/<name>/` and
bound with ctypes like the port's own library. Six are designs of the
kernel and must give its bits ("exact"): `kernel` (as built: segments of
2^14, the top stages by one transposing exchange), `pairwise` (one
exchange a stage with the partner CTA, each CTA keeping its segment; the
function PAIRWISE_STAGES below in place of the kernel's exchange),
`seg15` and `pairwise_seg15` (segments of 2^15: 1024 threads, one CTA an
SM, half the CTAs a cluster), `one_cta_per_sm` (the kernel at one CTA
of 512 threads an SM, 128 registers a thread) and `u_per_value` (the
residual's u read from device memory value by value instead of bulk
copies into shared memory). Three give wrong bits, so only their time
means something: `local_reads` reads the partners' values from the CTA's
own buffer (the cost of the distributed shared memory reads),
`no_word_barrier` drops the cluster barrier before the EF decode reads the
cluster's words back (its cost), `no_u` forms the residual without u (the
cost of loading it). Each variant's encode_ef (f32 residual) and encode
(dither, keep-0.5 mask) run on one tensor of chip_smoke.py phase 3f's rows
(10,641 of 2^16, 5,321 of 2^17) at R 4, timed by CUDA events (median of
5) beside the bound of kernels/cost.py, with the registers and spilled
bytes ptxas reports for its R 4 kernel and the clusters that fit on the
card. Prints the card's name and power limit, then one JSON object per
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
from repro_torch.kernels import _build, cost, ref  # noqa: E402
from repro_torch.kernels.fwht import inv_sqrt  # noqa: E402

OUT = ROOT / "build" / "encode_cluster_variants"
SHAPES = ((1 << 16, 10641), (1 << 17, 5321))   # 3f's rows at each chunk
BITS = 4


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise AssertionError(f"variant patch not found: {old!r}")
    return text.replace(old, new)


# The "pairwise" design's exchange: one a stage h = 2^SEG, 2^(SEG+1), ...
# with the partner CTA rank ^ (h / 2^SEG), whose value sits at the same
# address of layout B; the lower keeps v + p, the upper p + v*(-1), each
# CTA its own segment (a piece of P = 2^SEG: top_stages does nothing).
PAIRWISE_STAGES = """template <int SEG, int C>
__device__ inline void cluster_stages(float (&v)[kRowV], float* buf,
                                      unsigned rank) {
  constexpr int T = RowShape<SEG>::T;
  float* mine = buf + threadIdx.x;
  const uint32_t at = ndsc::smem_addr(mine);
#pragma unroll
  for (int h = 1; h < C; h <<= 1) {
    if (h > 1) cluster_sync();         // the partners have read buf
#pragma unroll
    for (int q = 0; q < kRowV; ++q) mine[T * q] = v[q];
    cluster_sync();
    const uint32_t peer = peer_addr(at, rank ^ h);
    const float sgn = (rank & h) ? -1.0f : 1.0f;
#pragma unroll
    for (int q = 0; q < kRowV; ++q)
      v[q] = __fmaf_rn(v[q], sgn, ld_peer(peer + 4 * T * q));
  }
}
"""


# the cluster kernel's wait for u (the row kernel has one alike)
_CLUSTER_WAIT = """    top_stages<SEG, C>(v);
    ndsc::scale_values(v, a.inv_sqrt_n);
    mbar_wait(&bar_u, parity_u);
"""


def _pairwise(src: str) -> str:
    """src with the pairwise exchange in place of the transposing one."""
    head = "template <int SEG, int C>\n__device__ inline void cluster_stages("
    start = src.index(head)
    end = src.index("\n}\n", start) + 3
    return _sub(src[:start] + PAIRWISE_STAGES + src[end:],
                "static constexpr int P = NS / C;",
                "static constexpr int P = NS;")


def variants() -> dict:
    """name -> (the text of quantencode.cu, exact)."""
    src = (_build.CSRC / "quantencode.cu").read_text()
    pairwise = _pairwise(src)
    seg15 = "constexpr int kClusterSeg = 15;"
    return {
        "kernel": (src, True),
        "pairwise": (pairwise, True),
        "seg15": (_sub(src, "constexpr int kClusterSeg = 14;", seg15), True),
        "pairwise_seg15": (_sub(pairwise, "constexpr int kClusterSeg = 14;",
                                seg15), True),
        "one_cta_per_sm": (_sub(
            src, "__launch_bounds__(RowShape<SEG>::T, RowShape<SEG>::BLOCKS)\n"
            "    encode_cluster_kernel",
            "__launch_bounds__(RowShape<SEG>::T, 1)\n"
            "    encode_cluster_kernel"), True),
        "u_per_value": (_sub(_sub(_sub(
            src, "    if (tid == 0) {\n      const float* ur = a.x + row * N;",
            "    if (false) {\n      const float* ur = a.x + row * N;"),
            _CLUSTER_WAIT, _CLUSTER_WAIT.replace(
                "    mbar_wait(&bar_u, parity_u);\n", "")),
            "rr[L::off_b(r)] = __fsub_rn(buf[tid + T * r], y);",
            "rr[L::off_b(r)] = __fsub_rn(a.x[row * N + pb + L::off_b(r)], "
            "y);"), True),
        "no_word_barrier": (_sub(
            src, "    // the CTA's own segment's words, written by the "
            "cluster: from L2\n    cluster_sync();\n", ""), False),
        "no_u": (_sub(_sub(_sub(
            src, "    if (tid == 0) {\n      const float* ur = a.x + row * N;",
            "    if (false) {\n      const float* ur = a.x + row * N;"),
            _CLUSTER_WAIT, _CLUSTER_WAIT.replace(
                "    mbar_wait(&bar_u, parity_u);\n", "")),
            "rr[L::off_b(r)] = __fsub_rn(buf[tid + T * r], y);",
            "rr[L::off_b(r)] = __fsub_rn(0.0f, y);"), False),
        "local_reads": (_sub(
            src, "v[r * I + i] = ld_peer(peer + 4 * T * i);",
            "v[r * I + i] = piece[T * i];"), False),
    }


def build(vs: dict) -> dict:
    """Every variant compiled at once; name -> (its ndsc_encode, its
    ndsc_encode_cluster_fit, ptxas's (registers, spill bytes) of its R 4
    cluster kernels)."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (text, _) in vs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.HEADERS:
            shutil.copy(_build.CSRC / f, d / f)
        (d / "quantencode.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "quantencode.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        _build.build_log["variant"] = log
        regs = {fn: (r, spill) for fn, r, spill in
                _build.register_report("variant")
                if fn.startswith("encode_cluster_kernel") and
                fn.endswith(f",{BITS}>")}
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.ndsc_encode
        fn.argtypes = _build._SIGNATURES["quantencode"]["ndsc_encode"]
        fn.restype = ctypes.c_int
        fit = lib.ndsc_encode_cluster_fit
        fit.argtypes = _build._SIGNATURES["quantencode"][
            "ndsc_encode_cluster_fit"]
        fit.restype = ctypes.c_int
        out[name] = (fn, fit, regs)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_cluster_variants: needs an NVIDIA GPU",
              file=sys.stderr)
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
        rw, rs, rr = ref.encode_ef(x, signs, BITS)
        want = [rw, rs.view(torch.int32), rr.view(torch.int32)]
        for name, (fn, fit, regs) in fns.items():
            def call(ef: bool, fn=fn):
                rc = fn(x.data_ptr(), signs.data_ptr(),
                        None if ef else dither.data_ptr(),
                        None if ef else mask.data_ptr(), words.data_ptr(),
                        scale.data_ptr(), resid.data_ptr() if ef else None,
                        rows, n, BITS, inv_sqrt(n), 0, 1.0, 0, stream)
                _build.check(rc, name)

            clusters = ctypes.c_int(0)
            cta = n // (1 << (15 if "seg15" in name else 14))
            _build.check(fit(cta, ctypes.byref(clusters)), f"{name} fit")
            out = {"n": n, "rows": rows, "variant": name,
                   "exact": vs[name][1], "cluster_ctas": cta,
                   "active_clusters": clusters.value,
                   "registers_spill_bytes": regs}
            for kind, ef in (("encode_ef", True), ("encode", False)):
                ms = cs.timed(lambda: call(ef), 5)
                out[kind] = {"ms": ms, "bound_ms": bounds[kind],
                             "share_of_bound": bounds[kind] / ms}
            call(True)
            got = [words, scale.view(torch.int32), resid.view(torch.int32)]
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            out["bitwise_plain"] = same
            print(json.dumps(out), flush=True)
            if vs[name][1] and not same:
                raise AssertionError(f"{name} differs from the plain "
                                     f"version at n {n}")
        del x, dither, resid, want, rw, rs, rr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
