"""Where the FWHT's time goes above N = 8192: variants of its kernels timed
side by side on one card.

    python3 tools/fwht_variants.py [NAME ...]

Each variant is a copy of `src/repro_torch` with one textual change to
`csrc/fwht.cu` or `kernels/fwht.py`, written to
`build/fwht_variants/<name>/src/` (it builds its own library there) and
timed in a process of its own, in turns: the variants in order, then the
unchanged kernel again. All of them give `ref.fwht`'s bits ("exact" is
checked at every shape): `store_a` stores the row kernel's output through
a second exchange as float4s of layout A instead of straight from layout
B; `first14` starts the passes from 2^16 with the row kernel at 2^14 (two
blocks an SM) instead of 2^15 (one); `two_blocks` and `four_blocks` run the
later passes at two or four blocks an SM instead of three (128 or 64
registers a thread instead of 80); `stage_tma` keeps a later pass's next
tile in flight by TMA bulk copies (one per contiguous run of W floats,
into 32 KB of dynamic shared memory beside the exchange's, completing on
an mbarrier) while the current one runs,
instead of loading each tile straight into registers. Each times the FWHT
at chip_smoke.py
phase 3f's shapes (LARGE_LIB_SHAPES and one row of each
checks.FWHT_HUGE_N; CUDA events, median of 5) beside the bound of
kernels/cost.py, and the device time of each kernel of a call
(torch.profiler over 5 calls). Prints the card's name and power limit,
then per variant its kernels' registers and spills (ptxas) and one JSON
object per shape.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "fwht_variants"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise AssertionError(f"variant patch not found: {old!r}")
    return text.replace(old, new)


def variants() -> dict:
    """name -> {file under src/repro_torch: its text}."""
    cu_path, py_path = "csrc/fwht.cu", "kernels/fwht.py"
    cu = (ROOT / "src/repro_torch" / cu_path).read_text()
    py = (ROOT / "src/repro_torch" / py_path).read_text()
    b_store = cu[cu.index("    float* o = a.out + row_base + col + tid;"):
                 cu.index("    // the next segment writes buf only after")]
    a_store = """    __syncthreads();                 // every thread has read buf
    ndsc::to_a<T>(v, buf, a0);
    if (a.last) ndsc::scale_values(v, a.inv_sqrt_n);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(a.out + row_base + col + a0 + 128 * j) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
"""
    # stage_tma: the next tile in flight by TMA bulk copies, one per
    # contiguous run of W floats, into a dynamic staging buffer
    staged = _sub(_sub(_sub(_sub(_sub(
        cu, "  __shared__ float xbuf[K > 5 ? kColsTile : 1];   // the exchange "
            "(K > 5)\n",
        """  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* xbuf = stage + kColsTile;                // (K > 5)
  __shared__ uint64_t bar;
"""),
        "  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {\n",
        """  auto issue = [&](int64_t t) {
    const int s = a.first_stage;
    const int64_t row = t >> tiles_log;
    const int ti = static_cast<int>(t - (row << tiles_log));
    const int col0 = ((ti >> cb_log) << (s + K)) +
                     ((ti & ((1 << cb_log) - 1)) << LW);
    const float* src = a.in + (row << a.log2n) + col0;
    if (lane == 0) ndsc::mbar_expect(&bar, kColsTile * 4);
    __syncwarp();
    for (int m = lane; m < (1 << K); m += 32)
      ndsc::bulk_copy(stage + m * W, src + (static_cast<int64_t>(m) << s),
                      W * 4, &bar);
  };
  if (tid == 0) ndsc::mbar_init(&bar);
  __syncthreads();
  if (warp == 0 && blockIdx.x < tiles) issue(blockIdx.x);
  uint32_t parity = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
"""),
        """#pragma unroll
    for (int i = 0; i < ndsc::kRowV; ++i)
      v[i] = in[((i & ((1 << KR) - 1)) << s) + ((i >> KR) << 5)];
""",
        """    ndsc::mbar_wait(&bar, parity);
    parity ^= 1u;
#pragma unroll
    for (int i = 0; i < ndsc::kRowV; ++i)
      v[i] = stage[e1 + ((i & ((1 << KR) - 1)) << LW) + ((i >> KR) << 5)];
    __syncthreads();
    if (warp == 0 && t + gridDim.x < tiles) issue(t + gridDim.x);
"""),
        "      __syncthreads();               // every thread has read the "
        "last xbuf\n", ""),
        """      fwht_cols_kernel<K>, kColsThreads, 0, &cache, &fit);""",
        """      fwht_cols_kernel<K>, kColsThreads, smem, &cache, &fit);""")
    staged = _sub(_sub(
        staged, "fwht_cols_kernel<K><<<blocks, kColsThreads, 0, stream>>>(a);",
        "fwht_cols_kernel<K><<<blocks, kColsThreads, smem, stream>>>(a);"),
        "int launch_cols(const PassArgs& a, cudaStream_t stream) {\n",
        "int launch_cols(const PassArgs& a, cudaStream_t stream) {\n"
        "  constexpr int smem = (K > 5 ? 2 : 1) * kColsTile * 4;\n")
    return {
        "kernel": {},
        "store_a": {cu_path: _sub(cu, b_store, a_store)},
        "first14": {py_path: _sub(py, "FIRST_PASS_STAGES = 15",
                                  "FIRST_PASS_STAGES = 14")},
        "two_blocks": {cu_path: _sub(cu, "constexpr int kColsBlocks = 3;",
                                     "constexpr int kColsBlocks = 2;")},
        "four_blocks": {cu_path: _sub(cu, "constexpr int kColsBlocks = 3;",
                                      "constexpr int kColsBlocks = 4;")},
        "stage_tma": {cu_path: staged},
    }


def write_tree(name: str, files: dict) -> Path:
    dst = OUT / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in files.items():
        (dst / "repro_torch" / rel).write_text(text)
    return dst


def time_tree(src: Path, name: str) -> None:
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, checks, ops, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fwht as F

    _build.build(("fwht",))
    print(json.dumps({"variant": name, "registers": [
        r for r in _build.register_report("fwht")
        if r[0].startswith(("fwht_row", "fwht_cols"))]}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    shapes = list(cs.LARGE_LIB_SHAPES) + [(n, 1) for n in checks.FWHT_HUGE_N]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for n, rows in shapes:
        x = torch.randn(rows, n, generator=g, device=dev)
        exact = torch.equal(ops.fwht(x), ref.fwht(x))
        ms = cs.timed(lambda: ops.fwht(x))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                ops.fwht(x)
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / 1e3 / 5
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        b, by = cs.bound_ms(*kcost.fwht(x.numel(), n))
        print(json.dumps({
            "variant": name, "shape": [rows, n], "exact": exact, "ms": ms,
            "bound_ms": b, "share_of_bound": b / ms,
            "plan": F.fwht_plan(n.bit_length() - 1),
            "device_ms_per_kernel": kernels}), flush=True)
        del x
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("fwht_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--run"]:
        time_tree(Path(sys.argv[2]), sys.argv[3])
        return 0
    vs = variants()
    names = sys.argv[1:] or list(vs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = {name: write_tree(name, vs[name]) for name in names}
    order = names + (["kernel"] if "kernel" in names else [])
    for name in order:                       # one process per variant
        rc = subprocess.run([sys.executable, __file__, "--run",
                             str(trees[name]), name]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
