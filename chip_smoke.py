"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     in parallel) and print the build seconds;
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version on the card:
     bits {1,2,4,8} × N {32, 256, 8192} × {plain, dither, mask} on
     unit-scale inputs, then at the shapes the training run gives it; time
     kernel, plain version and (for the FWHT) a dense x @ H matmul there;
  4. train yi-6b at full width (d_model 4096, 32/4 heads, d_ff 11008,
     vocab 64000) cut to 4 of its 32 layers: 3 steps at the launcher's
     defaults (batch 8, seq 128, R = 4, allgather_packed, error feedback);
     encode_ef, unpack_dequant and fwht must launch 12 times per step;
  5. 2 more steps with --dithered --keep-fraction 0.5 at 1 layer, which
     runs the plain encode kernel with its dither and mask;
  6. the reduced yi-6b for 2 steps on the card and on the CPU from the same
     weights and tokens: losses and parameters must agree;
  7. print {"kernels": [...]} and, last, the device line.

Without CUDA it exits non-zero before printing any result. Nothing here
imports JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

CHECK_BITS = (1, 2, 4, 8)
CHECK_N = (32, 256, 8192)
CHECK_MODES = ("plain", "dither", "mask")
EF_TOL = {torch.float32: 4e-6, torch.bfloat16: 4e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() on the card (CUDA events; one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as step_lib
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.train import train
    from repro_torch.models import model as model_lib
    from repro_torch.optimizer import optim

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    results = {}

    # -- 1. build -----------------------------------------------------------
    build_s = _build.build()
    log(f"[build] {len(_build.SOURCES)} CUDA sources built in {build_s:.2f}s")
    for name, text in _build.build_log.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}.cu: " + " | ".join(regs))

    # -- 2. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    # -- 3a. every kernel vs its plain version, sweep -------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = {"encode": 0.0, "encode_ef": 0.0, "unpack_dequant": 0.0,
           "fwht": 0.0}
    configs_checked = 0
    for bits in CHECK_BITS:
        for n in CHECK_N:
            rows = 64
            x = torch.randn(rows, n, generator=gen, device=dev)
            x = x / x.abs().amax(-1, keepdim=True)          # unit scale
            signs = torch.where(torch.rand(n, generator=gen, device=dev)
                                < 0.5, 1.0, -1.0)
            delta = 2.0 / 2 ** bits
            for mode in CHECK_MODES:
                dither = ((torch.rand(rows, n, generator=gen, device=dev)
                           - 0.5) * delta if mode == "dither" else None)
                mask = ((torch.rand(rows, 1, generator=gen, device=dev)
                         < 0.6).float() if mode == "mask" else None)
                kw, ks = ops.encode(x, signs, bits, dither=dither, mask=mask)
                rw, rs = ref.encode(x, signs, bits, dither=dither, mask=mask)
                if not (torch.equal(kw, rw) and torch.equal(
                        ks.view(torch.int32), rs.view(torch.int32))):
                    raise AssertionError(
                        f"encode payload differs: bits={bits} n={n} {mode}")
                for rdt, tol in EF_TOL.items():
                    kw2, ks2, kr = ops.encode_ef(x, signs, bits, dither=dither,
                                                 mask=mask, residual_dtype=rdt)
                    _, _, rr = ref.encode_ef(x, signs, bits, dither=dither,
                                             mask=mask, residual_dtype=rdt)
                    e = float((kr - rr).abs().max())
                    if not (torch.equal(kw2, rw) and torch.equal(ks2, rs)
                            and e <= tol):
                        raise AssertionError(
                            f"encode_ef differs: bits={bits} n={n} {mode} "
                            f"{rdt} residual err {e}")
                    if rdt == torch.float32:
                        err["encode_ef"] = max(err["encode_ef"], e)
                ku = ops.unpack_dequant(kw, ks, bits, n)
                ru = ref.unpack_dequant(kw, ks, bits, n)
                kf, rf = ops.fwht(x), ref.fwht(x)
                if not (torch.equal(ku, ru) and torch.equal(kf, rf)):
                    raise AssertionError(
                        f"unpack_dequant/fwht differ: bits={bits} n={n}")
                configs_checked += 1
    torch.cuda.synchronize()
    log(f"[check] {configs_checked} configs: payloads and FWHT/unpack "
        f"bitwise; EF residual max err f32 {err['encode_ef']:.3g} "
        f"(tol 4e-6), bf16 within 4e-3")

    # -- 3b. at the training run's shapes: check, time, bound ----------------
    def leaf_shapes(cfg):
        return tree_lib.leaves(model_lib.param_shapes(cfg),
                               is_leaf=lambda s: isinstance(s, tuple))

    full = configs.get("yi-6b")
    cfg4 = dataclasses.replace(full, num_layers=4)
    cfg1 = dataclasses.replace(full, num_layers=1)
    gc_ef = G.GradCompConfig(bits=4)
    gc_dk = G.GradCompConfig(bits=4, dithered=True, error_feedback=False,
                             keep_fraction=0.5)
    chunk, bits = gc_ef.chunk, gc_ef.bits

    def make_chunks(cfg, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        out = []
        for i, shape in enumerate(leaf_shapes(cfg)):
            c = -(-math.prod(shape) // chunk)
            out.append((torch.randn(c, chunk, generator=g, device=dev) * 1e-3,
                        G._frame_signs(i, gc_ef, dev)))
        return out

    leaves4 = make_chunks(cfg4, 1)
    coords4 = sum(u.numel() for u, _ in leaves4)
    rows4 = sum(u.shape[0] for u, _ in leaves4)
    log(f"[shapes] yi-6b x4 layers: {len(leaves4)} leaves, {coords4} "
        f"coordinates = {rows4} chunks of {chunk}")

    payloads = [ops.encode_ef(u, s, bits) for u, s in leaves4]
    for (u, s), (kw, ks, kr) in zip(leaves4, payloads):
        rw, rs, rr = ref.encode_ef(u, s, bits)
        e = float((kr - rr).abs().max())
        if not (torch.equal(kw, rw) and torch.equal(ks, rs)
                and e <= EF_TOL[torch.float32]):
            raise AssertionError(f"encode_ef differs at {tuple(u.shape)}")
        err["encode_ef"] = max(err["encode_ef"], e)
        ku = ops.unpack_dequant(kw, ks, bits, chunk)
        if not torch.equal(ku, ref.unpack_dequant(kw, ks, bits, chunk)):
            raise AssertionError(f"unpack_dequant differs at {tuple(u.shape)}")
        if not torch.equal(ops.fwht(ku), ref.fwht(ku)):
            raise AssertionError(f"fwht differs at {tuple(u.shape)}")
        del rw, rs, rr, ku
    decoded = [ops.unpack_dequant(kw, ks, bits, chunk)
               for kw, ks, _ in payloads]

    n_levels = math.log2(chunk)
    h = ref.fwht(torch.eye(chunk, device=dev))              # dense H
    t = {}
    t["encode_ef"] = (
        timed(lambda: [ops.encode_ef(u, s, bits) for u, s in leaves4]),
        timed(lambda: [ref.encode_ef(u, s, bits) for u, s in leaves4], 3),
        None)
    t["unpack_dequant"] = (
        timed(lambda: [ops.unpack_dequant(w, s, bits, chunk)
                       for w, s, _ in payloads]),
        timed(lambda: [ref.unpack_dequant(w, s, bits, chunk)
                       for w, s, _ in payloads], 3),
        None)
    t["fwht"] = (timed(lambda: [ops.fwht(x) for x in decoded]),
                 timed(lambda: [ref.fwht(x) for x in decoded], 3),
                 timed(lambda: [x @ h for x in decoded]))
    bounds = {
        # read u, write words + scale + residual; 2 FWHTs, quantize, decode
        "encode_ef": bound_ms(coords4 * (4 + bits / 8 + 4) + rows4 * 4,
                              coords4 * (2 * (n_levels + 1) + 12)),
        # read words + scale, write f32 values
        "unpack_dequant": bound_ms(coords4 * (bits / 8 + 4) + rows4 * 4,
                                   coords4 * 4),
        # read and write f32; log2 N add/sub levels + 1 scaling multiply
        "fwht": bound_ms(coords4 * 8, coords4 * (n_levels + 1)),
    }
    del payloads, decoded, leaves4

    leaves1 = make_chunks(cfg1, 2)
    coords1 = sum(u.numel() for u, _ in leaves1)
    rows1 = sum(u.shape[0] for u, _ in leaves1)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    delta = 2.0 / 2 ** bits
    draws = [((torch.rand(u.shape, generator=g, device=dev) - 0.5) * delta,
              (torch.rand(u.shape[0], 1, generator=g, device=dev)
               < 0.5).float()) for u, _ in leaves1]
    for (u, s), (d, m) in zip(leaves1, draws):
        kw, ks = ops.encode(u, s, bits, dither=d, mask=m)
        rw, rs = ref.encode(u, s, bits, dither=d, mask=m)
        if not (torch.equal(kw, rw) and torch.equal(ks, rs)):
            raise AssertionError(f"encode differs at {tuple(u.shape)}")
    t["encode"] = (
        timed(lambda: [ops.encode(u, s, bits, dither=d, mask=m)
                       for (u, s), (d, m) in zip(leaves1, draws)]),
        timed(lambda: [ref.encode(u, s, bits, dither=d, mask=m)
                       for (u, s), (d, m) in zip(leaves1, draws)], 3),
        None)
    # read u, dither, mask; write words + scale; FWHT, scale, dither, quantize
    bounds["encode"] = bound_ms(coords1 * (4 + 4 + bits / 8) + rows1 * 8,
                                coords1 * ((n_levels + 1) + 10))
    del leaves1, draws
    torch.cuda.empty_cache()

    for name in ("encode", "encode_ef", "unpack_dequant", "fwht"):
        ms, plain_ms, lib_ms = t[name]
        b, by = bounds[name]
        results[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": b, "bound_by": by,
                         "max_abs_err": err[name]}
        log(json.dumps({"kernel": name, **results[name],
                        "shapes": "yi-6b x1 layer, dithered, keep 0.5"
                        if name == "encode" else "yi-6b x4 layers"}))

    # -- 4. the main path: full-width yi-6b, 4 layers, launcher defaults -----
    per_step = []

    def count_step(step, metrics):
        counts = ops.launch_counts()
        per_step.append(counts)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"non-finite loss at step {step}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, losses, secs = train(cfg4, steps=3, batch_size=8, seq_len=128,
                                 gc=gc_ef, lr=3e-4, log_every=1, device=dev,
                                 on_step=count_step)
    main_counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prev = {k: 0 for k in main_counts}
    for s, counts in enumerate(per_step):
        for k in ("encode_ef", "unpack_dequant", "fwht"):
            if counts[k] - prev[k] != 12:
                raise AssertionError(
                    f"step {s}: {k} launched {counts[k] - prev[k]} times, "
                    "want 12 (one per parameter leaf)")
        prev = counts
    if main_counts["encode"] != 0:
        raise AssertionError("the EF path launched the plain encode kernel")
    if not all(bool(torch.isfinite(p).all())
               for p in tree_lib.leaves(params)):
        raise AssertionError("non-finite parameters after training")
    log(f"[train x4] losses {losses} step_s {secs} launches {main_counts} "
        f"peak_mem_GB {peak_gb:.2f}")
    del params
    torch.cuda.empty_cache()

    # -- 5. dithered, keep 0.5, 1 layer: the plain encode kernel --------------
    ops.reset_launch_counts()
    params, losses1, secs1 = train(cfg1, steps=2, batch_size=8, seq_len=128,
                                   gc=gc_dk, lr=3e-4, log_every=1,
                                   device=dev)
    dk_counts = ops.launch_counts()
    if dk_counts["encode"] != 24 or dk_counts["encode_ef"] != 0:
        raise AssertionError(f"dithered path launches {dk_counts}")
    if not all(math.isfinite(v) for v in losses1):
        raise AssertionError(f"non-finite dithered losses {losses1}")
    log(f"[train x1 dithered keep0.5] losses {losses1} step_s {secs1} "
        f"launches {dk_counts}")
    del params
    torch.cuda.empty_cache()

    # -- 6. small input: the card vs the CPU's plain versions -----------------
    small = configs.get_reduced("yi-6b")
    lr = 3e-4
    states, step_fns = {}, {}
    for d in ("cpu", "cuda"):
        opt = optim.adamw(optim.warmup_cosine(lr, 1, 10), weight_decay=0.1)
        step_fns[d] = step_lib.make_train_step(small, opt, gc_ef,
                                               clip_norm=1.0)
        p, o, e = step_lib.init_train_state(small, opt, gc_ef, seed=0)
        states[d] = tuple(tree_lib.map(lambda x: x.to(d), s)
                          for s in (p, o, e))
    tg = torch.Generator()
    tg.manual_seed(4)
    for s in range(2):
        toks = torch.randint(0, small.vocab_size, (2, 17), generator=tg,
                             dtype=torch.int32)
        out = {}
        for d in ("cpu", "cuda"):
            *states[d], m = step_fns[d](*states[d], {"tokens": toks.to(d)})
            out[d] = float(m["loss"])
        diffs = torch.cat([(a - b.cpu()).abs().flatten() for a, b in zip(
            tree_lib.leaves(states["cpu"][0]),
            tree_lib.leaves(states["cuda"][0]))])
        log(f"[small] step {s}: loss cpu {out['cpu']} cuda {out['cuda']} "
            f"max|dparam| {float(diffs.max()):.3g} "
            f"median {float(diffs.median()):.3g}")
        # f32 sums differ in order between CPU and card; a coordinate whose
        # code lands in the next bin moves Adam's step by up to ~2 lr
        if not (abs(out["cpu"] - out["cuda"]) <= 1e-4 * abs(out["cpu"])
                and float(diffs.max()) <= 3 * lr * (s + 1)
                and float(diffs.median()) <= 1e-6):
            raise AssertionError("card and CPU disagree on the small input")

    # -- 7. result lines --------------------------------------------------------
    names = {
        "encode": ("src/repro_torch/csrc/quantencode.cu",
                   "src/repro/kernels/quantencode.py:200", dk_counts),
        "encode_ef": ("src/repro_torch/csrc/quantencode.cu",
                      "src/repro/kernels/quantencode.py:218", main_counts),
        "unpack_dequant": ("src/repro_torch/csrc/quantpack.cu",
                           "src/repro/kernels/quantpack.py:94", main_counts),
        "fwht": ("src/repro_torch/csrc/fwht.cu",
                 "src/repro/kernels/fwht.py:43", main_counts),
    }
    kernels = []
    for name, (src, replaces, counts) in names.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    record = {"card": card, "build_s": build_s, "kernels": kernels,
              "train_x4": {"losses": losses, "step_s": secs,
                           "peak_mem_GB": peak_gb},
              "train_x1_dithered": {"losses": losses1, "step_s": secs1}}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
