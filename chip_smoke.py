"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero; each
prints its seconds):
  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     in parallel); print the build seconds and each kernel's registers and
     spilled bytes (ptxas);
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version on the card:
     a. the codec kernels and the FWHT, bitwise (words, scales, the f32 and
        bf16 EF residuals, unpack_dequant, FWHT) over bits {1,2,4,8} ×
        N {32, 64, ..., 8192} × {det, dither, mask, rescale} × rows
        {1, 37, 1031}, with an all-zero row and rows whose only value or
        maximum sits in the last lane, unaligned inputs in det mode; the
        FWHT alone at N {1, 2, 4, 8, 16}; and unpack_dequant alone on words
        over the whole int32 range, aligned and not, over bits × rows ×
        (n, N) {whole rows of 32, 256, 8192 (the flat path); whole rows
        of 96, 12288 (a wpr not a power of two) and 255, 128 and 1 of 256
        or 32 (trimmed rows), the row path}; above N = 8192 (the FWHT's
        and the encoders' passes) the codec kernels and the FWHT the same
        way over bits × N {16384, 32768, 2^20} × the four modes × rows
        {1, 37};
     b. quantize_pack (bitwise) over bits × N {32, 128, 256, 8192, 12288}
        × rows {1, 37, 1031}, with a zero scale and a row whose maximum
        sits in its last lane, from aligned and unaligned x (the flat
        float4 stream; the row kernel at 12288), and quant_decode_attention (within 2e-4) over bits × dh {32, 64, 128, 256}
        × C {1, 100, 512, 1000, 4096, 4097} × G {1, 8} with kv_len {0, 1,
        C, ragged} (so one split, several, a ragged last one and splits
        wholly past kv_len) and packed words over the whole int32 range,
        at the served families' (dh, G) (64, 5) (hymba) and (128, 6)
        (mixtral) × the same C, and at the (dh, G) the shared-memory tile
        kernel takes (16, 8), (128, 12), (512, 2) × C {1, 100, 1000};
     c. at the shapes the training run gives the codec kernels: check,
        time kernel, plain version and (for the FWHT) a dense x @ H matmul,
        and beside unpack_dequant `zero_()` of its outputs ("zero_ms": the
        card's own write stream of those bytes);
     d. the FWHT (bitwise, with a dense x @ H beside it, and the host's
        microseconds per call of both: 1000 calls, then one synchronize) at
        the serve run's decode K/V, decode query and prefill K/V shapes
        (dh 128),
        quantize_pack at its decode and prefill shapes (at decode also
        its device time under torch.profiler and the host's microseconds
        per call) and
        quant_decode_attention at the serve shape (kv_len C and the serve
        run's fill of 96, with the host's microseconds per call) and a
        long-context shape: check and time kernel and plain version (and,
        for quant_decode_attention, the device time under torch.profiler);
     (the sweep grids and inputs of a and b come from
     repro_torch.kernels.checks,
     which tests/test_torch_cuda.py shares);
     f. above N = 8192: the FWHT (bitwise, with its pass count and bound)
        on one row of 2^23, 2^26 and 2^28 (the dsc codec's frames of
        yi-6b; no library time: H does not fit) and at (4096, 16384) and
        (2048, 32768) beside a dense x @ H (H 1 GiB and 4 GiB); encode_ef
        and the dithered, masked encode at chunk 16384 on the 1-layer
        yi-6b tree's leaves (phase 5b's shapes), checked bitwise, timed
        and bounded, with their launches per tree;
  4. train yi-6b at full width (d_model 4096, 32/4 heads, d_ff 11008,
     vocab 64000) cut to 4 of its 32 layers: 3 steps at the launcher's
     defaults (batch 8, seq 128, R = 4, allgather_packed, error feedback);
     encode_ef, unpack_dequant and fwht must launch 12 times per step;
  5. 2 more steps with --dithered --keep-fraction 0.5 at 1 layer, which
     runs the plain encode kernel with its dither and mask;
  5b. 2 steps at 1 layer with chunk 16384 (R 4, allgather_packed, EF):
     encode_ef, unpack_dequant and fwht (all through their passes) must
     launch 12 times per step; finite loss and params; the wq leaf's
     words, scales and EF residual (first and last 64 chunks) bitwise its
     CPU encode;
  6. the reduced yi-6b for 2 steps on the card and on the CPU from the same
     weights and tokens: losses and parameters must agree;
  7. serve yi-6b at full width and all 32 layers through the 8-bit NDSC KV
     cache: an Engine with 4 slots and max_seq 512, one 64-token prefix
     prefilled, 8 requests (4 with the prefix and a 16-token suffix, 4 cold
     with 80-token prompts), 16 new tokens each. Launches are counted
     around the public calls (register_prefix, each Engine.step): every
     decode step must launch quant_decode_attention 32 times, quantize_pack
     64 and fwht 96; every prefill quantize_pack and fwht 64 times each;
     one more decode step under torch.profiler gives the device's busy
     time; the serve step on the final state gives finite logits; then the
     prefix contract, bitwise on the card, for the 8-bit and the f32 cache.
     Since PR 23 the engine's programs are CUDA graphs (repro_torch.graph):
     a first call runs eagerly and captures, later calls replay, and the
     launches counted are the device's;
  8. the reduced yi-6b served on the card and on the CPU from the same
     weights and prompts: logits within a stated tolerance, greedy tokens
     equal;
  9. the paper's algorithms (repro_torch.core, Algs. 1-3) at the §5
     protocols' sizes, the same port code on the CPU and on the card, data
     and Haar frames made once on the CPU, Hadamard frames drawn on each
     device (signs and rows must agree): a. Alg. 1 (fig1b: n 116, m 200,
     120 steps, R 1, 2, 4, 8; GD, DQGD, naive EF-QGD, DGD-DEF NDE-Hadamard
     at N 128 and DE-Haar), rates within 1e-3; b. Alg. 2 (fig2: SVM, n 30,
     m 100, 600 steps), final hinge loss within 1e-3 relative; c. Alg. 3
     (fig3: 10 workers, n 30, 1500 steps, R 0.5, 1, 4; DSC-Haar,
     NDSC-Haar, NDSC-Hadamard at N 32), x_avg within 1e-4 relative; d. the
     codec error (fig1a: n 1000, 20 trials, R 1-6, NDE-Hadamard N 1024 and
     NDE-Haar) within 1e-4, Hadamard payloads bitwise; e. embedding times
     at n 1024, 4096, 8192 (fig1c) and one DGD-DEF step's host µs; f. the
     FWHT launches (> 0 in a, c, d) and seconds of each sub-phase;
 10. codecs and federation (repro_torch.codecs, repro_torch.fed): a. each
     wire codec (ndsc R 2 and R 0.5 with exact keep, ndsc's encode_ef,
     ratq R 2, sparsify_then_embed top-k and rand-k at R 1, 4 bits, dsc
     R 2 and R 0.5 (a Hadamard frame per leaf, 11 of 12 leaves over N 8192,
     up to 2^28), ndsc R 2 at chunk 16384) on the
     parameter tree of yi-6b at full width cut to 4 layers (12 leaves,
     1,216,385,024 seeded values): encode, decode and encode_ef ms (CUDA
     events, medians of 3), each kernel's launches per call and the peak
     memory; the ledger equal to the audit to the byte (dsc at R 0.5, whose
     audit is the expected count of a Bernoulli keep: within 6 standard
     deviations), finite decodes, and on one 4096-wide leaf (and for dsc
     the (4, 4096, 512) leaf, N 2^23) the card's payload bitwise the CPU's;
     b.
     benchmarks/fed_heterogeneous at its own size (m 8, dim 128, 256
     examples per client, 50 rounds, norm-proportional budgets around
     R̄ = 1, chunk 64), fedavg and fedmem at 50% participation with 20%
     stragglers, card against the port's CPU run: the ledger and the
     participants identical, params within 1e-4 relative (the loss summed
     in f64; the f32 loss's gap reported), and cohort against scalar
     bitwise on the card; c. fed_cohort_scaling's m 512 (dim 128, 32 per
     client, ndsc R 2): a round cohort against scalar bitwise, one
     encode_ef and one unpack_dequant launch per leaf per cohort round,
     rounds per second on the card and the CPU; d. fed_aggregate_scaling's
     tree (dim 1024) at m 512: sequential aggregate_stacked bitwise the
     list aggregate (fedavg, fedopt), with pairwise's gap and each
     layout's ms;
     e. (in phase 3) quantize_pack at the RATQ train shape: the 12 leaves
     of the 4-layer tree in chunks of 128 at R 2 (one RATQ encode's 12
     launches), checked bitwise, timed with its bound;
 11. distributed consensus and the mesh federation (repro_torch.dist,
     repro_torch.fed.mesh): a. one NCCL rank in this process at phase 4's
     size: 2 steps of launch.train.train(group=...) bitwise the same 2
     steps with group=None (loss and params), then alltoall_zero1 against
     allgather_packed (AdamW, no clip) bitwise after one step, with s/step
     and launches per step (12 encode_ef, unpack_dequant and fwht for the
     all-gather; 12 encode and 24 unpack_dequant and fwht for ZeRO-1);
     b-d. four ranks sharing the card (this script with --rank, fresh
     interpreters on a file:// store, gloo by the backend rule), results
     in OUT_DIR/dist/: b. yi-6b at full width cut to 1 layer
     (697,315,328 values, 12 leaves), global batch 8, seq 128, R 4, chunk
     256, SGD without clip, 2 steps of each of psum, psum_decoded,
     allgather_packed with EF and alltoall_zero1: every rank's params
     bitwise equal after each step, ZeRO-1 equal to all-gather after one
     step, the payload bytes a worker puts into the all-gather equal to
     wire_bytes_tree's to the byte, the words gathered from each rank of
     a 4096-wide leaf bitwise its own; each rank's peak memory, s/step,
     seconds in the collectives (gloo over loopback on one card: nothing
     of NCCL) and launches per step; c. the reduced yi-6b at m 4 on the
     card and on the CPU from the same weights and tokens, 2 steps of
     allgather_packed with EF, within phase 6's bounds; d.
     fed_cohort_scaling's m 512 under backend="mesh" (128 lanes a rank):
     bitwise the single-process vmap backend on the card (ledger and
     params), one encode_ef and one unpack_dequant launch per round on
     each rank, pairwise's gap and rounds per second; fed_heterogeneous
     (phase 10b's runs) under the mesh backend: ledger and participants
     equal to the vmap backend's;
 13. the other block families (models/{moe,ssm,xlstm}), after phase 11:
     a. mixtral-8x22b at full width (d_model 6144, 48/8 heads, 8 experts
     top-2, d_ff 16384, vocab 32768, window 4096) cut to 4 of its 56
     layers (10,418,903,040 values), served through the 8-bit cache with
     phase 7's traffic and checks (launches per decode step 4, 8, 12; per
     prefill 8 and 8), with its weight-read floor; b. the same cut to 1
     layer (2,906,720,256 values, 13 leaves) trained 2 steps of
     allgather_packed with EF (R 4, chunk 256, batch 8, seq 128) with SGD
     and no clip (AdamW's functional update does not fit the card at this
     size): 13 launches of encode_ef, unpack_dequant and fwht per step,
     finite loss and params, and the e_gate leaf's words, scales and EF
     residual on rows across and past 2^31 bytes into the leaf bitwise its
     CPU encode; c. hymba-1.5b at full width and all 32 layers through
     the 8-bit cache, 4 cold 32-token prompts (its prefill steps decode),
     launches per decode step 32, 64, 96, the prefix contract bitwise; d.
     the reduced mixtral, arctic, hymba and xlstm on the card and on the
     CPU from the same weights: 2 train steps within phase 6's bounds,
     served past the window of 64 (logits within SMALL_LOGIT_TOL, greedy
     tokens equal), and two card runs of the MoE forward and backward
     bitwise; e. xlstm-350m at full width and all 24 layers, 2 steps of
     launch.train.train (15 launches per kernel per step);
 14. checkpointing and observability (repro_torch.checkpoint,
     repro_torch.obs), after phase 13: a. fed_heterogeneous at its own
     size (phase 10b's problem and budgets, adaptive norm-proportional
     re-allocation every 10 rounds), fedavg and fedmem at 50%
     participation with 20% stragglers: 25 rounds, save_federation, a
     fresh Federation restored, 25 more; ledger, participants, params and
     client states bitwise the uninterrupted 50 rounds, the resumed
     rounds' encode_ef, unpack_dequant and fwht launches equal to its
     rounds 26-50; b. fed_cohort_scaling's m 512 the same way (2 + 2
     rounds, one encode_ef and one unpack_dequant launch per resumed
     round), and in phase 11d's ranks the mesh run again under an obs
     session on every rank: bitwise the obs-off run, fed.round spans and
     fed.* counters on each rank, fed.round.mesh and fed.aggregate.mesh
     registered; c. phase 7's traffic under obs.enable(memory, jsonl,
     trace) (files in OUT_DIR/obs/), the programs made anew: tokens and
     cache leaves bitwise phase 7's, every step's kernels.dispatch counts
     equal to its launches less those its graphs replayed plus those its
     captures recorded (32 / 64 / 96 launches per decode step), the
     session's serve.* recompiles equal to the programs'
     specializations, the trace valid, serve.ttft_s for both
     admission kinds, the kernels' costs equal to phase 3d's bound bytes at
     the same shapes; the decode step's median with obs off and on, 16
     rounds of steps in turns (with three arms that split "on": the
     memory sink alone, with the cost capture, with the JSONL and trace
     sinks; the collector's pauses per arm; the host µs of one
     dispatch's record), and TTFT by admission kind; d. phase 4's
     train step (4 layers) with obs on, bitwise 2 obs-off steps from the
     same state, dist.payload_bytes equal to wire_bytes_tree's payload, 12
     dispatches per kernel per step; e. launch.train with ckpt_dir at 1
     layer (697,315,328 values; params and AdamW moments ~8.4 GB): 1 step,
     saved, restored into a fresh template bitwise, save and restore
     seconds and GB/s (a temporary directory outside the repository,
     removed); f. the m 512 round loop, 20 rounds each with obs off and
     on in turns: the ratio of their trimmed means (recorded, not gated);
 15. the captured serve programs (repro_torch.graph), after phase 14: a.
     phase 7's traffic on yi-6b x32, 13a's on mixtral x4 and 13c's on
     hymba again inside graph.eager(), from the same seeded weights:
     tokens and every cache leaf bitwise the captured runs', launches per
     step checked in both; b. two engines over yi-6b x32, 4 cold requests
     each: the second's graphs its own, its tokens and caches the first's,
     the first's caches untouched; c. for each of the three models a
     decode step of 4 busy slots, GRAPH_ROUNDS rounds graph and eager in
     turns: host-clock ms, host µs of the decode program's call and of
     its graph's replay() alone, one profiled step of each (device busy
     ms, ops), then the model's traffic three times on that engine
     (graph, eager, graph: TTFT by admission kind with warm graphs), each
     program's capture seconds and the graph pool's bytes; d. is 14c
     (obs under graphs);
 16. serving across workers (the "model" axis: dist.step.make_serve_step
     on a launch.mesh.make_host_group mesh, tensor parallelism over
     gloo ranks sharing the card), after phase 15; the one-worker runs
     first in this process (the serve step's graph, the same seeded
     weights and prompts), then a world of 2 and a world of 4 ranks of
     this script (--phase 16; logs in OUT_DIR/tp/): a. yi-6b at full
     width and all 32 layers, 4 slots, model 2, with the f32 and the
     8-bit cache: each rank draws its slices leaf by leaf and holds
     exactly the spec's param bytes; a 16-token prompt, then 16 tokens:
     with the f32 cache its own greedy ones, equal to one worker's,
     logits within TP_LOGIT_TOL; with the 8-bit cache one worker's
     (phase 16's comment says why), logits within TP_CODE_LOGIT_TOL, a
     greedy choice differing only where one worker's top-2 margin is
     within TP_NEAR_TIE, and then its own greedy ones, equal to one
     worker's up to each slot's first differing choice, which must be
     such a near-tie (its step and margin printed), quant_decode_attention,
     quantize_pack and fwht launching 32, 64, 96 times per step on every
     rank; s/step, seconds in the collectives per step, peak memory per
     rank, and one worker's own logit shift with wo one ulp away; b. the
     same at model 4, cut to 8 layers; c. the reduced mixtral
     (expert-parallel), arctic, hymba and xlstm at model 2 and the
     reduced yi-6b and mixtral (its routing gathered over the data
     group) at (data 2, model 2), 8-bit: greedy tokens equal,
     logits within SMALL_LOGIT_TOL; d. the reduced yi-6b trained 2 steps
     of allgather_packed with EF at (2, 2) and at (2, 1): every rank's
     whole params and AdamW state bitwise equal;
 12. print {"kernels": [...]} and, last, the device line.

Without CUDA it exits non-zero before printing any result. Nothing here
imports JAX or the JAX package. `python3 chip_smoke.py --rank R --world 4
--init URL --out DIR [--phase 16]` is one rank of phase 11 b-d (or 16),
which the script starts itself.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# the sweep grids (bits, N, rows, modes, dh, C, G) and ATTN_TOL live in
# repro_torch/kernels/checks.py, shared with tests/test_torch_cuda.py
EF_TOL = {torch.float32: 4e-6, torch.bfloat16: 4e-3}
# the serve run: yi-6b, 32 layers, 8-bit NDSC KV cache
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_BITS, SERVE_NEW = 4, 512, 8, 16
PREFIX_LEN, SUFFIX_LEN, COLD_LEN = 64, 16, 80
# timed shapes of the serving kernels: quantize_pack rows (B·K at decode,
# 4·32768·4 at a prefill) of N = 128; quant_decode_attention (B, C,
# kv_len) at the serve run's shape, full and at the fill its decode steps
# reach (under 96 positions), and at a long context, yi-6b's K 4, G 8,
# dh 128
PACK_TIME_SHAPES = (("decode", (SERVE_SLOTS, 1, 4, 128)),
                    ("prefill", (4, 32768, 4, 128)))
ATTN_TIME_SHAPES = (("serve", (SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_MAX_SEQ)),
                    ("serve_kv96", (SERVE_SLOTS, SERVE_MAX_SEQ, 96)),
                    ("long", (32, 32768, 32768)))
# the FWHT on the serve path: K/V rows at a decode step (B, 1, K, dh), the
# query rows (B, K, G, dh), and K/V rows of a cold 80-token prefill
FWHT_TIME_SHAPES = (("decode_kv", (SERVE_SLOTS, 1, 4, 128)),
                    ("decode_q", (SERVE_SLOTS, 4, 8, 128)),
                    ("prefill_kv", (1, COLD_LEN, 4, 128)))
# card vs CPU on the reduced model: a code that lands in the neighbouring
# bin moves one cached value by 2/256 of its vector's scale
SMALL_LOGIT_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """`done(name)` prints the seconds since the previous phase ended."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        log(f"[phase] {name} {now - self.t:.2f}s")
        self.t = now


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


def device_ms(fn, calls: int = 20):
    """Device milliseconds per call of fn: the time of the kernels it
    launches under torch.profiler, over `calls` calls, without the host's
    launch time that a CUDA-event timing of one small call holds ("not
    measured" if the profiler sees no device time)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return "not measured"
    return sum(e.self_device_time_total for e in kern) / 1e3 / calls


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of fn: `calls` calls, then one
    synchronize (the card finishes each call before the host issues the
    next one when the host is the slower side)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def bound_ms(nbytes: float, flops: float) -> tuple:
    """The least time of a call: its bytes at the card's memory rate or
    its operations at its f32 rate, whichever is longer (kernels/cost.py's
    H100 SXM data-sheet peaks)."""
    from repro_torch.kernels import cost
    t_bytes = nbytes / cost.PEAK_BYTES_S * 1e3
    t_ops = flops / cost.PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_serve_kernels(dev) -> tuple:
    """quantize_pack bitwise and quant_decode_attention within ATTN_TOL
    over the sweep; returns (configs checked, attention max abs error)."""
    from repro_torch.kernels import checks
    n_cfg, err = 0, 0.0
    for bits in checks.BITS:
        for n in checks.PACK_N:
            checks.check_quantize_pack(n, bits, dev)
            n_cfg += 1
    for bits in checks.BITS:
        for dh in checks.ATTN_DH:
            for c in checks.ATTN_C:
                for g in checks.ATTN_G:
                    err = max(err, checks.check_quant_decode_attention(
                        bits, dh, c, g, dev))
                    n_cfg += 1
        for dh, g in checks.ATTN_FAMILY_SHAPES:
            for c in checks.ATTN_C:
                err = max(err, checks.check_quant_decode_attention(
                    bits, dh, c, g, dev))
                n_cfg += 1
        for dh, g in checks.ATTN_TILE_SHAPES:
            for c in checks.ATTN_TILE_C if dh * bits % 32 == 0 else ():
                err = max(err, checks.check_quant_decode_attention(
                    bits, dh, c, g, dev))
                n_cfg += 1
    torch.cuda.synchronize()
    return n_cfg, err


def time_serve_kernels(ops, ref, dev) -> dict:
    """The serving kernels at the serve run's shapes, checked, timed and
    bounded: the FWHT (bitwise; dense x @ H as the library call) at
    FWHT_TIME_SHAPES, kernels 5 and 6 at PACK_TIME_SHAPES and
    ATTN_TIME_SHAPES, 8 bits; kernel 6's device time under the profiler,
    and the host's microseconds per call at the serve shape."""
    from repro_torch.kernels import checks
    from repro_torch.kernels import cost as kcost
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    h = ref.fwht(torch.eye(128, device=dev))                # dense H
    for tag, shape in FWHT_TIME_SHAPES:
        x = torch.randn(shape, generator=g, device=dev)
        if not torch.equal(ops.fwht(x), ref.fwht(x)):
            raise AssertionError(f"fwht differs at {shape}")
        nbytes, flops = kcost.fwht(x.numel(), shape[-1])
        b, by = bound_ms(nbytes, flops)
        out[f"fwht/{tag}"] = {
            "shape": list(shape), "bytes": nbytes,
            "ms": timed(lambda: ops.fwht(x), 20),
            "plain_ms": timed(lambda: ref.fwht(x), 3),
            "library_ms": timed(lambda: x @ h, 20),
            "host_us": host_us(lambda: ops.fwht(x)),
            "library_host_us": host_us(lambda: x @ h),
            "bound_ms": b, "bound_by": by, "max_abs_err": 0.0}
    for tag, shape in PACK_TIME_SHAPES:
        x = torch.randn(shape, generator=g, device=dev)
        scale = x.abs().amax(-1, keepdim=True)
        if not torch.equal(ops.quantize_pack(x, scale, SERVE_BITS),
                           ref.quantize_pack(x, scale, SERVE_BITS)):
            raise AssertionError(f"quantize_pack differs at {shape}")
        nbytes, flops = kcost.quantize_pack(
            x.numel(), x.numel() // shape[-1], SERVE_BITS)
        b, by = bound_ms(nbytes, flops)
        out[f"quantize_pack/{tag}"] = {
            "shape": list(shape), "bytes": nbytes,
            "ms": timed(lambda: ops.quantize_pack(x, scale, SERVE_BITS), 20),
            "plain_ms": timed(lambda: ref.quantize_pack(x, scale,
                                                        SERVE_BITS), 3),
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "max_abs_err": 0.0}
        if tag == "decode":
            out[f"quantize_pack/{tag}"]["device_ms"] = device_ms(
                lambda: ops.quantize_pack(x, scale, SERVE_BITS))
            out[f"quantize_pack/{tag}"]["host_us"] = host_us(
                lambda: ops.quantize_pack(x, scale, SERVE_BITS))
        del x, scale
    kh, gq, dh = 4, 8, 128
    for tag, (b_, c, n) in ATTN_TIME_SHAPES:
        args = checks.attention_inputs(b_, c, kh, gq, dh, SERVE_BITS, c,
                                       dev, lens=[n] * b_)
        got = ops.quant_decode_attention(*args, bits=SERVE_BITS)
        want = ref.quant_decode_attention(*args, bits=SERVE_BITS)
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=checks.ATTN_TOL,
                              atol=checks.ATTN_TOL):
            raise AssertionError(f"quant_decode_attention differs at "
                                 f"B={b_} C={c}: {e}")
        del got, want
        # kv_len = n <= C positions of each of the b_ rows visited
        nbytes, flops = kcost.quant_decode_attention(
            b_, kh, gq, dh, SERVE_BITS, b_ * n)
        bnd, by = bound_ms(nbytes, flops)
        out[f"quant_decode_attention/{tag}"] = {
            "shape": [b_, c, kh, gq, dh], "kv_len": n, "bytes": nbytes,
            "ms": timed(lambda: ops.quant_decode_attention(
                *args, bits=SERVE_BITS), 20),
            "plain_ms": timed(lambda: ref.quant_decode_attention(
                *args, bits=SERVE_BITS), 3),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "max_abs_err": e}
        out[f"quant_decode_attention/{tag}"]["device_ms"] = device_ms(
            lambda: ops.quant_decode_attention(*args, bits=SERVE_BITS))
        if tag == "serve":
            out[f"quant_decode_attention/{tag}"]["host_us"] = host_us(
                lambda: ops.quant_decode_attention(*args, bits=SERVE_BITS))
        del args
    torch.cuda.empty_cache()
    return out


# phase 7's traffic: one 64-token prefix, 8 requests (4 with the prefix and
# a 16-token suffix, 4 cold 80-token prompts), 16 new tokens each
PHASE7_TRAFFIC = {"prefix": PREFIX_LEN,
                  "requests": [(SUFFIX_LEN, True) if rid % 2 == 0
                               else (COLD_LEN, False) for rid in range(8)],
                  "profile_len": COLD_LEN}


def serve_cfg():
    """Phase 7's (and 14c's) model: yi-6b, 32 layers, the 8-bit cache."""
    from repro_torch import configs
    return dataclasses.replace(configs.get("yi-6b"), kv_quant_bits=SERVE_BITS)


def serve_phase(dev, keep=None) -> tuple:
    """Phase 7, the serving main path at full width and depth; returns
    (launch counts of the run, its numbers). `keep` (a dict) receives the
    run's tokens and cache words for phase 14c."""
    return serve_run(dev, serve_cfg(), "serve x32", PHASE7_TRAFFIC, keep)


def make_traffic(cfg, traffic: dict) -> tuple:
    """(prefix tokens, [(prompt tokens, prefix id or None)]) of `traffic`,
    drawn from seed 5 (numpy int32)."""
    gen = torch.Generator()
    gen.manual_seed(5)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32).numpy()

    prefix = tokens(traffic["prefix"] or SUFFIX_LEN)
    prompts = [(tokens(n), "sys" if hit else None)
               for n, hit in traffic["requests"]]
    return prefix, prompts, tokens


def per_token_launches(cfg) -> dict:
    """The serve kernels' launches per decoded token (one decode step)."""
    nl = cfg.num_scanned
    return {"quant_decode_attention": nl, "quantize_pack": 2 * nl,
            "fwht": 3 * nl}


def drive_traffic(dev, cfg, params, traffic: dict, label: str) -> dict:
    """`traffic` through a fresh Engine of SERVE_SLOTS slots and
    SERVE_MAX_SEQ positions, SERVE_NEW tokens a request, launches counted
    around every public call (register_prefix, each Engine.step) against
    what the step ran; every request finishes, admissions as planned,
    each serve kernel launched, the caches finite. Runs the captured
    programs, or the eager ones inside `graph.eager()`. Returns the engine
    and what the run measured."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, Request, ServeConfig

    nl = cfg.num_scanned
    per_token = per_token_launches(cfg)
    # the attention families prefill in one blockwise pass (K and V of
    # each layer encoded once); the recurrent ones step decode per token
    stepped = cfg.block not in ("attn_mlp", "attn_moe", "attn_moe_dense")

    def per_prefill(n):
        return ((per_token, n) if stepped
                else ({"quantize_pack": 2 * nl, "fwht": 2 * nl}, 1))

    def plus(*terms):
        """Sum of (launches dict, times) terms."""
        out = {}
        for d, n in terms:
            for k, v in d.items():
                out[k] = out.get(k, 0) + v * n
        return out

    def counted(what, fn, want):
        """Run fn (a public engine call) between two synchronizes; its
        launches must equal want() (read after the call); returns its
        seconds."""
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        expect = want()
        expect = {k: expect.get(k, 0) for k in delta}
        if delta != expect:
            raise AssertionError(f"{what}: launches {delta}, want {expect}")
        return dt

    def admission_launches(req):
        """A cold admission prefills its prompt; a prefix hit decodes its
        suffix one token at a time; a prefix miss does both."""
        terms = []
        if req.admission in ("cold", "prefix_cold"):
            terms.append(per_prefill(len(req.prompt)))
        if req.admission in ("prefix_hit", "prefix_cold"):
            terms.append((per_token, len(req.prompt)))
        return terms

    eng = Engine(cfg, params, ServeConfig(slots=SERVE_SLOTS,
                                          max_seq=SERVE_MAX_SEQ), device=dev)
    prefix, prompts, tokens = make_traffic(cfg, traffic)
    reqs = [Request(rid=rid, prompt=prompt, max_new_tokens=SERVE_NEW,
                    prefix_id=pid) for rid, (prompt, pid) in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    prefix_prefill_s = None
    if traffic["prefix"]:
        prefix_prefill_s = counted(
            "register_prefix",
            lambda: eng.register_prefix("sys", prefix, prefill=True),
            lambda: plus(per_prefill(len(prefix))))
    for req in reqs:
        eng.submit(req)
    steps = []                  # (seconds, admission kinds of the step)
    while not eng.idle():
        if len(steps) > 4 * SERVE_NEW:
            raise AssertionError(f"engine still busy after {len(steps)} "
                                 "steps")
        waiting = [r for r in reqs if r.admission is None]
        busy = any(r is not None for r in eng.active)
        admitted = []

        def step_launches():
            admitted.extend(r for r in waiting if r.admission is not None)
            terms = [t for r in admitted for t in admission_launches(r)]
            if busy or admitted:                   # one batched decode
                terms.append((per_token, 1))
            return plus(*terms)

        dt = counted(f"{label} step {len(steps) + 1}", eng.step,
                     step_launches)
        steps.append((dt, [r.admission for r in admitted]))
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    finished = eng.finished
    if len(finished) != len(reqs) or any(len(r.tokens_out) != SERVE_NEW
                                         for r in finished):
        raise AssertionError("not every request finished with "
                             f"{SERVE_NEW} tokens")
    kinds = sorted(r.admission for r in finished)
    want_kinds = sorted("prefix_hit" if hit else "cold"
                        for _, hit in traffic["requests"])
    if kinds != want_kinds:
        raise AssertionError(f"admissions {kinds}, want {want_kinds}")
    for name in ("quant_decode_attention", "quantize_pack", "fwht"):
        if counts[name] == 0:
            raise AssertionError(f"{name} never launched on the serve path")
    for name, x in eng.state.caches.items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name} in the decode state")
    return {
        "eng": eng, "prefix": prefix, "prompts": prompts, "tokens": tokens,
        "steps": steps, "counts": counts, "run_s": run_s,
        "prefix_prefill_s": prefix_prefill_s,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
        "out": {r.rid: list(r.tokens_out) for r in finished},
        "decode_s": [dt for dt, admitted in steps if not admitted],
        "ttft_s_median": {k: statistics.median(
            r.ttft_s for r in finished if r.admission == k)
            for k in sorted(set(kinds))}}


# the order of serve.engine._programs' five programs
PROGRAM_NAMES = ("serve.decode_step", "serve.prefill", "serve.extend",
                 "serve.admit_cold", "serve.admit_prefix")


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in private pools: the captured
    graphs' memory (their intermediates and static outputs)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def cache_snapshot(state) -> dict:
    """Host copies of every per-slot cache leaf and the positions."""
    from repro_torch.models import decode as decode_lib
    snap = {k: v.to("cpu", copy=True) for k, v in state.caches.items()
            if k not in decode_lib.SHARED_CACHE_KEYS}
    snap["pos"] = state.pos.to("cpu", copy=True)
    return snap


def serve_run(dev, cfg, label: str, traffic: dict, keep=None) -> tuple:
    """Serve `cfg` (random weights, seed 0) with `traffic` ({"prefix": its
    length or 0, "requests": [(prompt length, uses the prefix)],
    "profile_len": the prompts of the profiled step}) through
    drive_traffic (the captured programs); then one profiled decode step,
    the serve step's logits and the prefix contract (8-bit and f32
    caches), bitwise on the card. `keep` (a dict) receives the run's
    tokens, cache leaves and TTFT for phases 14c and 15. Returns (launch
    counts of the run, its numbers)."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist.step import make_serve_step
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serve import Request, ServeConfig, verify_prefix_contract

    t0 = time.perf_counter()
    params = model_lib.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    log(f"[{label}] {cfg.name} {cfg.num_layers} layers, {n_params} params "
        f"({n_params * 4 / 1e9:.2f} GB f32) made in {init_s:.2f}s")
    nl = cfg.num_scanned
    run = drive_traffic(dev, cfg, params, traffic, label)
    eng, steps, counts = run["eng"], run["steps"], run["counts"]
    prefix, prompts, tokens = run["prefix"], run["prompts"], run["tokens"]
    if keep is not None:
        keep["tokens"] = run["out"]
        keep["caches"] = cache_snapshot(eng.state)
        keep["ttft_s_median"] = run["ttft_s_median"]
        keep["decode_step_s_median"] = statistics.median(run["decode_s"])
    decode_s = run["decode_s"]
    positional = [x for name, x in eng.state.caches.items()
                  if name in decode_lib.POSITIONAL_CACHE_KEYS
                  and name.endswith("words")]
    cache_bytes = decode_lib.state_bytes(eng.state)
    # the same state with an f32 KV cache: 32/bits values of 4 bytes per
    # word, no scales; the recurrent leaves as they are
    f32_bytes = eng.state.pos.numel() * 4
    for name, x in eng.state.caches.items():
        if name.endswith("words"):
            f32_bytes += x.numel() * (32 // SERVE_BITS) * 4
        elif name not in decode_lib.SHARED_CACHE_KEYS and \
                not name.endswith("scale"):
            f32_bytes += x.numel() * x.element_size()
    n_tokens = sum(len(t) for t in run["out"].values())
    run_s = run["run_s"]
    numbers = {
        "layers": nl, "params": n_params, "init_s": init_s,
        "run_s": run_s, "tokens": n_tokens, "tokens_per_s": n_tokens / run_s,
        "steps": len(steps), "decode_steps": len(decode_s),
        "decode_step_s_median": statistics.median(decode_s),
        "decode_tokens_per_s": SERVE_SLOTS / statistics.median(decode_s),
        "prefix_prefill_s": run["prefix_prefill_s"],
        "admission_steps": [{"s": dt, "admitted": admitted}
                            for dt, admitted in steps if admitted],
        "ttft_s_median": run["ttft_s_median"],
        "peak_mem_GB": run["peak_mem_GB"],
        "graph_pool_bytes": graph_pool_bytes(),
        "cache_bytes": cache_bytes, "cache_bytes_if_f32": f32_bytes,
        "words_shape": list(positional[0].shape), "launches": counts}
    log(f"[{label}] {json.dumps(numbers)}")

    # one decode step of 4 busy slots under the profiler: the device's busy
    # time (its kernels and copies) against the unprofiled median step
    for rid in range(SERVE_SLOTS):
        eng.submit(Request(rid=100 + rid,
                           prompt=tokens(traffic["profile_len"]),
                           max_new_tokens=4))
    eng.step()                                   # admissions + one decode
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    eng.run_to_completion()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    step_ms = numbers["decode_step_s_median"] * 1e3
    numbers["profiled_step"] = {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if kern else "not measured",
        "idle_share_of_median_step": (1 - busy_ms / step_ms) if kern
        else "not measured",
        "device_ops": sum(e.count for e in kern),
        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                for e in sorted(kern, key=lambda e: -e.self_device_time_total)
                [:8]]}
    log(f"[{label}] profiled decode step: "
        f"{json.dumps(numbers['profiled_step'])}")
    # the serve step the launcher uses, pinned to the card, on the engine's
    # final state: its logits must be finite
    logits, _ = make_serve_step(cfg, dev)(params, eng.state, eng.last_token)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits from the serve step")
    del eng, logits

    # the prefix contract on the card, 8-bit and f32 caches, same weights
    contract = {}
    for bits in (SERVE_BITS, None):
        c_cfg = dataclasses.replace(cfg, kv_quant_bits=bits)
        t = time.perf_counter()
        ev = verify_prefix_contract(
            c_cfg, params, ServeConfig(slots=SERVE_SLOTS,
                                       max_seq=SERVE_MAX_SEQ),
            prefix, prompts[0][0], device=dev)
        contract[f"kv{bits or 32}"] = {**ev, "s": time.perf_counter() - t}
    log(f"[{label}] prefix contract bitwise (hit == cold) on the card, "
        f"{cfg.num_layers} layers: {json.dumps(contract)}")
    numbers["prefix_contract"] = contract
    del params
    torch.cuda.empty_cache()
    return counts, numbers


def train_card_vs_cpu(dev, small, gc, label: str) -> list:
    """Two AdamW steps (clip 1) of the reduced `small` on the CPU and on the
    card from the same weights and tokens: the losses within 1e-4
    relative, the params within 3 lr per step at the maximum and 1e-6 at
    the median (f32 sums differ in order between CPU and card; a coordinate
    whose code lands in the next bin moves Adam's step by up to ~2 lr).
    Returns each step's (loss cpu, loss card, max and median |dparam|)."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist import step as step_lib
    from repro_torch.optimizer import optim

    lr = 3e-4
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    states, step_fns = {}, {}
    for d, device in devices.items():
        opt = optim.adamw(optim.warmup_cosine(lr, 1, 10), weight_decay=0.1)
        step_fns[d] = step_lib.make_train_step(small, opt, gc, clip_norm=1.0)
        p, o, e = step_lib.init_train_state(small, opt, gc, seed=0,
                                           device="cpu")
        states[d] = tuple(tree_lib.map(lambda x: x.to(device), s)
                          for s in (p, o, e))
    tg = torch.Generator()
    tg.manual_seed(4)
    out = []
    for s in range(2):
        toks = torch.randint(0, small.vocab_size, (2, 17), generator=tg,
                             dtype=torch.int32)
        loss = {}
        for d, device in devices.items():
            *states[d], m = step_fns[d](*states[d],
                                        {"tokens": toks.to(device)})
            loss[d] = float(m["loss"])
        diffs = torch.cat([(a - b.cpu()).abs().flatten() for a, b in zip(
            tree_lib.leaves(states["cpu"][0]),
            tree_lib.leaves(states["cuda"][0]))])
        mx, med = float(diffs.max()), float(diffs.median())
        log(f"[{label}] step {s}: loss cpu {loss['cpu']} cuda "
            f"{loss['cuda']} max|dparam| {mx:.3g} median {med:.3g}")
        if not (abs(loss["cpu"] - loss["cuda"]) <= 1e-4 * abs(loss["cpu"])
                and mx <= 3 * lr * (s + 1) and med <= 1e-6):
            raise AssertionError(f"{label}: card and CPU disagree on the "
                                 "small input")
        out.append((loss["cpu"], loss["cuda"], mx, med))
    return out


def small_serve_phase(dev) -> dict:
    """The reduced yi-6b with the 8-bit cache on the card and on the CPU
    from the same weights and prompts. Both decode the CPU's greedy tokens
    (so a difference cannot cascade); logits must agree within
    SMALL_LOGIT_TOL, every cached code within one bin, the greedy tokens
    exactly; then an Engine on each device must emit the same tokens."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serve import Engine, Request, ServeConfig

    small = dataclasses.replace(configs.get_reduced("yi-6b"),
                                kv_quant_bits=SERVE_BITS)
    devices = {"cpu": torch.device("cpu"), "card": dev}
    params = {"cpu": model_lib.init_params(0, small, "cpu")}
    params["card"] = tree_lib.map(lambda x: x.to(dev), params["cpu"])
    gen = torch.Generator()
    gen.manual_seed(6)
    toks = torch.randint(0, small.vocab_size, (2, 12), generator=gen,
                         dtype=torch.int32)
    logits, states = {}, {}
    for d, device in devices.items():
        lg, states[d] = decode_lib.prefill(small, params[d], toks.to(device),
                                           32)
        logits[d] = [lg.cpu()]
    for _ in range(6):
        tok = decode_lib.greedy_token(logits["cpu"][-1])
        for d, device in devices.items():
            lg, states[d] = decode_lib.decode_step(small, params[d],
                                                   states[d], tok.to(device))
            logits[d].append(lg.cpu())
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cpu"], logits["card"]))
    same_tokens = all(torch.equal(a.argmax(-1), b.argmax(-1))
                      for a, b in zip(logits["cpu"], logits["card"]))
    k = 32 // SERVE_BITS
    shifts = torch.arange(k, dtype=torch.int64) * SERVE_BITS
    codes_differ, codes, max_bin = 0, 0, 0
    for name in ("k_words", "v_words"):
        a = states["cpu"].caches[name].to(torch.int64)
        b = states["card"].caches[name].cpu().to(torch.int64)
        ca = ((a & 0xFFFFFFFF)[..., None] >> shifts) & (2 ** SERVE_BITS - 1)
        cb = ((b & 0xFFFFFFFF)[..., None] >> shifts) & (2 ** SERVE_BITS - 1)
        diff = (ca - cb).abs()
        codes_differ += int((diff > 0).sum())
        codes += diff.numel()
        max_bin = max(max_bin, int(diff.max()))

    def run(d):
        eng = Engine(small, params[d], ServeConfig(slots=2, max_seq=40),
                     device=devices[d])
        eng.register_prefix("sys", toks[0, :10].numpy())
        for rid, (p, pid) in enumerate(((toks[1, :6], None),
                                        (toks[1, 6:], "sys"),
                                        (toks[0, 3:7], None))):
            eng.submit(Request(rid=rid, prompt=p.numpy(), max_new_tokens=5,
                               prefix_id=pid))
        return {r.rid: r.tokens_out for r in eng.run_to_completion()}

    engine_cpu, engine_cuda = run("cpu"), run("card")
    out = {"logits_max_abs_diff": err, "greedy_equal": same_tokens,
           "codes_differ": codes_differ, "codes": codes,
           "max_bin_diff": max_bin,
           "engine_tokens_equal": engine_cpu == engine_cuda}
    log(f"[small serve] card vs CPU: {json.dumps(out)}")
    if not (err <= SMALL_LOGIT_TOL and same_tokens and max_bin <= 1
            and engine_cpu == engine_cuda):
        raise AssertionError("card and CPU disagree on the small serve run")
    return out


# -- phase 13: the other block families (models/{moe,ssm,xlstm}) -----------
# a. mixtral-8x22b at full width cut to 4 of its 56 layers, served with
#    phase 7's traffic; b. cut to 1 layer, trained; c. hymba-1.5b at full
#    width and depth, served; d. four reduced configs, card against CPU;
#    e. xlstm-350m at full width and depth, trained
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 4, 1
HYMBA_TRAFFIC = {"prefix": 0, "requests": [(32, False)] * 4,
                 "profile_len": 8}
FAMILY_ARCHS = ("mixtral-8x22b", "arctic-480b", "hymba-1.5b", "xlstm-350m")
# 13d serving: a 60-token prompt and 8 decode steps pass the reduced
# window of 64, so mixtral's and hymba's rings wrap
FAMILY_PROMPT, FAMILY_STEPS, FAMILY_MAX_SEQ = 60, 8, 80
MOE_TRAIN_LR = 1e-2              # 13b: SGD, no clip (phase 11b's step)


def moe_serve_cfg():
    """13a's (and 15's) model: mixtral-8x22b, MOE_SERVE_LAYERS layers, the
    8-bit cache."""
    from repro_torch import configs
    return dataclasses.replace(configs.get("mixtral-8x22b"),
                               num_layers=MOE_SERVE_LAYERS,
                               kv_quant_bits=SERVE_BITS)


def hymba_serve_cfg():
    """13c's (and 15's) model: hymba-1.5b whole, the 8-bit cache."""
    from repro_torch import configs
    return dataclasses.replace(configs.get("hymba-1.5b"),
                               kv_quant_bits=SERVE_BITS)


def moe_serve_phase(dev, cfg=None, keep=None) -> tuple:
    """13a: mixtral-8x22b at full width, MOE_SERVE_LAYERS layers, through
    the 8-bit cache with phase 7's traffic (serve_run). With 4 slots the
    decode capacity is 1 token per expert, so tokens are dropped (GShard's
    rule, as in the reference)."""
    from repro_torch.kernels import cost
    cfg = cfg or moe_serve_cfg()
    counts, numbers = serve_run(dev, cfg, "13a serve mixtral x4",
                                PHASE7_TRAFFIC, keep)
    # every decode step reads every weight once (the MoE runs all experts
    # on its (E, C, d) buffer)
    numbers["weight_read_floor_ms"] = (numbers["params"] * 4
                                       / cost.PEAK_BYTES_S * 1e3)
    return counts, numbers


def moe_train_phase(dev, cfg=None, batch: int = 8, seq: int = 128) -> dict:
    """13b: mixtral-8x22b at full width, MOE_TRAIN_LAYERS layer, 2 steps of
    allgather_packed with EF (R 4, chunk 256) and SGD without clip:
    AdamW's functional update holds the params, grads, clipped grads, EF
    and old and new moments at once, ~104 GB at 2.91e9 values, past the
    card's 80 GB. encode_ef, unpack_dequant and fwht launch once per leaf
    per step; loss and params finite; then an expert leaf's payload (words,
    scales, EF residual) on rows past 2^31 bytes into the leaf bitwise its
    CPU encode."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import batch_for_shape
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as step_lib
    from repro_torch.kernels import ops, ref
    from repro_torch.optimizer import optim

    cfg = cfg or dataclasses.replace(configs.get("mixtral-8x22b"),
                                     num_layers=MOE_TRAIN_LAYERS)
    gc = G.GradCompConfig(bits=4)
    opt = optim.sgd(MOE_TRAIN_LR)
    step = step_lib.make_train_step(cfg, opt, gc)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, ef = step_lib.init_train_state(cfg, opt, gc, seed=0,
                                                      device=dev)
    leaves, spec = tree_lib.flatten(params)
    n_leaves, n_values = len(leaves), sum(x.numel() for x in leaves)
    log(f"[13b train mixtral x1] {n_leaves} leaves, {n_values} values, "
        f"largest {max(x.numel() for x in leaves)}")
    losses, secs, per_step = [], [], []
    ops.reset_launch_counts()
    for s in range(2):
        b = batch_for_shape(cfg, batch, seq, s, 0, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, ef, m = step(params, opt_state, ef, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        per_step.append(ops.launch_counts())
    counts = per_step[-1]
    prev = {k: 0 for k in counts}
    for s, c in enumerate(per_step):
        for k in ("encode_ef", "unpack_dequant", "fwht"):
            if c[k] - prev[k] != n_leaves:
                raise AssertionError(f"13b step {s}: {k} launched "
                                     f"{c[k] - prev[k]} times, want "
                                     f"{n_leaves}")
        prev = c
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (all(map(math.isfinite, losses)) and all(
            bool(torch.isfinite(x).all()) for x in tree_lib.leaves(params))):
        raise AssertionError(f"13b: non-finite loss or params {losses}")
    del opt_state, ef, m, b
    torch.cuda.empty_cache()

    # the expert leaf e_gate (E, d, f) through the codec's leaf encode on
    # the card; rows across and past 2^31 bytes against the CPU encode
    # "blocks" sorts first among the top-level keys, and mixtral's block
    # leaves are plain tensors: leaf i is the i-th block key in sorted order
    i = sorted(params["blocks"]).index("e_gate")
    u = tree_lib.leaves(params)[i]
    payload, resid = G.encode_leaf_ef(u, i, gc, 0)
    chunks = G._to_chunks(u, gc.chunk)
    rows = chunks.shape[0]
    r_cross = 2 ** 31 // (gc.chunk * 4)          # first row past 2^31 bytes
    signs = G._frame_signs(i, gc, "cpu")
    checked = []
    for r0 in (r_cross - 32, rows - 64) if rows >= r_cross + 32 else ():
        want_w, want_s, want_r = ref.encode_ef(chunks[r0:r0 + 64].cpu(),
                                               signs, gc.bits)
        got = (payload["words"][r0:r0 + 64].cpu(),
               payload["scale"][r0:r0 + 64].cpu(),
               resid.reshape(rows, gc.chunk)[r0:r0 + 64].cpu())
        if not (torch.equal(got[0], want_w) and torch.equal(got[1], want_s)
                and torch.equal(got[2], want_r)):
            raise AssertionError(f"13b: e_gate rows {r0}..{r0 + 64} differ "
                                 "from the CPU encode")
        checked.append([r0, r0 + 64, (r0 + 64) * gc.chunk * 4])
    out = {"leaves": n_leaves, "values": n_values, "losses": losses,
           "step_s": secs, "peak_mem_GB": peak_gb, "launches": counts,
           "optimizer": f"sgd({MOE_TRAIN_LR}), no clip",
           "e_gate_rows": rows, "rows_checked_bitwise": checked}
    log(f"[13b train mixtral x1] {json.dumps(out)}")
    del params, payload, resid, chunks, u, leaves
    torch.cuda.empty_cache()
    return out


def hymba_serve_phase(dev, cfg=None, keep=None) -> tuple:
    """13c: hymba-1.5b at full width and all 32 layers through the 8-bit
    cache: 4 cold 32-token prompts, SERVE_NEW tokens each (its prefill
    steps decode, so each prompt token launches a decode step's
    kernels)."""
    return serve_run(dev, cfg or hymba_serve_cfg(), "13c serve hymba x32",
                     HYMBA_TRAFFIC, keep)


def families_card_vs_cpu(dev, archs=FAMILY_ARCHS) -> dict:
    """13d: each reduced config on the CPU and on the card from the same
    weights: two train steps within phase 6's bounds; served through the
    8-bit cache (xlstm has none) past the window, both devices fed the
    CPU's greedy tokens, logits within SMALL_LOGIT_TOL and greedy tokens
    equal; for the MoE families two card runs of the forward and backward
    bitwise."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib

    out = {}
    for arch in archs:
        small = configs.get_reduced(arch)
        rec = {"train": train_card_vs_cpu(dev, small, G.GradCompConfig(),
                                          f"13d {arch} train")}
        scfg = dataclasses.replace(
            small, kv_quant_bits=SERVE_BITS
            if small.block != "xlstm_pair" else None)
        params = {"cpu": model_lib.init_params(0, scfg, "cpu")}
        params["card"] = tree_lib.map(lambda x: x.to(dev), params["cpu"])
        gen = torch.Generator()
        gen.manual_seed(7)
        toks = torch.randint(0, small.vocab_size, (2, FAMILY_PROMPT),
                             generator=gen, dtype=torch.int32)
        logits, states = {}, {}
        for d, device in (("cpu", "cpu"), ("card", dev)):
            lg, states[d] = decode_lib.prefill(scfg, params[d],
                                               toks.to(device),
                                               FAMILY_MAX_SEQ)
            logits[d] = [lg.cpu()]
        for _ in range(FAMILY_STEPS):
            tok = decode_lib.greedy_token(logits["cpu"][-1])
            for d, device in (("cpu", "cpu"), ("card", dev)):
                lg, states[d] = decode_lib.decode_step(
                    scfg, params[d], states[d], tok.to(device))
                logits[d].append(lg.cpu())
        err = max(float((a - b).abs().max())
                  for a, b in zip(logits["cpu"], logits["card"]))
        same = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(logits["cpu"], logits["card"]))
        pos = int(states["card"].pos[0])
        rec["serve"] = {"logits_max_abs_diff": err, "greedy_equal": same,
                        "positions": pos,
                        "cache_len": decode_lib._cache_len_of(states["card"])}
        if not (err <= SMALL_LOGIT_TOL and same):
            raise AssertionError(f"13d {arch}: served card and CPU disagree "
                                 f"({rec['serve']})")
        if small.num_experts:
            batch = {"tokens": toks[:, :33].to(dev)}
            grads = []
            for _ in range(2):
                leaves, spec = tree_lib.flatten(params["card"])
                diff = [x.detach().clone().requires_grad_() for x in leaves]
                loss = model_lib.loss_fn(small, tree_lib.unflatten(
                    spec, diff), batch)
                grads.append([loss.detach()] + list(
                    torch.autograd.grad(loss, diff)))
            rec["moe_two_runs_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(*grads))
            if not rec["moe_two_runs_bitwise"]:
                raise AssertionError(f"13d {arch}: two card runs of the MoE "
                                     "forward and backward differ")
        log(f"[13d {arch}] {json.dumps(rec)}")
        out[arch] = rec
        del params, states
    return out


def xlstm_train_phase(dev, cfg=None, steps: int = 2) -> dict:
    """13e: xlstm-350m at full width and all 24 layers, `steps` steps of
    launch.train.train at the launcher's defaults (AdamW, batch 8, seq
    128, R 4, allgather_packed with EF): encode_ef, unpack_dequant and
    fwht once per leaf per step."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import model as model_lib

    cfg = cfg or configs.get("xlstm-350m")
    n_leaves = len(tree_lib.leaves(model_lib.param_shapes(cfg),
                                   is_leaf=model_lib.is_shape))
    per_step = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, losses, secs = train(
        cfg, steps=steps, batch_size=8, seq_len=128,
        gc=G.GradCompConfig(bits=4), device=dev, log_every=1,
        on_step=lambda s, m: per_step.append(ops.launch_counts()))
    prev = {k: 0 for k in per_step[0]}
    for s, c in enumerate(per_step):
        for k in ("encode_ef", "unpack_dequant", "fwht"):
            if c[k] - prev[k] != n_leaves:
                raise AssertionError(f"13e step {s}: {k} launched "
                                     f"{c[k] - prev[k]} times, want "
                                     f"{n_leaves}")
        prev = c
    if not (all(map(math.isfinite, losses)) and all(
            bool(torch.isfinite(x).all()) for x in tree_lib.leaves(params))):
        raise AssertionError(f"13e: non-finite loss or params {losses}")
    out = {"leaves": n_leaves, "losses": losses, "step_s": secs,
           "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
           "launches": per_step[-1]}
    log(f"[13e train xlstm x24] {json.dumps(out)}")
    del params
    torch.cuda.empty_cache()
    return out


# -- phase 9: the paper's algorithms (Algs. 1-3, core/*), card vs CPU --------
# The reference's §5 protocols (benchmarks/fig1a, fig1b, fig1c, fig2, fig3)
# at the paper's sizes. Data and Haar frames are made once on the CPU from
# the seed and copied to the card (a CUDA generator draws another stream, and
# cuSOLVER's QR another S); Hadamard frames are drawn from keys on each
# device. Tolerances, card against CPU: Alg. 1 rates 1e-3, Alg. 2 final hinge
# loss 1e-3 relative, Alg. 3 x_avg 1e-4 relative, codec error 1e-4 absolute
# with the Hadamard payloads bitwise.
ALG1_N, ALG1_M, ALG1_STEPS, ALG1_BUDGETS = 116, 200, 120, (1, 2, 4, 8)
ALG2_N, ALG2_M, ALG2_STEPS, ALG2_BATCH, ALG2_ALPHA = 30, 100, 600, 20, 0.05
ALG3_WORKERS, ALG3_S, ALG3_N, ALG3_STEPS, ALG3_ALPHA = 10, 10, 30, 1500, 0.1
ALG3_BUDGETS = (0.5, 1.0, 4.0)
CODEC_N, CODEC_TRIALS, CODEC_BUDGETS = 1000, 20, (1.0, 2.0, 3.0, 4.0, 6.0)
EMBED_TIME_N = (1024, 4096, 8192)
ALG_TOL = {"alg1_rate": 1e-3, "alg2_loss_rel": 1e-3, "alg3_xavg_rel": 1e-4,
           "codec_err_abs": 1e-4}


def paper_problems(seed: int = 0) -> dict:
    """The §5 problems on the CPU, from the seed (torch.Generator draws)."""
    from repro_torch import random as rnd
    from repro_torch.core import frames as F
    from repro_torch.data import pipeline
    g = torch.Generator().manual_seed(seed)
    n, m = ALG1_N, ALG1_M
    a = torch.randn(m, n, generator=g) ** 3 / torch.tensor(math.sqrt(m))
    x_star = torch.randn(n, generator=g)
    h = a.T @ a
    eigs = torch.linalg.eigvalsh(h)
    big_l, mu = float(eigs[-1]), max(float(eigs[0]), 1e-6)
    alg1 = {"h": h, "atb": a.T @ (a @ x_star), "x_star": x_star,
            "L": big_l, "mu": mu, "haar": F.haar_frame(rnd.key(0), n, n)}
    xa, ya = pipeline.synthetic_two_class(seed, ALG2_M // 2, ALG2_N,
                                        device="cpu")
    alg2 = {"a": xa, "b": ya,
            "haar": F.haar_frame(rnd.key(2), ALG2_N, ALG2_N)}
    w, s, n3 = ALG3_WORKERS, ALG3_S, ALG3_N
    a3, b3, x3 = pipeline.synthetic_regression(seed, w * s, n3,
                                               design="gauss",
                                               model="student_t",
                                               device="cpu")
    scale = torch.clamp(torch.linalg.vector_norm(x3)
                        / torch.tensor(math.sqrt(n3)), min=1.0)
    alg3 = {"a": a3, "b": b3 / scale,
            "haar": F.haar_frame(rnd.key(2), n3, n3)}
    codec = {"y": torch.randn(CODEC_N, generator=g) ** 3,
             "haar": F.haar_frame(rnd.key(0), CODEC_N, CODEC_N)}
    return {"alg1": alg1, "alg2": alg2, "alg3": alg3, "codec": codec}


def _to(tree, dev):
    """Tensors of a problem dict (frames too) copied to dev."""
    from repro_torch.core import frames as F
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, F.DenseFrame):
            v = F.DenseFrame(S=v.S.to(dev))
        out[k] = v
    return out


def run_algorithms(P: dict, dev) -> dict:
    """Algs. 1-3 and the codec error of the §5 protocols on dev, the port's
    code as a user calls it. Returns the reported quantities, the FWHT
    launches and the seconds of each sub-phase, and each algorithm's
    (seconds, steps), each run timed between two synchronizations."""
    from repro_torch import random as rnd
    from repro_torch.core import baselines as B
    from repro_torch.core import coding as C
    from repro_torch.core import embeddings as E
    from repro_torch.core import frames as F
    from repro_torch.core import optim as O
    from repro_torch.kernels import ops
    out = {"launches": {}, "seconds": {}, "hadamard": {}, "steps": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def sub_phase(name, fn):
        ops.reset_launch_counts()
        t = time.perf_counter()
        out[name] = fn()
        sync()
        out["seconds"][name] = time.perf_counter() - t
        out["launches"][name] = ops.launch_counts()["fwht"]

    def algorithm(family, fn, *args, **kw):
        """fn(*args, **kw), its seconds and steps added to family's."""
        sync()
        t = time.perf_counter()
        trace = fn(*args, **kw)
        sync()
        secs, steps = out["steps"].get(family, (0.0, 0))
        out["steps"][family] = (secs + time.perf_counter() - t,
                                steps + trace.dist_history.shape[0])
        return trace

    def hadamard(seed, n, N):
        frame = F.hadamard_frame(rnd.key(seed, device=dev), n, N)
        out["hadamard"][f"{seed}/{n}/{N}"] = frame
        return frame

    def codec(frame, R, **kw):
        emb = E.EmbeddingSpec(kind=kw.pop("embedding", "near_democratic"))
        return C.Codec(frame, C.CodecConfig(bits_per_dim=float(R),
                                            embedding=emb, **kw))

    # a. Alg. 1 (fig1b): least squares, DGD-DEF against GD and DQGD
    p = _to(P["alg1"], dev)
    n, steps = ALG1_N, ALG1_STEPS
    alpha = O.alpha_star(p["L"], p["mu"])
    grad = lambda x: p["h"] @ x - p["atb"]                     # noqa: E731
    x0 = torch.zeros(n, device=dev)
    d_range = float(torch.linalg.vector_norm(p["x_star"])) * 1.5

    def alg1():
        xs = p["x_star"]
        runs = {"gd": algorithm("gd", O.gd, grad, x0, alpha, steps,
                                x_star=xs)}
        had = hadamard(0, n, F.next_pow2(n))
        for R in ALG1_BUDGETS:
            levels = max(2, int(2 ** R))
            runs[f"dqgd_schedule/R{R}"] = algorithm(
                "dqgd_schedule", O.dqgd_schedule, grad, x0, levels, alpha,
                steps, p["L"], p["mu"], d_range, n, x_star=xs)
            runs[f"dqgd_naive/R{R}"] = algorithm(
                "dqgd_naive", O.dqgd, grad, x0,
                B.naive_uniform(levels).roundtrip, alpha, steps, x_star=xs)
            runs[f"dgd_def_nde_hadamard/R{R}"] = algorithm(
                "dgd_def_nde_hadamard", O.dgd_def, grad, x0, codec(had, R),
                alpha, steps, x_star=xs)
            runs[f"dgd_def_de_haar/R{R}"] = algorithm(
                "dgd_def_de_haar", O.dgd_def, grad, x0,
                codec(p["haar"], R, embedding="democratic"), alpha, steps,
                x_star=xs)
        d0 = float(torch.linalg.vector_norm(p["x_star"]))
        rates = {}
        for name, tr in runs.items():
            fin = float(tr.dist_history[-1])
            rates[name] = (min((fin / d0) ** (1.0 / steps), 1.0) if fin > 0
                           else 0.0)
        return {"rates": rates, "sigma": O.sigma_rate(p["L"], p["mu"])}

    sub_phase("a_alg1", alg1)

    # b. Alg. 2 (fig2): SVM hinge loss, DQ-PSGD at R = 0.5
    p = _to(P["alg2"], dev)

    def subgrad(k, x):
        idx = rnd.randint(k, (ALG2_BATCH,), 0, ALG2_M).long()
        ai, bi = p["a"][idx], p["b"][idx]
        g = -(bi[:, None] * ai) * ((bi * (ai @ x)) < 1.0)[:, None]
        return torch.mean(g, dim=0)

    def alg2():
        x0 = torch.zeros(ALG2_N, device=dev)
        runs = {
            "unquantized": {},
            "nde_haar_R0.5": {"codec": codec(p["haar"], 0.5, dithered=True)},
            "rand50_1b_R0.5": {"compressor_roundtrip": B.randk(
                0.5, quant_levels=2, unbiased=True).roundtrip},
            "top10_5b": {"compressor_roundtrip": B.topk(
                0.1, quant_levels=32).roundtrip}}
        x_avg = {}
        for name, kw in runs.items():
            tr = algorithm(f"dq_psgd_{name}", O.dq_psgd, subgrad, x0,
                           kw.pop("codec", None), ALG2_ALPHA, ALG2_STEPS,
                           key=rnd.key(1, device=dev), **kw)
            x_avg[name] = tr.x_avg.cpu()
        return {"x_avg": x_avg}

    sub_phase("b_alg2", alg2)

    # c. Alg. 3 (fig3): m workers, DSC and NDSC at R 0.5, 1, 4
    p = _to(P["alg3"], dev)
    w, s, n3 = ALG3_WORKERS, ALG3_S, ALG3_N
    a_w, b_w = p["a"].reshape(w, s, n3), p["b"].reshape(w, s)

    def subgrad_w(ids, keys, x):
        idx = rnd.randint(keys, (w, 4), 0, s).long()
        ai, bi = a_w[ids[:, None], idx], b_w[ids[:, None], idx]
        return torch.mean((ai @ x - bi)[..., None] * ai, dim=1)

    def alg3():
        had = hadamard(2, n3, 32)
        x0 = torch.zeros(n3, device=dev)
        x_avg = {}
        for R in ALG3_BUDGETS:
            for name, cod in (
                    ("dsc_haar", codec(p["haar"], R, dithered=True,
                                       embedding="democratic")),
                    ("ndsc_haar", codec(p["haar"], R, dithered=True)),
                    ("ndsc_hadamard", codec(had, R, dithered=True))):
                tr = algorithm(f"dq_psgd_multiworker_{name}",
                               O.dq_psgd_multiworker, subgrad_w, w, x0, cod,
                               ALG3_ALPHA, ALG3_STEPS,
                               key=rnd.key(1, device=dev))
                x_avg[f"{name}/R{R:g}"] = tr.x_avg.cpu()
        return {"x_avg": x_avg}

    sub_phase("c_alg3", alg3)

    # d. codec error (fig1a): NDE-Hadamard (N 1024) and NDE-Haar, 20 trials
    p = _to(P["codec"], dev)

    def codec_error():
        had = hadamard(0, CODEC_N, F.next_pow2(CODEC_N))
        y = p["y"].expand(CODEC_TRIALS, CODEC_N)
        keys = rnd.split(rnd.key(1, device=dev), CODEC_TRIALS)
        err, indices = {}, {}
        for R in CODEC_BUDGETS:
            for name, frame in (("nde_hadamard", had),
                                ("nde_haar", p["haar"])):
                cod = codec(frame, R)
                payload = cod.encode(y, keys)
                y_hat = cod.decode(payload)
                e = (torch.linalg.vector_norm(y_hat - y, dim=-1)
                     / torch.linalg.vector_norm(y, dim=-1))
                err[f"{name}/R{R:g}"] = float(e.mean())
                if name == "nde_hadamard":
                    indices[f"R{R:g}"] = payload.indices.cpu()
        return {"err": err, "indices": indices}

    sub_phase("d_codec_error", codec_error)
    return out


def compare_algorithms(cpu: dict, card: dict, P: dict) -> dict:
    """Card against CPU at the stated tolerances; raises on a miss."""
    worst = {}
    for key, frame in card["hadamard"].items():
        ref = cpu["hadamard"][key]
        if not (torch.equal(frame.signs.cpu(), ref.signs)
                and torch.equal(frame.rows.cpu(), ref.rows)):
            raise AssertionError(f"Hadamard frame {key} differs card/CPU")
    d = {k: abs(card["a_alg1"]["rates"][k] - v)
         for k, v in cpu["a_alg1"]["rates"].items()}
    worst["alg1_rate"] = max(d.values())
    a, b = P["alg2"]["a"].double(), P["alg2"]["b"].double()

    def hinge(x):
        return float(torch.clamp(1.0 - b * (a @ x.double()), min=0.0).mean())

    d = {k: abs(hinge(card["b_alg2"]["x_avg"][k]) - hinge(v)) / hinge(v)
         for k, v in cpu["b_alg2"]["x_avg"].items()}
    worst["alg2_loss_rel"] = max(d.values())
    d = {k: float(torch.linalg.vector_norm(card["c_alg3"]["x_avg"][k] - v)
                  / torch.linalg.vector_norm(v))
         for k, v in cpu["c_alg3"]["x_avg"].items()}
    worst["alg3_xavg_rel"] = max(d.values())
    d = {k: abs(card["d_codec_error"]["err"][k] - v)
         for k, v in cpu["d_codec_error"]["err"].items()}
    worst["codec_err_abs"] = max(d.values())
    for R, idx in cpu["d_codec_error"]["indices"].items():
        if not torch.equal(card["d_codec_error"]["indices"][R], idx):
            raise AssertionError(f"NDE-Hadamard payload differs at {R}")
    for k, tol in ALG_TOL.items():
        if not worst[k] <= tol:
            raise AssertionError(f"card and CPU disagree: {k} {worst[k]} > "
                                 f"{tol}")
    return worst


def time_embeddings(P: dict, dev) -> dict:
    """Fig. 1c on the card: DE-Haar (30 LV rounds, dense), NDE-Haar and
    NDE-Hadamard medians by CUDA events, frames drawn on the card; and one
    DGD-DEF step on Alg. 1's problem (NDE-Hadamard, n 116, R 4) in host
    microseconds."""
    from repro_torch import random as rnd
    from repro_torch.core import coding as C
    from repro_torch.core import embeddings as E
    from repro_torch.core import frames as F
    from repro_torch.core import optim as O
    from repro_torch.kernels import ops
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ops.reset_launch_counts()
    for n in EMBED_TIME_N:
        haar = F.haar_frame(rnd.fold_in(rnd.key(0, device=dev), 1), n,
                            F.next_pow2(n))
        had = F.hadamard_frame(rnd.fold_in(rnd.key(0, device=dev), 2), n,
                               F.next_pow2(n))
        y = torch.randn(n, generator=g, device=dev) ** 3
        out[f"n{n}"] = {
            "de_haar_ms": timed(lambda: E.democratic(haar, y), 3),
            "nde_haar_ms": timed(lambda: E.near_democratic(haar, y), 10),
            "nde_hadamard_ms": timed(lambda: E.near_democratic(had, y), 10)}
        del haar
    out["fwht_launches"] = ops.launch_counts()["fwht"]
    p, steps = _to(P["alg1"], dev), 200
    grad = lambda x: p["h"] @ x - p["atb"]                     # noqa: E731
    alpha = O.alpha_star(p["L"], p["mu"])
    cod = C.Codec(F.hadamard_frame(rnd.key(0, device=dev), ALG1_N),
                  C.CodecConfig(bits_per_dim=4.0))
    x0 = torch.zeros(ALG1_N, device=dev)
    O.dgd_def(grad, x0, cod, alpha, 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    O.dgd_def(grad, x0, cod, alpha, steps)
    torch.cuda.synchronize()
    out["dgd_def_step_host_us"] = (time.perf_counter() - t) / steps * 1e6
    return out


def algorithms_phase(dev) -> dict:
    """Phase 9: run_algorithms on the CPU and on dev, compared; timings."""
    P = paper_problems()
    t = time.perf_counter()
    cpu = run_algorithms(P, torch.device("cpu"))
    cpu_s = time.perf_counter() - t
    card = run_algorithms(P, dev)
    worst = compare_algorithms(cpu, card, P)
    rates = card["a_alg1"]["rates"]
    log(f"[alg1] sigma {card['a_alg1']['sigma']} rates (card) "
        + json.dumps(rates))
    log("[alg2] final hinge loss at x_avg (card) " + json.dumps(
        {k: float(torch.clamp(1.0 - P["alg2"]["b"] * (P["alg2"]["a"] @ v),
                              min=0.0).mean())
         for k, v in card["b_alg2"]["x_avg"].items()}))
    log("[alg3] |x_avg| (card) " + json.dumps(
        {k: float(torch.linalg.vector_norm(v))
         for k, v in card["c_alg3"]["x_avg"].items()}))
    log("[codec error] (card) " + json.dumps(card["d_codec_error"]["err"]))
    log(f"[alg] card vs CPU worst {json.dumps(worst)} (tolerances "
        f"{json.dumps(ALG_TOL)})")
    timing = time_embeddings(P, dev)
    log("[embed time] " + json.dumps(timing))
    steps_per_s = {dev_name: {k: n / secs for k, (secs, n)
                              in r["steps"].items()}
                   for dev_name, r in (("card", card), ("cpu", cpu))}
    log("[alg] steps/s " + json.dumps(steps_per_s))
    record = {"worst": worst, "tolerances": ALG_TOL,
              "steps_per_s": steps_per_s,
              "fwht_launches": card["launches"],
              "cpu_fwht_launches": cpu["launches"],
              "seconds": {"card": card["seconds"], "cpu": cpu["seconds"],
                          "cpu_total": cpu_s},
              "alg1_rates": rates, "sigma": card["a_alg1"]["sigma"],
              "codec_error": card["d_codec_error"]["err"],
              "embed_time": timing}
    log(f"[alg] FWHT launches per sub-phase (card) "
        f"{json.dumps(card['launches'])}; seconds card "
        f"{json.dumps(card['seconds'])} cpu {json.dumps(cpu['seconds'])}")
    for name, n in card["launches"].items():
        if name != "b_alg2" and n == 0:
            raise AssertionError(f"{name} launched no FWHT on the card")
    return record


# -- phase 10: codecs and federation (codecs/*, fed/*), card vs CPU --------
# a. every wire codec at the trainer's size (yi-6b at full width cut to 4
#    layers, the tree phase 4 trains, filled with seeded values), the
#    registry's defaults (chunk 128); b. benchmarks/fed_heterogeneous at its
#    own size, card against the port's CPU run; c. fed_cohort_scaling's
#    m 512; d. fed_aggregate_scaling's tree at m 512.
CODEC_CASES = (("ndsc R2", "ndsc", 2.0, {}),
               ("ndsc R0.5", "ndsc", 0.5, {}),
               ("ratq R2", "ratq", 2.0, {}),
               ("ste topk R1", "sparsify_then_embed", 1.0,
                {"mode": "topk", "bits": 4}),
               ("ste randk R1", "sparsify_then_embed", 1.0,
                {"mode": "randk", "bits": 4}),
               # one Hadamard frame per leaf: N 2^14 (x2), 2^23 (x2), 2^26
               # (x2), 2^28 (x5) and 2^12, so 11 of 12 leaves run the
               # FWHT's passes, once in an encode and once in a decode
               ("dsc R2", "dsc", 2.0, {}),
               ("dsc R0.5", "dsc", 0.5, {}),
               # chunks of 16384: the encoders' and the FWHT's passes
               ("ndsc R2 chunk16384", "ndsc", 2.0, {"chunk": 16384}))
# dsc below 1 bit per embedded coordinate keeps a Bernoulli subset: its
# audit is the expected payload, its ledger the realized one, held within
# this many standard deviations of the kept count
DSC_KEEP_SIGMAS = 6.0
FED_M, FED_DIM, FED_PER, FED_ROUNDS, FED_CHUNK = 8, 128, 256, 50, 64
# max |Δx| / max |x|, card against CPU: tests/test_torch_fed.py's PARAM_TOL
FED_TOL = 1e-4
COHORT_M, COHORT_PER, COHORT_ROUNDS = 512, 32, 3
AGG_M, AGG_DIM = 512, 1024


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _same_tree(a, b) -> bool:
    from repro_torch import tree as tree_lib
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def codec_phase(dev) -> dict:
    """10a: each wire codec on the 4-layer yi-6b tree: encode, decode and
    (ndsc) encode_ef, each kernel's launches per call, median ms of 3
    CUDA-event timings, peak memory; the ledger equal to the audit to the
    byte (dsc at R 0.5: within DSC_KEEP_SIGMAS of it, see there), finite
    decodes, on one 4096-wide leaf (16384 values: N 16384 for dsc, one
    chunk of 16384 for ndsc's) the card's payload bitwise the CPU's, and
    for dsc the (4, 4096, 512) leaf too (N 2^23)."""
    from repro_torch import codecs, configs
    from repro_torch import random as rnd
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    cfg4 = dataclasses.replace(configs.get("yi-6b"), num_layers=4)
    shapes, spec = tree_lib.flatten(model_lib.param_shapes(cfg4),
                                    is_leaf=lambda x: isinstance(x, tuple))
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    tree = tree_lib.unflatten(spec, [
        torch.randn(s, generator=g, device=dev) for s in shapes])
    coords = sum(math.prod(s) for s in shapes)
    small = tree["blocks"]["attn_norm"]                      # (4, 4096)
    key, host_key = rnd.key(0, device=dev), rnd.key(0)
    log(f"[codecs] yi-6b x4 tree: {len(shapes)} leaves, {coords} "
        "coordinates")

    def count(fn):
        ops.reset_launch_counts()
        out = fn()
        _sync(dev)
        return out, {k: v for k, v in ops.launch_counts().items() if v}

    def median_ms(fn, reps=3):
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

    out = {}
    for label, name, budget, kw in CODEC_CASES:
        c = codecs.make(name, budget, **kw)
        meta = c.meta(tree)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wire, enc_counts = count(lambda: c.encode(key, tree, 1))
        dec, dec_counts = count(lambda: c.decode(wire, meta))
        if not all(bool(torch.isfinite(x).all())
                   for x in tree_lib.leaves(dec)):
            raise AssertionError(f"{label}: non-finite decode")
        del dec
        ledger, audit = c.wire_bytes(wire, meta), c.wire_bits(tree) / 8
        r = {}
        if name == "dsc" and budget < 1.0:
            # kept ~ Binomial(N, p) per leaf, p = R·n/N
            var = 0.0
            for shape in shapes:
                n = math.prod(shape)
                big_n = 1 << (n - 1).bit_length()
                p = budget * n / big_n
                var += big_n * p * (1 - p)
            r["ledger_minus_audit_sigmas"] = (
                (ledger - audit) * 8 / math.sqrt(var))
            if abs(r["ledger_minus_audit_sigmas"]) > DSC_KEEP_SIGMAS:
                raise AssertionError(f"{label}: ledger {ledger} is "
                                     f"{r['ledger_minus_audit_sigmas']:.2f} "
                                     f"sigmas from the audit {audit}")
        elif ledger != audit:
            raise AssertionError(f"{label}: ledger {ledger} != audit {audit}")
        r |= {"name": c.name, "wire_bytes": ledger, "audit_bytes": audit,
              "encode_launches": enc_counts, "decode_launches": dec_counts,
              "encode_ms": median_ms(lambda: c.encode(key, tree, 1)),
              "decode_ms": median_ms(lambda: c.decode(wire, meta))}
        if c.encode_ef is not None:
            (wire2, resid), ef_counts = count(
                lambda: c.encode_ef(key, tree, meta, 1))
            if not _same_tree(wire, wire2):
                raise AssertionError(f"{label}: encode_ef's wire differs")
            if not all(bool(torch.isfinite(x).all())
                       for x in tree_lib.leaves(resid)):
                raise AssertionError(f"{label}: non-finite residual")
            del wire2, resid
            r["encode_ef_launches"] = ef_counts
            r["encode_ef_ms"] = median_ms(
                lambda: c.encode_ef(key, tree, meta, 1))
        r["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del wire
        # the card's payload against the CPU's on one 4096-wide leaf, and
        # for dsc on the (4, 4096, 512) leaf, a frame of N 2^23
        for leaf in [small] + ([tree["blocks"]["wk"]] if name == "dsc"
                               else []):
            if not _same_tree(c.encode(host_key, {"x": leaf.cpu()}, 1),
                              c.encode(key, {"x": leaf}, 1)):
                raise AssertionError(f"{label}: card payload != CPU payload "
                                     f"at {tuple(leaf.shape)}")
        log(f"[codecs] {label}: " + json.dumps(r))
        out[label] = r
    del tree
    torch.cuda.empty_cache()
    return {"coordinates": coords, "leaves": len(shapes), "codecs": out}


def fed_problem(m, dim, per_client, scale_span, seed=0):
    """fed_heterogeneous.make_problem's least squares drawn in numpy, as
    tests/test_torch_fed.py draws it: (CPU shards, lr = α*, the probe
    norms ‖∇f_i(0)‖)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    scales = np.logspace(-scale_span, scale_span, m)
    a = (rng.standard_normal((m, per_client, dim))
         / np.sqrt(per_client)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    shards = [{"a": (scales[i] * a[i]).astype(np.float32),
               "b": (scales[i] * (a[i] @ x_true)).astype(np.float32)}
              for i in range(m)]
    all_a = np.concatenate([s["a"] for s in shards]).astype(np.float64)
    eigs = np.linalg.eigvalsh(all_a.T @ all_a / all_a.shape[0])
    norms = [float(np.linalg.norm(s["a"].astype(np.float64).T
                                  @ s["b"].astype(np.float64)) / per_client)
             for s in shards]
    return ([{k: torch.from_numpy(v) for k, v in s.items()} for s in shards],
            float(2.0 / (eigs[-1] + eigs[0])), norms)


def ls_loss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * torch.mean(r * r)


def ls_loss64(p, batch):
    """ls_loss accumulated in f64 (the gradient rounds to f32 at the end),
    so that the card's and the CPU's gradients agree bit for bit."""
    r = batch["a"].double() @ p["x"].double() - batch["b"].double()
    return 0.5 * torch.mean(r * r)


def run_fed(dev, shards, lr, codecs_, loss_fn, server_kw, fed_kw, rounds,
            use_cohorts=True):
    from repro_torch import fed
    dim = shards[0]["a"].shape[1]
    f = fed.Federation(loss_fn, {"x": torch.zeros(dim)}, shards, codecs_,
                       fed.ClientConfig(lr=lr), fed.ServerConfig(**server_kw),
                       seed=0, use_cohorts=use_cohorts, device=dev)
    _sync(dev)
    t = time.perf_counter()
    hist = f.run(fed.FedConfig(num_rounds=rounds, seed=0, **fed_kw))
    _sync(dev)
    return f, hist, time.perf_counter() - t


def fed_phase(dev) -> dict:
    """10b-d (see the constants above)."""
    from repro_torch import codecs, fed
    from repro_torch import tree as tree_lib
    from repro_torch.fed import budget
    from repro_torch.kernels import ops
    from repro_torch.optimizer import optim
    cpu = torch.device("cpu")
    out = {"b": {}, "c": {}, "d": {}}

    # b. fed_heterogeneous, card against the port's CPU run
    shards, lr, norms = fed_problem(FED_M, FED_DIM, FED_PER, 1.0)
    rates = budget.allocate("norm_proportional", 1.0 * FED_M, FED_M,
                            norms=norms, min_rate=0.25)
    cs = [codecs.make("ndsc", float(r), chunk=FED_CHUNK) for r in rates]
    for label, server_kw, fed_kw in (
            ("fedavg", {}, {}),
            ("fedmem partial", {"aggregator": "fedmem", "server_lr": 0.25},
             {"participation": 0.5, "dropout": 0.2})):
        for loss_name, loss_fn in (("f64 loss", ls_loss64),
                                   ("f32 loss", ls_loss)):
            (fh, hh, hs), (fc, hc, card_s) = [
                run_fed(d, shards, lr, cs, loss_fn, server_kw, fed_kw,
                        FED_ROUNDS) for d in (cpu, dev)]
            for k in ("participants", "stragglers", "wire_bytes",
                      "analytic_bytes"):
                if hh[k] != hc[k]:
                    raise AssertionError(f"10b {label}: {k} differs")
            if hc["wire_bytes"] != hc["analytic_bytes"]:
                raise AssertionError(f"10b {label}: ledger != audit")
            want = fh.server.params["x"]
            gap = float((fc.server.params["x"].cpu() - want).abs().max()
                        / want.abs().max())
            r = {"gap_rel": gap, "cpu_s": hs, "card_s": card_s,
                 "wire_bytes_per_round": hc["wire_bytes"][0],
                 "stragglers": sum(len(x) for x in hc["stragglers"])}
            # the f32 loss sums in cuBLAS's order on the card and MKL's on
            # the CPU: its gap is reported, the f64 loss's is held
            if loss_name == "f64 loss" and gap > FED_TOL:
                raise AssertionError(f"10b {label}: params gap {gap}")
            out["b"][f"{label}, {loss_name}"] = r
            log(f"[fed b] {label}, {loss_name}: " + json.dumps(r))
    shared = codecs.make("ndsc", 1.0, chunk=FED_CHUNK)
    runs = [run_fed(dev, shards, lr, shared, ls_loss, {"aggregator": "fedmem",
                                                      "server_lr": 0.25},
                    {"participation": 0.5, "dropout": 0.2}, FED_ROUNDS,
                    use_cohorts=u) for u in (True, False)]
    if not (runs[0][1] == runs[1][1]
            and _same_tree(runs[0][0].server, runs[1][0].server)
            and all(_same_tree(a, b) for a, b in zip(runs[0][0].states,
                                                     runs[1][0].states))):
        raise AssertionError("10b: cohort != scalar on the card")
    out["b"]["cohort vs scalar (card)"] = {"cohort_s": runs[0][2],
                                           "scalar_s": runs[1][2]}
    log("[fed b] cohort == scalar on the card, bitwise; s "
        + json.dumps(out["b"]["cohort vs scalar (card)"]))

    # c. the cohort engine at m 512 (fed_cohort_scaling)
    shards, lr, _ = fed_problem(COHORT_M, FED_DIM, COHORT_PER, 0.0)
    codec = codecs.make("ndsc", 2.0, chunk=FED_CHUNK)
    cfg = fed.FedConfig(num_rounds=1, seed=0)

    def make(d, cohorts):
        return fed.Federation(ls_loss, {"x": torch.zeros(FED_DIM)}, shards,
                              codec, fed.ClientConfig(lr=lr), seed=0,
                              use_cohorts=cohorts, device=d)

    fc, fs = make(dev, True), make(dev, False)
    t = time.perf_counter()
    rc = fc.run_round(cfg, 0)
    _sync(dev)
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    rs = fs.run_round(cfg, 0)
    _sync(dev)
    scalar_s = time.perf_counter() - t
    if not (rc == rs and _same_tree(fc.server, fs.server)
            and all(_same_tree(a, b) for a, b in zip(fc.states, fs.states))):
        raise AssertionError("10c: cohort round != scalar round")
    ops.reset_launch_counts()
    fc.run_round(cfg, 1)
    _sync(dev)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if counts.get("encode_ef") != 1 or counts.get("unpack_dequant") != 1:
        raise AssertionError(f"10c: a cohort round launched {counts}")
    rps = {}
    for label, d, f in (("card", dev, fc), ("cpu", cpu, make(cpu, True))):
        f.run_round(cfg, 1)
        _sync(d)
        t = time.perf_counter()
        for r in range(2, 2 + COHORT_ROUNDS):
            f.run_round(cfg, r)
        _sync(d)
        rps[label] = COHORT_ROUNDS / (time.perf_counter() - t)
    out["c"] = {"rounds_per_s": rps, "launches_per_round": counts,
                "first_round_s": first_s, "scalar_round_s": scalar_s,
                "wire_bytes_per_round": rc["wire_bytes"]}
    log("[fed c] m 512: " + json.dumps(out["c"]))

    # d. server folds on fed_aggregate_scaling's tree at m 512
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    sizes = {"w1": (AGG_DIM // 2, 2), "b1": (AGG_DIM // 4,),
             "w2": (AGG_DIM // 4, 2), "b2": (AGG_DIM // 4,)}
    params = {k: torch.randn(s, generator=g, device=dev)
              for k, s in sizes.items()}
    stacked = {k: torch.randn((AGG_M,) + s, generator=g, device=dev)
               for k, s in sizes.items()}
    deltas = fed.unstack_tree(stacked, AGG_M)
    w = torch.rand(AGG_M, generator=g, device=dev).cpu().numpy() + 0.5
    for label, kw in (("fedavg", {}),
                      ("fedopt", {"aggregator": "fedopt", "optimizer":
                                  optim.sgd(1.0, momentum=0.9)})):
        times = {}
        res = {}
        for mode, fn in (("list", fed.aggregate),
                         ("sequential", fed.aggregate_stacked),
                         ("pairwise", fed.aggregate_stacked)):
            scfg = fed.ServerConfig(sum_mode=("sequential" if mode == "list"
                                              else mode), **kw)
            st = fed.init_server(params, scfg, AGG_M)
            arg = deltas if mode == "list" else stacked
            fn(st, scfg, arg, w)
            _sync(dev)
            t = time.perf_counter()
            res[mode] = fn(st, scfg, arg, w)
            _sync(dev)
            times[mode] = (time.perf_counter() - t) * 1e3
        if not _same_tree(res["list"], res["sequential"]):
            raise AssertionError(f"10d {label}: sequential != list")
        gap = max(float((a - b).abs().max()) for a, b in zip(
            tree_lib.leaves(res["sequential"].params),
            tree_lib.leaves(res["pairwise"].params)))
        out["d"][label] = {"ms": times, "pairwise_gap_abs": gap}
        log(f"[fed d] {label}: " + json.dumps(out["d"][label]))
    return out


# -- satellite of phase 3: quantize_pack at the RATQ train shape --------------
RATQ_CHUNK, RATQ_BITS = 128, 2


def time_quantize_pack_ratq(ops, ref, dev, cfg) -> dict:
    """quantize_pack on the 12 leaves of `cfg`'s tree in chunks of 128 at
    R 2 (one RATQ encode's 12 launches): checked against the plain
    version, timed (CUDA events, medians of 5), bounded by its bytes."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import cost as kcost
    from repro_torch.models import model as model_lib
    shapes = tree_lib.leaves(model_lib.param_shapes(cfg),
                             is_leaf=lambda s: isinstance(s, tuple))
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    leaves = []
    for shape in shapes:
        rows = -(-math.prod(shape) // RATQ_CHUNK)
        x = torch.randn(rows, RATQ_CHUNK, generator=g, device=dev)
        leaves.append((x, x.abs().amax(-1, keepdim=True)))
    for x, s in leaves:
        if not torch.equal(ops.quantize_pack(x, s, RATQ_BITS),
                           ref.quantize_pack(x, s, RATQ_BITS)):
            raise AssertionError(f"quantize_pack differs at {tuple(x.shape)}")
    coords = sum(x.numel() for x, _ in leaves)
    rows = sum(x.shape[0] for x, _ in leaves)
    ops.reset_launch_counts()
    for x, s in leaves:
        ops.quantize_pack(x, s, RATQ_BITS)
    launches = ops.launch_counts()["quantize_pack"]
    b, by = bound_ms(*kcost.quantize_pack(coords, rows, RATQ_BITS))
    out = {"leaves": len(leaves), "rows": rows, "coordinates": coords,
           "launches_per_encode": launches,
           "ms": timed(lambda: [ops.quantize_pack(x, s, RATQ_BITS)
                                for x, s in leaves]),
           "plain_ms": timed(lambda: [ref.quantize_pack(x, s, RATQ_BITS)
                                      for x, s in leaves], 3),
           "library_ms": None, "bound_ms": b, "bound_by": by,
           "max_abs_err": 0.0}
    del leaves
    torch.cuda.empty_cache()
    return out


# -- phase 3f: the FWHT and the encoders above N = 8192 ----------------------
# dense x @ H beside the FWHT's passes at these (N, rows): H is 1 GiB and
# 4 GiB, x 256 MB; at the dsc frames' N (checks.FWHT_HUGE_N) H does not fit
LARGE_LIB_SHAPES = ((16384, 4096), (32768, 2048))
LARGE_CHUNK = 16384          # the codec chunk of 3f's encoders and phase 5b


def time_large_fwht(ops, ref, dev) -> dict:
    """3f: the FWHT's passes at LARGE_LIB_SHAPES (with x @ H) and on one
    row of each checks.FWHT_HUGE_N (the dsc codec's frames of a full-width
    yi-6b, 2^28 = 1 GiB): bitwise the plain version, timed (CUDA events,
    medians of 5; plain of 3), with the bound and the pass count."""
    from repro_torch.kernels import checks
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fwht as F
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    shapes = list(LARGE_LIB_SHAPES) + [(n, 1) for n in checks.FWHT_HUGE_N]
    for n, rows in shapes:
        x = torch.randn(rows, n, generator=g, device=dev)
        if not torch.equal(ops.fwht(x), ref.fwht(x)):
            raise AssertionError(f"fwht differs at ({rows}, {n})")
        log2n = n.bit_length() - 1
        b, by = bound_ms(*kcost.fwht(x.numel(), n))
        r = {"shape": [rows, n], "passes": len(F.fwht_plan(log2n)),
             "ms": timed(lambda: ops.fwht(x)),
             "plain_ms": timed(lambda: ref.fwht(x), 3),
             "bound_ms": b, "bound_by": by, "max_abs_err": 0.0,
             "library_ms": "none (H does not fit)"}
        if (n, rows) in LARGE_LIB_SHAPES:
            h = ref.fwht(torch.eye(n, device=dev))               # dense H
            r["library_ms"] = timed(lambda: x @ h)
            del h
        out[f"fwht/{rows}x2^{log2n}"] = r
        del x
        torch.cuda.empty_cache()
    return out


def time_large_encoders(ops, ref, dev, cfg) -> dict:
    """3f: encode_ef (EF, f32 residual) and encode (dither, keep-0.5 row
    mask) at chunk LARGE_CHUNK on `cfg`'s leaves (phase 5b's shapes): each
    leaf's words, scales and residual bitwise the plain version; the tree
    timed (CUDA events, medians of 5; plain of 3) with its bound and its
    launches (one per leaf)."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import cost as kcost
    from repro_torch.models import model as model_lib
    gc = G.GradCompConfig(bits=4, chunk=LARGE_CHUNK)
    bits, chunk = gc.bits, gc.chunk
    shapes = tree_lib.leaves(model_lib.param_shapes(cfg),
                             is_leaf=lambda s: isinstance(s, tuple))
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    delta = 2.0 / 2 ** bits
    leaves, draws = [], []
    for i, shape in enumerate(shapes):
        rows = -(-math.prod(shape) // chunk)
        u = torch.randn(rows, chunk, generator=g, device=dev) * 1e-3
        leaves.append((u, G._frame_signs(i, gc, dev)))
        draws.append(((torch.rand(u.shape, generator=g, device=dev) - 0.5)
                      * delta, (torch.rand(rows, 1, generator=g, device=dev)
                                < 0.5).float()))
    for (u, s), (d, m) in zip(leaves, draws):
        got, want = ops.encode_ef(u, s, bits), ref.encode_ef(u, s, bits)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            raise AssertionError(f"encode_ef differs at {tuple(u.shape)}")
        got = ops.encode(u, s, bits, dither=d, mask=m)
        want = ref.encode(u, s, bits, dither=d, mask=m)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            raise AssertionError(f"encode differs at {tuple(u.shape)}")
        del got, want
    coords = sum(u.numel() for u, _ in leaves)
    rows = sum(u.shape[0] for u, _ in leaves)
    ops.reset_launch_counts()
    [ops.encode_ef(u, s, bits) for u, s in leaves]
    [ops.encode(u, s, bits, dither=d, mask=m)
     for (u, s), (d, m) in zip(leaves, draws)]
    launches = ops.launch_counts()
    out = {"leaves": len(leaves), "rows": rows, "coordinates": coords,
           "chunk": chunk}
    b, by = bound_ms(*kcost.encode_ef(coords, rows, chunk, bits))
    out["encode_ef"] = {
        "launches_per_tree": launches["encode_ef"],
        "ms": timed(lambda: [ops.encode_ef(u, s, bits) for u, s in leaves]),
        "plain_ms": timed(lambda: [ref.encode_ef(u, s, bits)
                                   for u, s in leaves], 3),
        "library_ms": None, "bound_ms": b, "bound_by": by,
        "max_abs_err": 0.0}
    b, by = bound_ms(*kcost.encode(coords, rows, chunk, bits, dither=True,
                                   mask=True))
    out["encode"] = {
        "launches_per_tree": launches["encode"],
        "ms": timed(lambda: [ops.encode(u, s, bits, dither=d, mask=m)
                             for (u, s), (d, m) in zip(leaves, draws)]),
        "plain_ms": timed(lambda: [ref.encode(u, s, bits, dither=d, mask=m)
                                   for (u, s), (d, m) in zip(leaves, draws)],
                          3),
        "library_ms": None, "bound_ms": b, "bound_by": by,
        "max_abs_err": 0.0}
    del leaves, draws, u, s, d, m
    torch.cuda.empty_cache()
    return out


# -- phase 5b: training at chunk 16384 (the encoders' and the FWHT's passes) --
def train_chunk_phase(dev, cfg=None, steps: int = 2) -> dict:
    """5b: yi-6b at full width cut to 1 layer, `steps` steps of
    launch.train.train at the launcher's defaults but chunk LARGE_CHUNK
    (R 4, allgather_packed with EF, batch 8, seq 128): encode_ef,
    unpack_dequant and fwht launch once per leaf and step (12), all above
    N = 8192; loss and params finite; then the wq leaf's words, scales and
    EF residual (its first and last 64 chunks) bitwise its CPU encode."""
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import train

    cfg = cfg or dataclasses.replace(configs.get("yi-6b"), num_layers=1)
    gc = G.GradCompConfig(bits=4, chunk=LARGE_CHUNK)
    per_step = []

    def count_step(step, metrics):
        per_step.append(ops.launch_counts())
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"5b: non-finite loss at step {step}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, losses, secs = train(cfg, steps=steps, batch_size=8, seq_len=128,
                                 gc=gc, lr=3e-4, log_every=1, device=dev,
                                 on_step=count_step)
    counts = ops.launch_counts()
    n_leaves = len(tree_lib.leaves(params))
    prev = {k: 0 for k in counts}
    for s, c in enumerate(per_step):
        for k in ("encode_ef", "unpack_dequant", "fwht"):
            if c[k] - prev[k] != n_leaves:
                raise AssertionError(f"5b step {s}: {k} launched "
                                     f"{c[k] - prev[k]} times, want "
                                     f"{n_leaves}")
        prev = c
    if counts["encode"] != 0:
        raise AssertionError("5b: the EF path launched the plain encode")
    if not all(bool(torch.isfinite(p).all())
               for p in tree_lib.leaves(params)):
        raise AssertionError("5b: non-finite parameters")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # "blocks" sorts first among the top-level keys, and its leaves are
    # plain tensors: leaf i is the i-th block key in sorted order
    i = sorted(params["blocks"]).index("wq")
    u = tree_lib.leaves(params)[i]
    payload, resid = G.encode_leaf_ef(u, i, gc, 0)
    chunks = G._to_chunks(u, gc.chunk)
    rows = chunks.shape[0]
    signs = G._frame_signs(i, gc, "cpu")
    spans = sorted({(0, min(64, rows)), (max(0, rows - 64), rows)})
    for r0, r1 in spans:
        want = ref.encode_ef(chunks[r0:r1].cpu(), signs, gc.bits)
        got = (payload["words"][r0:r1].cpu(), payload["scale"][r0:r1].cpu(),
               resid.reshape(rows, gc.chunk)[r0:r1].cpu())
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            raise AssertionError(f"5b: wq chunks {r0}..{r1} differ from the "
                                 "CPU encode")
    out = {"leaves": n_leaves, "chunk": gc.chunk, "losses": losses,
           "step_s": secs, "peak_mem_GB": peak_gb, "launches": counts,
           "wq_chunks": rows, "wq_chunks_checked_bitwise": spans}
    log(f"[5b train x1 chunk {gc.chunk}] {json.dumps(out)}")
    del params, payload, resid, chunks, u
    torch.cuda.empty_cache()
    return out


# -- phase 11: distributed consensus and the mesh federation -----------------
# a. one NCCL rank in this process at phase 4's size; b-d. four ranks
#    sharing the card (fresh interpreters: this script with --rank), gloo by
#    the backend rule, each writing its results to OUT_DIR/dist/.
DIST_RANKS = 4
DIST_LR = 1e-2                # b: SGD, no clip
DIST_STEPS = 2
RANK_TIMEOUT_S = 900.0


def _leaves_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def one_rank_phase(dev, cfg4, gc_ef) -> dict:
    """11a: train(group=...) on an NCCL world of 1 against group=None
    (loss and params bitwise), then ZeRO-1 against all-gather after one
    step (clip off, AdamW), with s/step and launches per step."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import batch_for_shape
    from repro_torch.dist import step as step_lib
    from repro_torch.dist import zero as zero_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.launch.train import train
    from repro_torch.optimizer import optim
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        group, _ = mesh.init_workers(0, 1, f"file://{tmp}/store", device=dev)
        try:
            out["backend"] = dist.get_backend(group)
            log(f"[dist a] world of 1, backend {out['backend']}")
            runs = {}
            for label, g in (("group", group), ("none", None)):
                ops.reset_launch_counts()
                params, losses, secs = train(cfg4, steps=DIST_STEPS,
                                             batch_size=8, seq_len=128,
                                             gc=gc_ef, lr=3e-4, log_every=1,
                                             device=dev, group=g)
                counts = ops.launch_counts()
                runs[label] = (tree_lib.leaves(params), losses, secs, counts)
                if label == "group":
                    for k in ("encode_ef", "unpack_dequant", "fwht"):
                        if counts[k] != 12 * DIST_STEPS:
                            raise AssertionError(f"11a: {k} {counts[k]}")
                del params
            (pg, lg, sg, cg), (pn, ln, sn, _) = runs["group"], runs["none"]
            if not (lg == ln and _leaves_equal(pg, pn)):
                raise AssertionError("11a: group of 1 != no group")
            out.update({"losses": lg, "step_s_group": sg, "step_s_none": sn,
                        "launches": {k: v for k, v in cg.items() if v}})
            del runs, pg, pn
            torch.cuda.empty_cache()

            batch = batch_for_shape(cfg4, 8, 128, 0, 0, device=dev)
            res = {}
            for strategy in ("alltoall_zero1", "allgather_packed"):
                gc = dataclasses.replace(gc_ef, strategy=strategy)
                opt = optim.adamw(optim.warmup_cosine(3e-4, 1, 3),
                                  weight_decay=0.1)
                if strategy == "alltoall_zero1":
                    st = step_lib.init_zero_state(cfg4, opt, gc, group,
                                                  seed=0, device=dev)
                    fn = step_lib.make_zero_train_step(cfg4, opt, gc, group)
                else:
                    st = step_lib.init_train_state(cfg4, opt, gc, group,
                                                   seed=0, device=dev)
                    fn = step_lib.make_train_step(cfg4, opt, gc, group)
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                st = fn(*st, batch)
                torch.cuda.synchronize()
                res[strategy] = (tree_lib.leaves(st[0]),
                                 time.perf_counter() - t,
                                 {k: v for k, v in ops.launch_counts().items()
                                  if v})
                del st
                torch.cuda.empty_cache()
            want = {"alltoall_zero1": {"encode": 12, "unpack_dequant": 24,
                                       "fwht": 24},
                    "allgather_packed": {"encode_ef": 12,
                                         "unpack_dequant": 12, "fwht": 12}}
            for strategy, (_, _, counts) in res.items():
                if counts != want[strategy]:
                    raise AssertionError(f"11a: {strategy} launches {counts}")
            owned, full = res["alltoall_zero1"][0], res["allgather_packed"][0]
            for o, p in zip(owned, full):
                if not torch.equal(zero_lib.from_owned(
                        o, p.numel(), tuple(p.shape), p.dtype), p):
                    raise AssertionError("11a: ZeRO-1 != all-gather")
            out["zero1_vs_allgather"] = {
                k: {"step_s": v[1], "launches": v[2]} for k, v in res.items()}
            del res, owned, full
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log("[dist a] " + json.dumps(out))
    return out


def rank_consensus(group, dev, cfg, rank: int, world: int) -> dict:
    """11b on one rank: 2 steps of each strategy at `cfg`, SGD, no clip."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import batch_for_shape
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import sharding
    from repro_torch.dist import step as step_lib
    from repro_torch.dist import zero as zero_lib
    from repro_torch.kernels import ops
    from repro_torch.optimizer import optim
    out = {}
    ag1 = None
    for strategy in ("psum", "psum_decoded", "allgather_packed",
                     "alltoall_zero1"):
        gc = G.GradCompConfig(bits=4, chunk=256, strategy=strategy)
        opt = optim.sgd(DIST_LR)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero = strategy == "alltoall_zero1"
        if zero:
            st = step_lib.init_zero_state(cfg, opt, gc, group, seed=0,
                                          device=dev)
            fn = step_lib.make_zero_train_step(cfg, opt, gc, group)
        else:
            st = step_lib.init_train_state(cfg, opt, gc, group, seed=0,
                                           device=dev)
            fn = step_lib.make_train_step(cfg, opt, gc, group)
        steps = []
        for s in range(DIST_STEPS):
            batch = batch_for_shape(cfg, 8, 128, s, 0, device=dev)
            sharding.reset_transport_counts()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            *st, met = fn(*st, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            tc = sharding.transport_counts()
            rec = {"s": dt, "loss": float(met["loss"]),
                   "collective_s": sum(v["seconds"] for v in tc.values()),
                   "bytes": {k: v["bytes"] for k, v in tc.items()},
                   "allocated_GB": torch.cuda.memory_allocated() / 1e9,
                   "launches": {k: v for k, v in ops.launch_counts().items()
                                if v}}
            if not zero:
                sharding.check_replicas_equal(st[0], group)
                rec["replicas_equal"] = True
            if strategy == "allgather_packed":
                want = G.wire_bytes_tree(st[0], gc, world)["payload_bytes"]
                if tc["all_gather"]["bytes"] != want:
                    raise AssertionError(
                        f"11b: {tc['all_gather']['bytes']} payload bytes "
                        f"sent, the audit says {want}")
                if s == 0:
                    ag1 = [p.clone() for p in tree_lib.leaves(st[0])]
            if zero and s == 0:
                same = True
                for o, p in zip(tree_lib.leaves(st[0]), ag1):
                    full = zero_lib.to_owned(p, gc.chunk, world)
                    rows = full.shape[0] // world
                    same &= torch.equal(o, full[rank * rows:
                                                (rank + 1) * rows])
                if not same:
                    raise AssertionError("11b: ZeRO-1 != all-gather")
                rec["zero1_eq_allgather"] = True
                ag1 = None
            steps.append(rec)
            print(f"[rank {rank}] {strategy} step {s}: " + json.dumps(rec),
                  flush=True)
        out[strategy] = {"steps": steps, "peak_mem_GB":
                         torch.cuda.max_memory_allocated() / 1e9}
        del st
    # the words rank 0 receives from rank r are rank r's own: every rank
    # re-encodes each rank's seeded 4096-wide leaf
    gc = G.GradCompConfig(bits=4, chunk=256)

    def leaf_of(r):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + r)
        return torch.randn(1, 4096, generator=g, device=dev)

    gathered = sharding.all_gather_stack(
        G.encode_leaf(leaf_of(rank), 0, gc)["words"], group)
    out["words_from_each_rank"] = all(
        torch.equal(gathered[r], G.encode_leaf(leaf_of(r), 0, gc)["words"])
        for r in range(world))
    if not out["words_from_each_rank"]:
        raise AssertionError("11b: gathered words differ from the senders'")
    return out


def rank_card_vs_cpu(group, dev, small) -> dict:
    """11c on one rank: the reduced model, 2 steps of allgather_packed with
    EF on the card and on the CPU from the same weights and tokens."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as step_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optimizer import optim
    lr = 3e-4
    gc = G.GradCompConfig()
    p0 = model_lib.init_params(0, small, "cpu")
    g = torch.Generator()
    g.manual_seed(4)
    toks = [torch.randint(0, small.vocab_size, (8, 17), generator=g,
                          dtype=torch.int32) for _ in range(DIST_STEPS)]
    runs = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        opt = optim.adamw(optim.warmup_cosine(lr, 1, 10), weight_decay=0.1)
        fn = step_lib.make_train_step(small, opt, gc, group, clip_norm=1.0)
        params = tree_lib.map(lambda x: x.clone().to(d), p0)
        st = (params, opt.init(params), tree_lib.map(
            lambda x: torch.zeros((1,) + tuple(x.shape), device=d), params))
        hist = []
        for s in range(DIST_STEPS):
            *st, met = fn(*st, {"tokens": toks[s].to(d)})
            # copies: the step updates the params in place
            hist.append((float(met["loss"]),
                         [x.detach().cpu().clone()
                          for x in tree_lib.leaves(st[0])]))
        runs[label] = hist
    out = []
    for s in range(DIST_STEPS):
        (lc, pc), (lg, pg) = runs["cpu"][s], runs["card"][s]
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pc, pg)])
        rec = {"loss_cpu": lc, "loss_card": lg,
               "max_dparam": float(diffs.max()),
               "median_dparam": float(diffs.median())}
        # phase 6's bounds
        if not (abs(lc - lg) <= 1e-4 * abs(lc)
                and rec["max_dparam"] <= 3 * lr * (s + 1)
                and rec["median_dparam"] <= 1e-6):
            raise AssertionError(f"11c: card and CPU disagree: {rec}")
        out.append(rec)
    return {"steps": out}


def rank_mesh_fed(group, dev, rank: int, cohort_m: int, het_rounds: int,
                  cohort_rounds: int) -> dict:
    """11d on one rank: fed_cohort_scaling's m 512 and fed_heterogeneous
    under backend="mesh"; rank 0 also runs the single-process vmap backend
    on the card and compares."""
    from repro_torch import codecs, fed
    from repro_torch.dist import sharding
    from repro_torch.fed import budget
    from repro_torch.kernels import ops
    out = {}
    shards, lr, _ = fed_problem(cohort_m, FED_DIM, COHORT_PER, 0.0)
    codec = codecs.make("ndsc", 2.0, chunk=FED_CHUNK)
    cfg = fed.FedConfig(num_rounds=1, seed=0)

    def make(backend, **server_kw):
        return fed.Federation(
            ls_loss, {"x": torch.zeros(FED_DIM)}, shards, codec,
            fed.ClientConfig(lr=lr), fed.ServerConfig(**server_kw), seed=0,
            backend=backend, group=group if backend == "mesh" else None,
            device=dev)

    fm = make("mesh")
    recs = [fm.run_round(cfg, 0)]
    ops.reset_launch_counts()
    recs.append(fm.run_round(cfg, 1))
    _sync(dev)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if counts.get("encode_ef") != 1 or counts.get("unpack_dequant") != 1:
        raise AssertionError(f"11d: a mesh round launched {counts}")
    t = time.perf_counter()
    for r in range(2, 2 + cohort_rounds):
        recs.append(fm.run_round(cfg, r))
    _sync(dev)
    out["cohort"] = {"lanes_per_rank": cohort_m // sharding.num_workers(
        group), "launches_per_round": counts,
        "rounds_per_s": cohort_rounds / (time.perf_counter() - t),
        "wire_bytes_per_round": recs[0]["wire_bytes"]}
    sharding.check_replicas_equal(fm.server.params, group, "server params")
    fp = make("mesh", sum_mode="pairwise")
    for r in range(2 + cohort_rounds):
        fp.run_round(cfg, r)
    out["cohort"]["pairwise_gap_abs"] = float(
        (fp.server.params["x"] - fm.server.params["x"]).abs().max())
    if rank == 0:
        fv = make("vmap")
        vrecs = [fv.run_round(cfg, r) for r in range(2 + cohort_rounds)]
        if not (vrecs == recs and _same_tree(fv.server, fm.server)):
            raise AssertionError("11d: mesh != vmap at m 512")
        out["cohort"]["mesh_eq_vmap"] = True
    out["obs"] = rank_mesh_obs(lambda: make("mesh"), cfg, recs, fm.server)

    # fed_heterogeneous (phase 10b's runs, the f32 loss) under the mesh
    shards, lr, norms = fed_problem(FED_M, FED_DIM, FED_PER, 1.0)
    rates = budget.allocate("norm_proportional", 1.0 * FED_M, FED_M,
                            norms=norms, min_rate=0.25)
    cs = [codecs.make("ndsc", float(r), chunk=FED_CHUNK) for r in rates]
    out["het"] = {}
    for label, server_kw, fed_kw in (
            ("fedavg", {}, {}),
            ("fedmem partial", {"aggregator": "fedmem", "server_lr": 0.25},
             {"participation": 0.5, "dropout": 0.2})):
        runs = {}
        for backend in ("mesh", "vmap") if rank == 0 else ("mesh",):
            f = fed.Federation(
                ls_loss, {"x": torch.zeros(FED_DIM)}, shards, cs,
                fed.ClientConfig(lr=lr), fed.ServerConfig(**server_kw),
                seed=0, backend=backend,
                group=group if backend == "mesh" else None, device=dev)
            _sync(dev)
            t = time.perf_counter()
            h = f.run(fed.FedConfig(num_rounds=het_rounds, seed=0,
                                    **fed_kw))
            _sync(dev)
            runs[backend] = (f, h, time.perf_counter() - t)
        f, h, secs = runs["mesh"]
        if h["wire_bytes"] != h["analytic_bytes"]:
            raise AssertionError(f"11d {label}: ledger != audit")
        rec = {"mesh_s": secs, "wire_bytes_per_round": h["wire_bytes"][0]}
        if rank == 0:
            fv, hv, _ = runs["vmap"]
            for k in ("participants", "stragglers", "wire_bytes",
                      "analytic_bytes"):
                if hv[k] != h[k]:
                    raise AssertionError(f"11d {label}: {k} differs")
            rec["params_bitwise_vmap"] = _same_tree(fv.server, f.server)
        out["het"][label] = rec
    return out


def rank_mesh_obs(make, cfg, recs, server) -> dict:
    """14b on one rank: the same mesh rounds as `recs` from a fresh
    Federation (`make()`) under an obs session: ledger and params bitwise
    the obs-off run's (`recs`, `server`); the rank's fed.round spans and
    fed.* counters, and its registration of fed.round.mesh and
    fed.aggregate.mesh."""
    from repro_torch import obs
    from repro_torch.fed import mesh as mesh_lib
    from repro_torch.obs import recompile
    mesh_lib._mesh_mean_fn.cache_clear()     # registers anew in the session
    names = []

    def on_register(name, fn):
        names.append(name)

    recompile.add_callback(on_register)
    session = obs.enable()
    try:
        fo = make()
        orecs = [fo.run_round(cfg, r) for r in range(len(recs))]
    finally:
        obs.disable()
        recompile.remove_callback(on_register)
    if not (orecs == recs and _same_tree(fo.server, server)):
        raise AssertionError("14b: the mesh run under obs differs")
    events = session.memory_events()
    spans = sum(e["type"] == "span" and e["name"] == "fed.round"
                for e in events)
    counters = sorted({e["name"] for e in events if e["type"] == "counter"
                       and e["name"].startswith("fed.")})
    want = {"fed.rounds", "fed.wire_bytes", "fed.analytic_bytes",
            "fed.stragglers"}
    if spans != len(recs) or not want <= set(counters):
        raise AssertionError(f"14b: {spans} fed.round spans, {counters}")
    if not {"fed.round.mesh", "fed.aggregate.mesh"} <= set(names):
        raise AssertionError(f"14b: registered {names}")
    return {"fed.round_spans": spans, "fed_counters": counters,
            "programs": sorted(set(names)), "events": len(events)}


def rank_main(argv) -> int:
    """One rank of phase 11 b-d, or with `--phase 16` of phase 16 (this
    script run with --rank)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--phase", default="11", choices=("11", "16"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.phase == "16":
        return tp_rank_main(args)
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib
    model_lib.disable_tf32()
    group, dev = mesh.init_workers(args.rank, args.world, args.init,
                                   device="cuda")
    out = {"rank": args.rank, "backend": dist.get_backend(group)}
    clock = time.perf_counter()
    try:
        cfg1 = dataclasses.replace(configs.get("yi-6b"), num_layers=1)
        out["b"] = rank_consensus(group, dev, cfg1, args.rank, args.world)
        torch.cuda.empty_cache()
        out["b_s"] = time.perf_counter() - clock
        out["c"] = rank_card_vs_cpu(group, dev,
                                    configs.get_reduced("yi-6b"))
        out["c_s"] = time.perf_counter() - clock - out["b_s"]
        out["d"] = rank_mesh_fed(group, dev, args.rank, COHORT_M,
                                 FED_ROUNDS, COHORT_ROUNDS)
        out["d_s"] = (time.perf_counter() - clock - out["b_s"]
                      - out["c_s"])
    finally:
        dist.destroy_process_group()
    Path(args.out, f"rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def ranks_phase() -> dict:
    """11 b-d: four ranks of this script sharing the card; their results,
    checked and summarised."""
    from repro_torch.launch import mesh
    out_dir = OUT_DIR / "dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.json"):
        old.unlink()
    torch.cuda.empty_cache()
    log(f"[dist] this process holds {torch.cuda.memory_reserved() / 1e9:.2f}"
        f" GB; the card has {torch.cuda.mem_get_info()[0] / 1e9:.2f} GB "
        "free")
    t = time.perf_counter()
    res = mesh.run_local_ranks(
        lambda r, init: [str(ROOT / "chip_smoke.py"), "--rank", str(r),
                         "--world", str(DIST_RANKS), "--init", init,
                         "--out", str(out_dir)],
        DIST_RANKS, RANK_TIMEOUT_S)
    wall = time.perf_counter() - t
    for r, (rc, so, se) in enumerate(res):
        (out_dir / f"rank{r}.log").write_text(so + "\n---- stderr\n" + se)
        if rc != 0:
            raise AssertionError(f"11: rank {r} exited {rc}:\n{se[-4000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    summary = {"wall_s": wall, "backend": [r["backend"] for r in ranks],
               "seconds": {k: [r[k] for r in ranks]
                           for k in ("b_s", "c_s", "d_s")}}
    b = {}
    for strategy in ranks[0]["b"]:
        if strategy == "words_from_each_rank":
            continue
        per = [r["b"][strategy] for r in ranks]
        b[strategy] = {
            "step_s": [[s["s"] for s in p["steps"]] for p in per],
            "collective_s (gloo over loopback, one card)":
                [[s["collective_s"] for s in p["steps"]] for p in per],
            "bytes_per_step_rank0": per[0]["steps"][0]["bytes"],
            "launches_per_step_rank0": per[0]["steps"][0]["launches"],
            "peak_mem_GB": [p["peak_mem_GB"] for p in per],
            "loss": [s["loss"] for s in per[0]["steps"]]}
    summary["b"] = b
    summary["c"] = ranks[0]["c"]
    summary["d"] = ranks[0]["d"]
    summary["d"]["cohort"]["rounds_per_s_all_ranks"] = [
        r["d"]["cohort"]["rounds_per_s"] for r in ranks]
    summary["d"]["obs_all_ranks"] = [r["d"]["obs"] for r in ranks]
    for k, v in summary.items():
        log(f"[dist {k}] " + json.dumps(v))
    return summary


# -- phase 16: serving across workers (the "model" axis) ---------------------
# Ranks of this script (--phase 16) share the card over gloo, as 11b's do;
# the one-worker runs they are held against run first in this process and
# are handed over in a temporary directory. a. yi-6b at full width and all
# 32 layers, 4 slots, model 2, with the f32 and the 8-bit cache; b. the
# same cut to 8 layers at model 4; c. the reduced mixtral (expert-
# parallel), arctic, hymba and xlstm at model 2 (8-bit cache), the reduced
# yi and mixtral at (data 2, model 2); d. the reduced yi-6b trained 2 steps
# (allgather_packed with EF) at (2, 2) and at (2, 1).
#
# A row-split product sums the ranks' partials in gloo's order and a
# column-split one runs another GEMM shape, so the ranks' activations
# differ from one worker's in their last bits. With the f32 cache and the
# reduced models that stays within TP_LOGIT_TOL / SMALL_LOGIT_TOL and the
# greedy tokens are one worker's. With the 8-bit cache at full width a K/V
# value on a bin edge lands in the neighbouring code (several a step), and
# the logits move by up to a few hundredths (one worker against itself
# with wo one ulp away moves as much: `sensitivity`). Those runs are fed
# one worker's tokens, their logits held within TP_CODE_LOGIT_TOL, and a
# greedy choice may differ only where one worker's top-2 margin is within
# TP_NEAR_TIE. They are then run on their own greedy tokens, which must
# equal one worker's up to each slot's first differing choice, and that
# choice must be such a near-tie; its step and margin are printed.
TP_SLOTS, TP_PROMPT, TP_NEW, TP_MAX_SEQ = 4, 16, 16, 64
TP_FAMILIES = ("mixtral-8x22b", "arctic-480b", "hymba-1.5b", "xlstm-350m")
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 8, 32
TP_LOGIT_TOL = 1e-3
# a tenth of the logits' spread at full width (std ~1.28: an RMS-normed h
# against head weights N(0, 0.02^2) over 4096); a wrong slice or a missing
# all-reduce moves them by O(1)
TP_CODE_LOGIT_TOL = 0.13
# a top-2 margin this small is a near-tie: one worker's own logits move by
# 0.0588 at yi-6b x32, 8-bit, when every wo value moves one ulp (this
# phase's `sensitivity` run on an NVIDIA H100 80GB HBM3 at 700 W)
TP_NEAR_TIE = 0.06


def tp_cfgs() -> dict:
    """{label: (cfg, data, model, world, forced)} of phase 16's serve runs;
    `forced`: fed one worker's tokens, then on its own (module comment
    above)."""
    from repro_torch import configs
    q8 = serve_cfg()
    f32 = dataclasses.replace(q8, kv_quant_bits=None)
    out = {"a yi-6b x32 f32": (f32, 1, 2, 2, False),
           "a yi-6b x32 8-bit": (q8, 1, 2, 2, True),
           "b yi-6b x8 f32": (dataclasses.replace(f32, num_layers=8),
                              1, 4, 4, False),
           "b yi-6b x8 8-bit": (dataclasses.replace(q8, num_layers=8),
                                1, 4, 4, True)}
    for arch in TP_FAMILIES:
        cfg = configs.get_reduced(arch)
        if cfg.block != "xlstm_pair":
            cfg = dataclasses.replace(cfg, kv_quant_bits=SERVE_BITS)
        out[f"c {arch}"] = (cfg, 1, 2, 2, False)
    for arch in ("yi-6b", "mixtral-8x22b"):
        out[f"c {arch} (2, 2)"] = (dataclasses.replace(
            configs.get_reduced(arch), kv_quant_bits=SERVE_BITS), 2, 2, 4,
            False)
    return out


def tp_launches(cfg) -> dict:
    """The serve kernels' launches per decode step on every rank: one
    worker's (every rank attends with all heads)."""
    if not cfg.kv_quant_bits or cfg.block == "xlstm_pair":
        return {k: 0 for k in per_token_launches(cfg)}
    return per_token_launches(cfg)


def tp_greedy(step, params, state, prompt, on_step=None, fed=None):
    """The prompt stepped through `step`, then TP_NEW tokens: its own
    greedy ones, or `fed` (b, TP_NEW) when given. Returns (logits (steps,
    b, V), its greedy choices (b, TP_NEW + 1)); on_step(i, fn) runs step
    i's call `fn()` (to time and count it)."""
    from repro_torch.models import decode as decode_lib
    logits, toks = [], []
    box = {"state": state}

    def run(tok):
        def fn():
            lg, box["state"] = step(params, box["state"], tok)
            return lg
        return fn() if on_step is None else on_step(len(logits), fn)

    for t in range(prompt.shape[1]):
        logits.append(run(prompt[:, t:t + 1]))
    for k in range(TP_NEW):
        toks.append(decode_lib.greedy_token(logits[-1]))
        logits.append(run(toks[-1] if fed is None else fed[:, k:k + 1]))
    toks.append(decode_lib.greedy_token(logits[-1]))
    return torch.stack(logits), torch.cat(toks, 1)


def tp_prompt(cfg):
    gen = torch.Generator()
    gen.manual_seed(16)
    return torch.randint(0, cfg.vocab_size, (TP_SLOTS, TP_PROMPT),
                         generator=gen, dtype=torch.int32)


def tp_one_worker(dev, cfg, path, sensitivity: bool = False) -> dict:
    """The one-worker serve step (`make_serve_step(cfg)`, a CUDA graph)
    fed the prompt and its greedy tokens from the seeded whole init;
    its logits and tokens saved to `path` for the ranks. With
    `sensitivity`, the same run fed the same tokens with every wo value
    one ulp further from zero: its largest logit gap."""
    from repro_torch.dist import step as step_lib
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(0, cfg, dev)
    step = step_lib.make_serve_step(cfg)
    times = []

    def timed_step(i, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return lg

    def state():
        return decode_lib.init_decode_state(cfg, TP_SLOTS, TP_MAX_SEQ,
                                            device=dev)

    prompt = tp_prompt(cfg)
    logits, tokens = tp_greedy(step, params, state(), prompt.to(dev),
                               timed_step)
    torch.save({"logits": logits.cpu(), "tokens": tokens.cpu(),
                "prompt": prompt}, path)
    out = {"step_s_median": statistics.median(times[1:]),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params))}
    if sensitivity:
        wo = params["blocks"]["wo"]
        wo.copy_(torch.nextafter(wo, wo * 2))
        moved, _ = tp_greedy(step, params, state(), prompt.to(dev),
                             fed=tokens[:, :TP_NEW])
        out["wo_one_ulp_logit_gap"] = float((moved - logits).abs().max())
    del params, logits
    torch.cuda.empty_cache()
    return out


def tree_leaves(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.leaves(tree)


def tp_own_greedy(differ, margin, gaps) -> dict:
    """A run on its own greedy tokens against one worker's: per slot, the
    first differing choice (None: all equal), one worker's top-2 margin
    there, and the largest logit gap up to the step that made it (after
    it the slot is fed other tokens); `ok` if every first difference is a
    near-tie and those gaps are within TP_CODE_LOGIT_TOL."""
    slots, ok = [], True
    for s in range(differ.shape[0]):
        hit = differ[s].nonzero()
        j = int(hit[0]) if len(hit) else None
        upto = TP_PROMPT + (differ.shape[1] if j is None else j)
        gap = float(gaps[:upto, s].max())
        m = None if j is None else float(margin[s, j])
        ok = ok and gap <= TP_CODE_LOGIT_TOL and (m is None or
                                                  m <= TP_NEAR_TIE)
        slots.append([j, m, gap])
    return {"ok": ok, "per slot [first differing choice, one worker's "
                   "margin there, max |logit gap| up to it]": slots}


def tp_serve_rank(dev, label, cfg, data, model, forced, tmp) -> dict:
    """One rank of a phase 16 serve run: its slices drawn leaf by leaf,
    their bytes against the spec's, the prompt and TP_NEW tokens (its own
    greedy ones; when `forced`, one worker's first and then its own)
    through the tensor-parallel serve step with per-step seconds, seconds
    in the collectives and launches; tokens and logits against the
    one-worker run's."""
    from repro_torch.dist import sharding
    from repro_torch.dist import step as step_lib
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import decode as decode_lib
    tmesh = mesh.make_host_group(data, model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = step_lib.init_serve_state(cfg, tmesh, TP_SLOTS,
                                              TP_MAX_SEQ, seed=0, device=dev)
    held = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    spec = sum(s.nbytes(tmesh) for s in tree_leaves(step_lib.serve_state_specs(
        cfg, tmesh, TP_SLOTS, TP_MAX_SEQ)[0]))
    if held != spec:
        raise AssertionError(f"16 {label}: a rank holds {held} B of params, "
                             f"the spec {spec}")
    base = torch.load(Path(tmp) / f"{label}.pt")
    rows = TP_SLOTS // data
    lo = tmesh.data_index * rows
    want_tokens = base["tokens"][lo:lo + rows]
    want_logits = base["logits"][:, lo:lo + rows]
    steps = []
    want = tp_launches(cfg)

    def counted(i, fn):
        ops.reset_launch_counts()
        sharding.reset_transport_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        counts = {k: v for k, v in ops.launch_counts().items() if k in want}
        if counts != want:
            raise AssertionError(f"16 {label}: step {i} launched {counts}, "
                                 f"want {want}")
        tc = sharding.transport_counts()
        steps.append({"s": s, "collective_s": sum(
            v["seconds"] for v in tc.values()), "calls": sum(
            v["calls"] for v in tc.values())})
        return lg

    step = step_lib.make_serve_step(cfg, tmesh)
    prompt = base["prompt"][lo:lo + rows].to(dev)
    logits, tokens = tp_greedy(
        step, params, state, prompt, counted,
        fed=want_tokens[:, :TP_NEW].to(dev) if forced else None)
    tokens = tokens.cpu()
    gaps = (logits.cpu() - want_logits).abs().amax(dim=(1, 2))
    # one worker's top-2 margin at each greedy choice, per slot
    top2 = want_logits[TP_PROMPT - 1:].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).T            # (rows, TP_NEW + 1)
    differ = tokens != want_tokens
    out = {"param_bytes": held, "forced": forced,
           "max_abs_logit_gap": float(gaps.max()),
           "logit_gap_per_step": [float(g) for g in gaps],
           "greedy_choices_differing": int(differ.sum()),
           "step_s": [s["s"] for s in steps],
           "collective_s": [s["collective_s"] for s in steps],
           "collectives_per_step": steps[0]["calls"],
           "launches_per_step": want}
    if forced:
        near_tie = margin <= TP_NEAR_TIE
        out["differing_margins"] = [float(m) for m in margin[differ]]
        fine = not bool((differ & ~near_tie).any()) and (
            out["max_abs_logit_gap"] <= TP_CODE_LOGIT_TOL)
        own_logits, own_tokens = tp_greedy(
            step, params, decode_lib.init_decode_state(
                cfg, rows, TP_MAX_SEQ, device=dev), prompt, counted)
        own_gaps = (own_logits.cpu() - want_logits).abs().amax(dim=-1)
        out["own_greedy"] = tp_own_greedy(own_tokens.cpu() != want_tokens,
                                          margin, own_gaps)
        fine = fine and out["own_greedy"]["ok"]
    else:
        fine = not bool(differ.any()) and (
            out["max_abs_logit_gap"] <= (TP_LOGIT_TOL if cfg.kv_quant_bits
                                         is None else SMALL_LOGIT_TOL))
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    if not fine:
        raise AssertionError(f"16 {label}: " + json.dumps(out))
    return out


def tp_train_rank(dev, data, model, rank, tmp) -> dict:
    """16d on one rank: the reduced yi-6b, allgather_packed with EF,
    AdamW and clip 1.0, 2 steps at (data, model); the whole params and
    optimizer state saved for the parent's comparison."""
    from repro_torch import configs
    from repro_torch.data.pipeline import batch_for_shape
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as step_lib
    from repro_torch.launch import mesh
    from repro_torch.optimizer import optim
    tmesh = mesh.make_host_group(data, model)
    cfg = configs.get_reduced("yi-6b")
    opt = optim.adamw(optim.warmup_cosine(3e-4, 1, 10), weight_decay=0.1)
    gc = G.GradCompConfig()
    st = step_lib.init_train_state(cfg, opt, gc, tmesh, seed=0, device=dev)
    fn = step_lib.make_train_step(cfg, opt, gc, tmesh, clip_norm=1.0)
    losses = []
    for s in range(2):
        *st, met = fn(*st, batch_for_shape(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ,
                                           s, 0, device=dev))
        losses.append(float(met["loss"]))
    whole = step_lib.whole_train_state(cfg, tmesh, st[0], st[1])
    torch.save([x.detach().cpu() for x in tree_leaves(whole)],
               Path(tmp) / f"train_{data}x{model}_r{rank}.pt")
    return {"losses": losses}


def tp_rank_main(args) -> int:
    """One rank of phase 16 (a world of 2: 16a, 16c at model 2, 16d at
    (2, 1); of 4: 16b, 16c's (2, 2), 16d at (2, 2))."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib
    model_lib.disable_tf32()
    group, dev = mesh.init_workers(args.rank, args.world, args.init,
                                   device="cuda")
    tmp = Path(args.out).parent / "tp_in"
    out = {"rank": args.rank, "backend": dist.get_backend(group),
           "serve": {}}
    try:
        for label, (cfg, data, model, world, forced) in tp_cfgs().items():
            if world != args.world:
                continue
            # a failed check is reported to the parent, which raises once
            # every run has reported
            try:
                out["serve"][label] = tp_serve_rank(dev, label, cfg, data,
                                                    model, forced, tmp)
            except AssertionError as e:
                out["serve"][label] = {"error": str(e)}
            torch.cuda.empty_cache()
        data, model = (2, 1) if args.world == 2 else (2, 2)
        out["train"] = tp_train_rank(dev, data, model, args.rank, tmp)
    finally:
        dist.destroy_process_group()
    Path(args.out, f"rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def tp_phase(dev) -> dict:
    """Phase 16: the one-worker runs here, then a world of 2 and a world
    of 4 ranks of this script; their results checked and summarised."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh
    work = Path(tempfile.mkdtemp(prefix="tp_"))
    tmp = work / "tp_in"
    tmp.mkdir()
    out_dir = OUT_DIR / "tp"
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = {"one_worker": {}, "serve": {}}
    try:
        for label, (cfg, _, _, _, _) in tp_cfgs().items():
            summary["one_worker"][label] = tp_one_worker(
                dev, cfg, tmp / f"{label}.pt",
                sensitivity=label.startswith("a "))
        torch.cuda.empty_cache()
        ranks = {}
        for world in (2, 4):
            rank_dir = work / f"w{world}"
            rank_dir.mkdir()
            t = time.perf_counter()
            res = mesh.run_local_ranks(
                lambda r, init: [str(ROOT / "chip_smoke.py"), "--rank",
                                 str(r), "--world", str(world), "--init",
                                 init, "--out", str(rank_dir), "--phase",
                                 "16"], world, RANK_TIMEOUT_S)
            summary[f"world{world}_wall_s"] = time.perf_counter() - t
            for r, (rc, so, se) in enumerate(res):
                (out_dir / f"w{world}_rank{r}.log").write_text(
                    so + "\n---- stderr\n" + se)
                if rc != 0:
                    raise AssertionError(f"16: world {world} rank {r} exited "
                                         f"{rc}:\n{se[-4000:]}")
            ranks[world] = [json.loads((rank_dir / f"rank{r}.json")
                                       .read_text()) for r in range(world)]
        errors = [f"rank {r}: {ranks[w][r]['serve'][label]['error']}"
                  for label, (_, _, _, w, _) in tp_cfgs().items()
                  for r in range(w) if "error" in ranks[w][r]["serve"][label]]
        if errors:
            raise AssertionError("16: " + "; ".join(errors))
        for label, (cfg, data, model, world, _) in tp_cfgs().items():
            per = [r["serve"][label] for r in ranks[world]]
            summary["serve"][label] = {
                "data, model": [data, model],
                "fed one worker's tokens": per[0]["forced"],
                "greedy_choices_differing": [p["greedy_choices_differing"]
                                             for p in per],
                # a data index's ranks hold the same slots and tokens
                "differing_margins (one worker)": [
                    p.get("differing_margins") for p in per[::model]],
                "own_greedy": [p.get("own_greedy") for p in per[::model]],
                "wo_one_ulp_logit_gap (one worker)": summary["one_worker"][
                    label].get("wo_one_ulp_logit_gap"),
                "param_bytes_per_rank": [p["param_bytes"] for p in per],
                "one_worker_param_bytes":
                    summary["one_worker"][label]["param_bytes"],
                "max_abs_logit_gap": max(p["max_abs_logit_gap"]
                                         for p in per),
                "step_s_median": [statistics.median(p["step_s"][1:])
                                  for p in per],
                "collective_s_median": [statistics.median(
                    p["collective_s"][1:]) for p in per],
                "collectives_per_step": per[0]["collectives_per_step"],
                "launches_per_step": per[0]["launches_per_step"],
                "peak_mem_GB": [p["peak_mem_GB"] for p in per],
                "one_worker_step_s_median":
                    summary["one_worker"][label]["step_s_median"]}
        # 16d: every (2, 2) rank bitwise the (2, 1) run's rank 0
        want = torch.load(tmp / "train_2x1_r0.pt")
        for world, tag in ((2, "2x1"), (4, "2x2")):
            for r in range(world):
                got = torch.load(tmp / f"train_{tag}_r{r}.pt")
                if not _leaves_equal(got, want):
                    raise AssertionError(f"16d: ({tag}) rank {r} != (2, 1) "
                                         "rank 0")
        summary["train"] = {
            "losses (2, 1)": ranks[2][0]["train"]["losses"],
            "losses (2, 2)": ranks[4][0]["train"]["losses"],
            "bitwise": "every (2, 2) and (2, 1) rank's params and AdamW "
                       "state equal"}
        summary["backend"] = [r["backend"] for w in (2, 4)
                              for r in ranks[w]]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k, v in summary["serve"].items():
        log(f"[16 {k}] " + json.dumps(v))
    log("[16d] " + json.dumps(summary["train"]))
    return summary


# -- phase 14: checkpointing and observability (checkpoint/*, obs/*) --------
# a. fed_heterogeneous at its own size, adaptive, saved after CKPT_SPLIT of
# FED_ROUNDS rounds and resumed; b. fed_cohort_scaling's m 512 saved after
# COHORT_CKPT_ROUNDS and resumed for as many (its mesh run under obs is in
# the ranks of phase 11d, `rank_mesh_fed`); c. phase 7's serve run under
# obs, with OBS_PAIRS decode steps paired off and on; d. phase 4's train
# step under obs; e. launch.train --ckpt-dir at 1 layer; f. the m 512 round
# loop paired off and on for FED_OBS_PAIRS rounds each
CKPT_SPLIT = 25
COHORT_CKPT_ROUNDS = 2
OBS_PAIRS = 16
FED_OBS_PAIRS = 20
HISTORY_KEYS = ("round", "participants", "stragglers", "wire_bytes",
                "analytic_bytes", "realloc", "rates")
EF_KERNELS = ("encode_ef", "unpack_dequant", "fwht")


def _counted(fn, kinds=EF_KERNELS):
    """(fn(), launches of `kinds` during it)."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in kinds}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _save_restore(save, restore, dev) -> dict:
    """save(dir) then restore(dir) under a fresh temporary directory
    outside the repository, removed afterwards: seconds and bytes."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        _sync(dev)
        t = time.perf_counter()
        save(tmp)
        _sync(dev)
        save_s = time.perf_counter() - t
        nbytes = _dir_bytes(tmp)
        t = time.perf_counter()
        restore(tmp)
        _sync(dev)
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "save_GB_per_s": nbytes / save_s / 1e9,
            "restore_GB_per_s": nbytes / restore_s / 1e9,
            "tmp_free_GB_before": free_gb}


def ckpt_fed_phase(dev, rounds: int = FED_ROUNDS,
                   split: int = CKPT_SPLIT) -> dict:
    """14a: fed_heterogeneous (phase 10b's problem and budgets, adaptive
    norm-proportional re-allocation every 10 rounds around R̄ = 1), fedavg
    and fedmem at 50% participation with 20% stragglers: `split` rounds,
    save_federation, a fresh Federation restored, `rounds - split` more;
    ledger, participants, params and client states bitwise the
    uninterrupted run's, and the resumed rounds' encode_ef,
    unpack_dequant and fwht launches equal to its last rounds'."""
    from repro_torch import checkpoint, codecs, fed
    from repro_torch.fed import budget
    shards, lr, norms = fed_problem(FED_M, FED_DIM, FED_PER, 1.0)
    rates = budget.allocate("norm_proportional", 1.0 * FED_M, FED_M,
                            norms=norms, min_rate=0.25)

    def factory(r):
        return codecs.make("ndsc", float(r), chunk=FED_CHUNK)

    adaptive = fed.AdaptiveConfig(total_rate=1.0 * FED_M,
                                  policy="norm_proportional",
                                  realloc_every=10, min_rate=0.25)
    out = {}
    for label, server_kw, fed_kw in (
            ("fedavg", {}, {}),
            ("fedmem partial", {"aggregator": "fedmem", "server_lr": 0.25},
             {"participation": 0.5, "dropout": 0.2})):
        def make():
            return fed.Federation(
                ls_loss, {"x": torch.zeros(FED_DIM)}, shards,
                [factory(r) for r in rates], fed.ClientConfig(lr=lr),
                fed.ServerConfig(**server_kw), seed=0, adaptive=adaptive,
                codec_factory=factory, device=dev)

        def run(f, n):
            return _counted(lambda: f.run(fed.FedConfig(
                num_rounds=n, seed=0, **fed_kw)))

        full = make()
        h1, _ = run(full, split)
        h2, want = run(full, rounds - split)
        half = make()
        g1, _ = run(half, split)
        resumed = make()
        steps = []
        io = _save_restore(
            lambda d: checkpoint.save_federation(d, half),
            lambda d: steps.append(checkpoint.restore_federation(d, resumed)),
            dev)
        if steps != [split] or resumed.rounds_done != split:
            raise AssertionError(f"14a {label}: restored {steps}")
        g2, got = run(resumed, rounds - split)
        for k in HISTORY_KEYS:
            if h1[k] + h2[k] != g1[k] + g2[k]:
                raise AssertionError(f"14a {label}: {k} differs")
        if not (_same_tree(full.server, resumed.server)
                and all(_same_tree(a, b)
                        for a, b in zip(full.states, resumed.states))):
            raise AssertionError(f"14a {label}: state differs")
        if got != want or not got["encode_ef"] or not got["unpack_dequant"]:
            raise AssertionError(f"14a {label}: launches {got} != {want}")
        out[label] = {"launches_resumed_rounds": got, **io,
                      "reallocs_after_save": sum(map(bool, g2["realloc"]))}
        log(f"[14a] {label}: resumed == uninterrupted, bitwise; "
            + json.dumps(out[label]))
    return out


def ckpt_cohort_phase(dev, m: int = COHORT_M,
                      k: int = COHORT_CKPT_ROUNDS) -> dict:
    """14b: fed_cohort_scaling's m (ndsc R 2, vmap): k rounds, save,
    restore into a fresh Federation, k more; bitwise the uninterrupted 2k
    rounds, one encode_ef and one unpack_dequant launch per resumed round
    (one leaf)."""
    from repro_torch import checkpoint, codecs, fed
    shards, lr, _ = fed_problem(m, FED_DIM, COHORT_PER, 0.0)
    codec = codecs.make("ndsc", 2.0, chunk=FED_CHUNK)
    cfg1 = fed.FedConfig(num_rounds=1, seed=0)

    def make():
        return fed.Federation(ls_loss, {"x": torch.zeros(FED_DIM)}, shards,
                              codec, fed.ClientConfig(lr=lr), seed=0,
                              device=dev)

    full = make()
    hf = [full.run(cfg1) for _ in range(2 * k)]
    half = make()
    hh = [half.run(cfg1) for _ in range(k)]
    resumed = make()
    io = _save_restore(lambda d: checkpoint.save_federation(d, half),
                       lambda d: checkpoint.restore_federation(d, resumed),
                       dev)
    counts = []
    for _ in range(k):
        h, c = _counted(lambda: resumed.run(cfg1))
        hh.append(h)
        counts.append(c)
        if c["encode_ef"] != 1 or c["unpack_dequant"] != 1:
            raise AssertionError(f"14b: a resumed round launched {c}")
    if not (hf == hh and _same_tree(full.server, resumed.server)
            and all(_same_tree(a, b)
                    for a, b in zip(full.states, resumed.states))):
        raise AssertionError("14b: resumed != uninterrupted")
    out = {"m": m, "rounds": 2 * k, "launches_per_resumed_round": counts,
           **io}
    log("[14b] m %d: resumed == uninterrupted, bitwise; %s"
        % (m, json.dumps(out)))
    return out


def serve_obs_phase(dev, keep: dict, serve_times: dict) -> dict:
    """14c: phase 7's traffic through a fresh Engine (its programs made
    anew) under obs.enable(memory, jsonl, trace): tokens and cache leaves
    bitwise phase 7's (`keep`); every step's kernels.dispatch counts equal
    to what its Python ran: its launches, less those its graphs replayed,
    plus those its captures recorded (a decode step launches 32 / 64 / 96;
    a replayed one dispatches none); the session's serve.* recompiles
    equal to the programs' specializations; the trace valid; serve.ttft_s
    for both admission kinds; the kernels' costs equal to phase 3d's bound
    bytes (`serve_times`) at the same shapes. Then OBS_PAIRS decode steps
    of 4 busy slots, alternately under obs.suspended() and obs.use()."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve import engine as engine_lib
    cfg = serve_cfg()
    per_token = per_token_launches(cfg)
    params = model_lib.init_params(0, cfg, dev)
    engine_lib._programs.cache_clear()
    eng = Engine(cfg, params, ServeConfig(slots=SERVE_SLOTS,
                                          max_seq=SERVE_MAX_SEQ), device=dev)
    programs = engine_lib._programs(cfg, SERVE_MAX_SEQ)
    prefix, prompts, tokens = make_traffic(cfg, PHASE7_TRAFFIC)
    obs_dir = OUT_DIR / "obs"
    obs_dir.mkdir(parents=True, exist_ok=True)
    trace_path = obs_dir / "serve_trace.json"
    session = obs.enable(memory=True, jsonl=str(obs_dir / "serve.jsonl"),
                         trace=str(trace_path))
    events = session.memory_events()

    def graph_launches():
        total = collections.Counter()
        for p in programs:
            total.update({("replayed", k): n for k, n in p.replayed.items()})
            total.update({("captured", k): n for k, n in p.captured.items()})
        return total

    def dispatched(fn):
        """fn()'s launches; its dispatch events must count the launches
        its Python ran: eager, or recorded by a capture."""
        n0, before = len(events), ops.launch_counts()
        g0 = graph_launches()
        fn()
        after, g1 = ops.launch_counts(), graph_launches()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        want = {k: launches.get(k, 0) - g1[("replayed", k)]
                + g0[("replayed", k)] + g1[("captured", k)]
                - g0[("captured", k)] for k in after}
        want = {k: n for k, n in want.items() if n}
        got = {}
        for e in events[n0:]:
            if e["name"] == "kernels.dispatch":
                if e["attrs"]["path"] != "cuda":
                    raise AssertionError(f"14c: dispatch {e['attrs']}")
                got[e["attrs"]["op"]] = got.get(e["attrs"]["op"], 0) + 1
        if got != want:
            raise AssertionError(f"14c: dispatch {got} != launches "
                                 f"{launches} - replayed + captured")
        return launches

    try:
        dispatched(lambda: eng.register_prefix("sys", prefix, prefill=True))
        reqs = [Request(rid=rid, prompt=p, max_new_tokens=SERVE_NEW,
                        prefix_id=pid)
                for rid, (p, pid) in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        decode_steps = 0
        while not eng.idle():
            waiting = [r for r in reqs if r.admission is None]
            launches = dispatched(eng.step)
            if not any(r.admission is not None for r in waiting):
                if launches != per_token:
                    raise AssertionError(f"14c: decode step launches "
                                         f"{launches}")
                decode_steps += 1
        finished = eng.finished
        if {r.rid: r.tokens_out for r in finished} != keep["tokens"]:
            raise AssertionError("14c: tokens differ from phase 7's")
        for k, v in cache_snapshot(eng.state).items():
            if not bitwise(v, keep["caches"][k]):
                raise AssertionError(f"14c: cache {k} differs from phase 7's")
        made = {n: p._cache_size() for n, p in zip(PROGRAM_NAMES, programs)
                if p._cache_size()}
        recompiles = {n: c for n, c in session.recompiles().items()
                      if n.startswith("serve.")}
        if recompiles != made:
            raise AssertionError(f"14c: recompiles {recompiles} != the "
                                 f"programs' specializations {made}")
        ttft_kinds = {e["attrs"]["admission"] for e in events
                      if e["name"] == "serve.ttft_s"}
        if ttft_kinds != {"cold", "prefix_hit"}:
            raise AssertionError(f"14c: serve.ttft_s for {ttft_kinds}")
        ttft = {k: statistics.median(r.ttft_s for r in finished
                                     if r.admission == k)
                for k in sorted(ttft_kinds)}
        # OBS_PAIRS rounds of decode steps of 4 busy slots in turns: obs
        # off, this session (memory, JSONL and trace sinks, cost capture),
        # and three that split it: the memory sink alone ("lean"), with
        # the cost capture, with the two file sinks; with the collector's
        # pauses that land in each arm
        for rid in range(SERVE_SLOTS):
            eng.submit(Request(rid=200 + rid, prompt=tokens(COLD_LEN),
                               max_new_tokens=5 * OBS_PAIRS + 4))
        eng.step()                           # admissions + one decode
        split_dir = obs_dir / "split"
        parts = {
            "lean": obs.Obs(sinks=(obs.MemorySink(),), costs=False),
            "capture": obs.Obs(sinks=(obs.MemorySink(),), costs=True),
            "files": obs.Obs(sinks=(
                obs.MemorySink(), obs.JsonlSink(str(split_dir / "e.jsonl")),
                obs.ChromeTraceSink(str(split_dir / "t.json"))),
                costs=False)}
        arms = [("off", obs.suspended), ("on", lambda: obs.use(session))]
        arms += [(k, lambda o=o: obs.use(o)) for k, o in parts.items()]
        times = {arm: [] for arm, _ in arms}
        gc_ms = {arm: 0.0 for arm, _ in arms}
        current, gc_t0 = [None], [0.0]

        def on_gc(phase, info):
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            elif current[0] is not None:
                gc_ms[current[0]] += (time.perf_counter() - gc_t0[0]) * 1e3

        gc.callbacks.append(on_gc)
        try:
            for i in range(len(arms) * OBS_PAIRS):
                arm, ctx = arms[i % len(arms)]
                with ctx():
                    torch.cuda.synchronize()
                    current[0] = arm
                    t = time.perf_counter()
                    eng.step()
                    torch.cuda.synchronize()
                    times[arm].append(time.perf_counter() - t)
                    current[0] = None
        finally:
            gc.callbacks.remove(on_gc)
        for o in parts.values():
            o.close()
        eng.run_to_completion()
    finally:
        obs.disable()
    # host µs of one dispatch's obs record (the counter, then the cost
    # capture of a decode step's K/V FWHT) in a session with this one's
    # sinks, outside any step
    probe_dir = OUT_DIR / "obs" / "probe"
    probe = obs.Obs(sinks=(obs.MemorySink(),
                           obs.JsonlSink(str(probe_dir / "e.jsonl")),
                           obs.ChromeTraceSink(str(probe_dir / "t.json"))))
    x = torch.zeros(SERVE_SLOTS, 1, cfg.num_kv_heads, cfg.dh, device=dev)
    with obs.use(probe):
        record_us = {
            "counter": host_us(lambda: obs.counter(
                "probe.dispatch", 1, op="fwht", path="cuda", n=128,
                forced=False)),
            "capture": host_us(lambda: obs.observe_program_call(
                "kernels.fwht.cuda", None, (x,)))}
    probe.close()
    n_trace = obs.validate_trace(str(trace_path))
    programs = session.costs()["programs"]
    checked = []
    kh, dh = cfg.num_kv_heads, cfg.dh
    kv, q = (SERVE_SLOTS, 1, kh, dh), (SERVE_SLOTS, kh, cfg.num_heads // kh,
                                       dh)
    for key, shape in (("fwht/decode_kv", kv), ("fwht/decode_q", q),
                       ("quantize_pack/decode", kv),
                       ("quant_decode_attention/serve", q)):
        name = f"kernels.{key.split('/')[0]}.cuda"
        sig = f"float32[{','.join(map(str, shape))}]"
        specs = [s for s in programs[name]["specializations"]
                 if s["sig"].startswith("(" + sig)]
        if not specs or any(s["bytes_accessed"] != serve_times[key]["bytes"]
                            for s in specs):
            raise AssertionError(f"14c: {name} {sig} bytes "
                                 f"{[s['bytes_accessed'] for s in specs]} "
                                 f"!= {serve_times[key]['bytes']}")
        checked.append(key)
    med = {arm: statistics.median(v) * 1e3 for arm, v in times.items()}
    gc_ms = {arm: v / OBS_PAIRS for arm, v in gc_ms.items()}
    out = {"decode_steps_checked": decode_steps,
           "events": len(events), "trace_events": n_trace,
           "kernel_programs": sorted(n for n in programs
                                     if n.startswith("kernels.")),
           "cost_bytes_equal_phase3": checked,
           "ttft_s_median_obs_on": ttft,
           "ttft_s_median_phase7": keep["ttft_s_median"],
           "recompiles": recompiles,
           "decode_step_ms_median": med,
           "decode_step_ms_on_minus_off": med["on"] - med["off"],
           "gc_pause_ms_per_step": gc_ms, "record_host_us": record_us,
           "rounds_of_arms": OBS_PAIRS}
    log("[14c] serve x32 under obs: tokens and cache leaves == phase 7, "
        "dispatch == launches - replayed + captured; " + json.dumps(out))
    del eng, params
    torch.cuda.empty_cache()
    return out


def train_obs_phase(dev, cfg, gc, steps: int = 2) -> dict:
    """14d: `steps` train steps of `cfg` (phase 4's size and launcher
    optimizer) with obs on, bitwise the same steps with obs off from the
    same state; dist.payload_bytes per step equal to wire_bytes_tree's
    payload; kernels.dispatch 12 per kernel per step, equal to the
    launches."""
    from repro_torch import obs
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import batch_for_shape
    from repro_torch.dist import step as step_lib
    from repro_torch.dist.gradcomp import wire_bytes_tree
    from repro_torch.optimizer.optim import adamw, warmup_cosine

    def run(observe: bool):
        opt = adamw(warmup_cosine(3e-4, 1, 3), weight_decay=0.1)
        fn = step_lib.make_train_step(cfg, opt, gc, clip_norm=1.0)
        p, o, ef = step_lib.init_train_state(cfg, opt, gc, seed=0,
                                             device=dev)
        session = obs.enable() if observe else None
        losses, per_step = [], []
        try:
            for s in range(steps):
                batch = batch_for_shape(cfg, 8, 128, s, 0, device=dev)
                n0 = len(session.memory_events()) if session else 0
                (p, o, ef, m), launches = _counted(
                    lambda: fn(p, o, ef, batch))
                torch.cuda.synchronize()
                losses.append(float(m["loss"]))
                if session:
                    new = session.memory_events()[n0:]
                    got = {}
                    for e in new:
                        if e["name"] == "kernels.dispatch":
                            got[e["attrs"]["op"]] = got.get(
                                e["attrs"]["op"], 0) + 1
                    payload = [e["value"] for e in new
                               if e["name"] == "dist.payload_bytes"]
                    per_step.append({"dispatch": got, "launches": launches,
                                     "payload_bytes": payload})
        finally:
            if session:
                obs.disable()
        audit = wire_bytes_tree(p, gc, 1)["payload_bytes"]
        return losses, p, per_step, audit

    off_losses, p_off, _, _ = run(False)
    p_off = [x.clone() for x in tree_lib.leaves(p_off)]
    torch.cuda.empty_cache()
    on_losses, p_on, per_step, audit = run(True)
    if on_losses != off_losses or not all(
            torch.equal(a, b) for a, b in zip(tree_lib.leaves(p_on), p_off)):
        raise AssertionError("14d: obs changed the train steps")
    for s, r in enumerate(per_step):
        if r["payload_bytes"] != [float(audit)]:
            raise AssertionError(f"14d: step {s} payload {r}, audit {audit}")
        if r["dispatch"] != {k: 12 for k in EF_KERNELS} or \
                r["dispatch"] != r["launches"]:
            raise AssertionError(f"14d: step {s}: {r}")
    out = {"losses": on_losses, "payload_bytes_per_step": audit,
           "dispatch_per_step": per_step[0]["dispatch"]}
    log("[14d] train x%d under obs == obs off, bitwise; %s"
        % (cfg.num_layers, json.dumps(out)))
    del p_on, p_off
    torch.cuda.empty_cache()
    return out


def ckpt_train_phase(dev, cfg, gc) -> dict:
    """14e: launch.train.train(ckpt_dir=...) of `cfg` for one step; the
    checkpoint restored into a fresh template, params bitwise; save and
    restore seconds and GB/s. The directory is a temporary one outside
    the repository, removed afterwards."""
    import shutil
    import tempfile
    from repro_torch import checkpoint
    from repro_torch import tree as tree_lib
    from repro_torch.dist import step as step_lib
    from repro_torch.launch.train import train
    from repro_torch.optimizer.optim import adamw, warmup_cosine
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        stamps = []
        params, losses, secs = train(
            cfg, steps=1, batch_size=8, seq_len=128, gc=gc, device=dev,
            on_step=lambda s, m: stamps.append(time.perf_counter()),
            ckpt_dir=tmp)
        save_s = time.perf_counter() - stamps[-1]
        nbytes = _dir_bytes(tmp)
        opt = adamw(warmup_cosine(3e-4, 1, 1), weight_decay=0.1)
        like_p, like_o, _ = step_lib.init_train_state(cfg, opt, gc, seed=1,
                                                      device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        back, step = checkpoint.restore_checkpoint(
            tmp, {"params": like_p, "opt_state": like_o})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if step != 1 or int(back["opt_state"]["step"]) != 1 or not all(
            torch.equal(a, b) for a, b in zip(tree_lib.leaves(params),
                                              tree_lib.leaves(back["params"]))):
        raise AssertionError("14e: restored params differ")
    n_values = sum(x.numel() for x in tree_lib.leaves(params))
    out = {"values": n_values, "bytes": nbytes, "loss": losses[0],
           "step_s": secs[0], "save_s": save_s, "restore_s": restore_s,
           "save_GB_per_s": nbytes / save_s / 1e9,
           "restore_GB_per_s": nbytes / restore_s / 1e9,
           "tmp_free_GB_before": free_gb}
    log("[14e] train x1 --ckpt-dir: restored bitwise; " + json.dumps(out))
    del params, back, like_p, like_o
    torch.cuda.empty_cache()
    return out


def fed_obs_overhead_phase(dev, m: int = COHORT_M,
                           pairs: int = FED_OBS_PAIRS) -> dict:
    """14f: fed_cohort_scaling's m round loop, rounds alternately under
    obs.suspended() and obs.use(session) (benchmarks/obs_overhead.py's
    pairing): per-arm 10%-trimmed mean seconds per round and their ratio
    (recorded, not gated)."""
    from repro_torch import codecs, fed, obs
    shards, lr, _ = fed_problem(m, FED_DIM, COHORT_PER, 0.0)
    f = fed.Federation(ls_loss, {"x": torch.zeros(FED_DIM)}, shards,
                       codecs.make("ndsc", 2.0, chunk=FED_CHUNK),
                       fed.ClientConfig(lr=lr), seed=0, device=dev)
    cfg = fed.FedConfig(num_rounds=2 * pairs + 2, seed=0)
    session = obs.Obs(sinks=(obs.MemorySink(),))
    with obs.suspended():
        f.run_round(cfg, 0)
    with obs.use(session):
        f.run_round(cfg, 1)
    times = {"off": [], "on": []}
    for t in range(2, 2 * pairs + 2):
        arm = "off" if t % 2 == 0 else "on"
        with (obs.suspended() if arm == "off" else obs.use(session)):
            _sync(dev)
            t0 = time.perf_counter()
            f.run_round(cfg, t)
            _sync(dev)
            times[arm].append(time.perf_counter() - t0)
    session.close()
    keep = max(1, int(round(pairs * 0.9)))
    mean = {arm: sum(sorted(v)[:keep]) / keep for arm, v in times.items()}
    out = {"m": m, "pairs": pairs,
           "round_ms_trimmed_mean": {k: v * 1e3 for k, v in mean.items()},
           "ratio_on_off": mean["on"] / mean["off"],
           "events": len(session.memory_events())}
    log("[14f] obs overhead on the m %d round loop: %s" % (m, json.dumps(out)))
    return out


# -- phase 15: the captured serve programs (repro_torch.graph) -------------
GRAPH_ROUNDS = 8          # 15c: rounds of a graph and an eager decode step


def graph_vs_eager_phase(dev, cfg, traffic: dict, keep: dict,
                         label: str) -> dict:
    """15a: `traffic` again through drive_traffic inside graph.eager(),
    from the same seeded weights: tokens and every cache leaf bitwise the
    captured run's (`keep`, phase 7, 13a or 13c); launches checked per
    step in both runs. Returns both runs' decode step medians and TTFT by
    admission kind."""
    from repro_torch import graph
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(0, cfg, dev)
    with graph.eager():
        run = drive_traffic(dev, cfg, params, traffic, f"{label} eager")
    if run["out"] != keep["tokens"]:
        raise AssertionError(f"{label}: eager tokens differ from the "
                             "captured run's")
    snap = cache_snapshot(run["eng"].state)
    differ = [k for k, v in snap.items() if not bitwise(v, keep["caches"][k])]
    if differ or snap.keys() != keep["caches"].keys():
        raise AssertionError(f"{label}: cache leaves {differ} differ, graph "
                             "against eager")
    out = {"tokens_bitwise": True, "cache_leaves_bitwise": sorted(snap),
           "decode_step_ms_median": {
               "graph": keep["decode_step_s_median"] * 1e3,
               "eager": statistics.median(run["decode_s"]) * 1e3},
           "ttft_s_median": {"graph": keep["ttft_s_median"],
                             "eager": run["ttft_s_median"]},
           "launches_eager": run["counts"]}
    log(f"[{label}] graph == eager bitwise: {json.dumps(out)}")
    del run, params
    torch.cuda.empty_cache()
    return out


def two_engines_phase(dev, cfg, label: str) -> dict:
    """15b: two engines over one model and its weights, each serving the
    same 4 cold COLD_LEN-token prompts (4 new tokens) through the captured
    programs: the second captures graphs of its own, its tokens and
    caches equal the first's, and the first's caches are bitwise what they
    were before the second ran."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve import engine as engine_lib
    params = model_lib.init_params(0, cfg, dev)
    step = engine_lib._programs(cfg, SERVE_MAX_SEQ)[0]

    def serve():
        eng = Engine(cfg, params, ServeConfig(slots=SERVE_SLOTS,
                                              max_seq=SERVE_MAX_SEQ),
                     device=dev)
        _, _, tokens = make_traffic(cfg, {"prefix": 0, "requests": []})
        for rid in range(SERVE_SLOTS):
            eng.submit(Request(rid=rid, prompt=tokens(COLD_LEN),
                               max_new_tokens=4))
        return eng, {r.rid: r.tokens_out for r in eng.run_to_completion()}

    first, tokens_first = serve()
    before = cache_snapshot(first.state)
    graphs_first = step.graphs()
    second, tokens_second = serve()
    after, other = cache_snapshot(first.state), cache_snapshot(second.state)
    out = {"graphs_decode_step": [graphs_first, step.graphs()],
           "first_untouched": all(bitwise(after[k], v)
                                  for k, v in before.items()),
           "second_equals_first": tokens_first == tokens_second and all(
               bitwise(other[k], v) for k, v in before.items())}
    log(f"[{label}] two engines: {json.dumps(out)}")
    if not (out["first_untouched"] and out["second_equals_first"]
            and step.graphs() == graphs_first + 1):
        raise AssertionError(f"{label}: two engines share cache writes")
    del first, second, params
    torch.cuda.empty_cache()
    return out


def replay_host_us(program, eng, calls: int = 20) -> float:
    """Median host µs of the launch alone (`CUDAGraph.replay()`, no
    synchronize) of `program`'s graph bound to `eng`'s caches; the idle
    engine's caches take the writes."""
    (entry,) = [g for g in program._graphs.values()
                if any(r() is eng.state.caches["k_words"] for r in g.refs)]
    us = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        entry.graph.replay()
        us.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(us)


def graph_timing_phase(dev, cfg, label: str, traffic: dict) -> dict:
    """15c: an engine with 4 busy slots (prompts of traffic["profile_len"]
    tokens); after one decode step of each arm, GRAPH_ROUNDS rounds of
    one step with the captured programs and one in graph.eager(), in
    turns: the host-clock step (synchronized) and the host µs of the
    decode program's call (no synchronize: what enqueuing the step
    costs); one step of each arm under torch.profiler (the device's busy
    ms and ops); the host µs of the decode graph's replay() alone; then
    `traffic` three times on the same engine, graph (capturing what it
    lacks), eager, graph again: TTFT by admission kind with warm graphs
    against eager; the capture seconds of each program of the model."""
    from repro_torch import graph
    from repro_torch.models import model as model_lib
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve import engine as engine_lib
    params = model_lib.init_params(0, cfg, dev)
    eng = Engine(cfg, params, ServeConfig(slots=SERVE_SLOTS,
                                          max_seq=SERVE_MAX_SEQ), device=dev)
    prefix, prompts, tokens = make_traffic(cfg, traffic)
    prompt_len = traffic["profile_len"]
    for rid in range(SERVE_SLOTS):
        eng.submit(Request(rid=rid, prompt=tokens(prompt_len),
                           max_new_tokens=2 * GRAPH_ROUNDS + 8))
    arms = (("graph", contextlib.nullcontext), ("eager", graph.eager))
    step_ms = {arm: [] for arm, _ in arms}
    host_us = {arm: [] for arm, _ in arms}
    program, current = eng._step, [None]

    def timed_program(*args):
        t = time.perf_counter()
        out = program(*args)
        if current[0] is not None:
            host_us[current[0]].append((time.perf_counter() - t) * 1e6)
        return out

    eng._step = timed_program
    eng.step()                        # admissions + the capture
    with graph.eager():
        eng.step()
    for i in range(2 * GRAPH_ROUNDS):
        arm, ctx = arms[(i + i // 2) % 2]     # g e e g g e e g ...
        with ctx():
            torch.cuda.synchronize()
            current[0] = arm
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_ms[arm].append((time.perf_counter() - t) * 1e3)
            current[0] = None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiled = {}
    for arm, ctx in arms:
        with ctx(), torch.profiler.profile(activities=acts) as prof:
            eng.step()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        profiled[arm] = {
            "device_busy_ms": sum(e.self_device_time_total for e in kern)
            / 1e3 if kern else "not measured",
            "device_ops": sum(e.count for e in kern)}
    eng.run_to_completion()
    replay_us = replay_host_us(program, eng)
    ttft = {}
    if traffic["prefix"]:
        eng.register_prefix("sys", prefix, prefill=True)
    for wave, (arm, ctx) in enumerate(arms + arms[:1]):
        reqs = [Request(rid=1000 * wave + rid, prompt=p, max_new_tokens=4,
                        prefix_id=pid)
                for rid, (p, pid) in enumerate(prompts)]
        with ctx():
            t0 = time.perf_counter()
            for r in reqs:
                r.submit_time = t0
                eng.submit(r)
            eng.run_to_completion()
        ttft[f"{arm}{wave}"] = {k: statistics.median(
            r.ttft_s for r in reqs if r.admission == k)
            for k in sorted({r.admission for r in reqs})}
    programs = engine_lib._programs(cfg, SERVE_MAX_SEQ)
    out = {"step_ms_median": {a: statistics.median(v)
                              for a, v in step_ms.items()},
           "replay_host_us_median": replay_us,
           "ttft_s_median_waves": ttft,
           "step_ms": step_ms,
           "host_us_per_call_median": {a: statistics.median(v)
                                       for a, v in host_us.items()},
           "profiled": profiled,
           "capture_s": {n: p.capture_s for n, p in zip(PROGRAM_NAMES,
                                                         programs)},
           "specializations": {n: p._cache_size() for n, p in
                               zip(PROGRAM_NAMES, programs)},
           "graph_pool_bytes": graph_pool_bytes(),
           "rounds": GRAPH_ROUNDS, "prompt_len": prompt_len}
    log(f"[{label}] graph against eager: {json.dumps(out)}")
    del eng, params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import _build, checks, ops, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.train import train
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    results = {}
    clock = PhaseClock()

    # -- 1. build -----------------------------------------------------------
    build_s = _build.build()
    log(f"[build] {len(_build.SOURCES)} CUDA sources built in {build_s:.2f}s")
    registers = {name: _build.register_report(name)
                 for name in _build.build_log}
    for name, report in registers.items():
        log(f"[build] {name}.cu: " + " | ".join(
            f"{fn} {regs} regs, {spill} B spilled"
            for fn, regs, spill in report))
    clock.done("1 build")

    # -- 2. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    clock.done("2 card")

    # -- 3a. every kernel vs its plain version, sweep -------------------------
    err = {"encode": 0.0, "encode_ef": 0.0, "unpack_dequant": 0.0,
           "fwht": 0.0}
    configs_checked = 0
    for rows in checks.CODEC_ROWS:
        for bits in checks.BITS:
            for n in checks.CODEC_N:
                for mode in checks.CODEC_MODES:
                    checks.check_codec(n, bits, mode, rows, dev)
                    configs_checked += 1
        for n in checks.FWHT_SMALL_N:
            checks.check_fwht(n, rows, dev)
            configs_checked += 1
        for bits in checks.BITS:
            for n, full_n in checks.UNPACK_SHAPES:
                checks.check_unpack(bits, n, full_n, rows, dev)
                configs_checked += 1
    # above N = 8192: the FWHT's and the encoders' passes
    for rows in checks.LARGE_ROWS:
        for n in checks.LARGE_N:
            for bits in checks.BITS:
                for mode in checks.CODEC_MODES:
                    checks.check_codec(n, bits, mode, rows, dev)
                    configs_checked += 1
            checks.check_fwht(n, rows, dev)
            configs_checked += 1
    torch.cuda.synchronize()
    log(f"[check] {configs_checked} configs: payloads, f32 and bf16 EF "
        f"residuals, FWHT and unpack bitwise")
    clock.done("3a codec sweep")

    # -- 3b. the serving kernels vs their plain versions, sweep ---------------
    n_serve_cfg, err["quant_decode_attention"] = check_serve_kernels(dev)
    err["quantize_pack"] = 0.0
    log(f"[check] {n_serve_cfg} configs: quantize_pack bitwise; "
        f"quant_decode_attention max abs err "
        f"{err['quant_decode_attention']:.3g} (tol {checks.ATTN_TOL})")
    clock.done("3b serve-kernel sweep")

    # -- 3c. at the training run's shapes: check, time, bound ----------------
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
    # the card's own write stream of unpack_dequant's outputs
    zero_ms = timed(lambda: [x.zero_() for x in decoded])
    bounds = {
        "encode_ef": bound_ms(*kcost.encode_ef(coords4, rows4, chunk, bits)),
        "unpack_dequant": bound_ms(*kcost.unpack_dequant(coords4, rows4,
                                                         bits)),
        "fwht": bound_ms(*kcost.fwht(coords4, chunk)),
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
    bounds["encode"] = bound_ms(*kcost.encode(coords1, rows1, chunk, bits,
                                              dither=True, mask=True))
    # the loops' variables too: the last leaf, its dither and residual
    # (~3.4 GB) would stay allocated through every later phase
    del leaves1, draws, u, s, d, m, kw, ks, kr, rw, rs
    torch.cuda.empty_cache()

    for name in ("encode", "encode_ef", "unpack_dequant", "fwht"):
        ms, plain_ms, lib_ms = t[name]
        b, by = bounds[name]
        results[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": b, "bound_by": by,
                         "max_abs_err": err[name]}
        if name == "unpack_dequant":
            results[name]["zero_ms"] = zero_ms
        log(json.dumps({"kernel": name, **results[name],
                        "shapes": "yi-6b x1 layer, dithered, keep 0.5"
                        if name == "encode" else "yi-6b x4 layers"}))
    clock.done("3c codec kernels at training shapes")

    # -- 3d. the serving kernels at the serve run's shapes --------------------
    serve_times = time_serve_kernels(ops, ref, dev)
    for key, r in serve_times.items():
        log(json.dumps({"kernel": key, **r}))
    for name, tag in (("quantize_pack", "decode"),
                      ("quant_decode_attention", "serve")):
        r = serve_times[f"{name}/{tag}"]
        results[name] = {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
        results[name]["max_abs_err"] = max(err[name], r["max_abs_err"])
    clock.done("3d serve kernels at serve shapes")

    # -- 3e. quantize_pack at the RATQ train shape ----------------------------
    ratq_pack = time_quantize_pack_ratq(ops, ref, dev, cfg4)
    log(json.dumps({"kernel": "quantize_pack/ratq_train", **ratq_pack}))
    clock.done("3e quantize_pack at the RATQ train shape")

    # -- 3f. the FWHT and the encoders above N = 8192 -------------------------
    large_fwht = time_large_fwht(ops, ref, dev)
    for key, r in large_fwht.items():
        log(json.dumps({"kernel": key, **r}))
    large_encoders = time_large_encoders(ops, ref, dev, cfg1)
    log(json.dumps({"kernel": "encoders/chunk 16384", **large_encoders}))
    clock.done("3f FWHT and encoders above N = 8192")

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
    clock.done("4 train x4")

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
    clock.done("5 train x1 dithered")

    # -- 5b. 1 layer at chunk 16384: the passes in training ------------------
    train_chunk = train_chunk_phase(dev)
    clock.done("5b train x1 chunk 16384")

    # -- 6. small input: the card vs the CPU's plain versions -----------------
    train_card_vs_cpu(dev, configs.get_reduced("yi-6b"), gc_ef, "small")
    clock.done("6 small train, card vs CPU")

    # -- 7. the serving main path: yi-6b, 32 layers, 8-bit NDSC KV cache -------
    serve_keep = {}
    serve_counts, serve_numbers = serve_phase(dev, serve_keep)
    clock.done("7 serve x32")

    # -- 8. small input: serving on the card vs the CPU -----------------------
    small_serve = small_serve_phase(dev)
    clock.done("8 small serve, card vs CPU")

    # -- 9. the paper's algorithms (Algs. 1-3), card vs CPU -------------------
    algorithms = algorithms_phase(dev)
    clock.done("9 paper's algorithms, card vs CPU")

    # -- 10. codecs and federation (codecs/*, fed/*), card vs CPU -------------
    t10 = time.perf_counter()
    codec_numbers = codec_phase(dev)
    clock.done("10a codecs at yi-6b x4")
    fed_numbers = fed_phase(dev)
    clock.done("10b-d federation")
    codec_numbers["phase_s"] = time.perf_counter() - t10

    # -- 11. distributed consensus and the mesh federation --------------------
    dist_a = one_rank_phase(dev, cfg4, gc_ef)
    clock.done("11a one NCCL rank")
    dist_ranks = ranks_phase()
    clock.done("11b-d four ranks sharing the card")

    # -- 13. the other block families (models/{moe,ssm,xlstm}) ---------------
    moe_keep, hymba_keep = {}, {}
    moe_serve_counts, moe_serve = moe_serve_phase(dev, keep=moe_keep)
    clock.done("13a serve mixtral x4")
    moe_train = moe_train_phase(dev)
    clock.done("13b train mixtral x1")
    _, hymba_serve = hymba_serve_phase(dev, keep=hymba_keep)
    clock.done("13c serve hymba x32")
    families = families_card_vs_cpu(dev)
    clock.done("13d reduced families, card vs CPU")
    xlstm_train = xlstm_train_phase(dev)
    clock.done("13e train xlstm x24")

    # -- 14. checkpointing and observability (checkpoint/*, obs/*) ----------
    p14 = {"a": ckpt_fed_phase(dev)}
    clock.done("14a checkpointed federation, m 8")
    p14["b"] = ckpt_cohort_phase(dev)
    p14["b"]["mesh_under_obs (phase 11d ranks)"] = dist_ranks["d"][
        "obs_all_ranks"]
    clock.done("14b checkpointed federation, m 512")
    p14["c"] = serve_obs_phase(dev, serve_keep, serve_times)
    clock.done("14c serve x32 under obs (15d: under graphs)")
    p14["d"] = train_obs_phase(dev, cfg4, gc_ef)
    clock.done("14d train x4 under obs")
    p14["e"] = ckpt_train_phase(dev, cfg1, gc_ef)
    clock.done("14e train x1 --ckpt-dir")
    p14["f"] = fed_obs_overhead_phase(dev)
    clock.done("14f obs overhead, m 512 rounds")

    # -- 15. the captured serve programs (repro_torch.graph) ---------------
    p15 = {"a": {}, "c": {}, "d": "phase14.c"}
    models15 = (("yi-6b x32", serve_cfg(), PHASE7_TRAFFIC, serve_keep),
                ("mixtral x4", moe_serve_cfg(), PHASE7_TRAFFIC, moe_keep),
                ("hymba x32", hymba_serve_cfg(), HYMBA_TRAFFIC, hymba_keep))
    for key, cfg, traffic, keep in models15:
        p15["a"][key] = graph_vs_eager_phase(dev, cfg, traffic, keep,
                                             f"15a {key}")
    del serve_keep, moe_keep, hymba_keep
    clock.done("15a graph against eager, three models")
    p15["b"] = two_engines_phase(dev, serve_cfg(), "15b yi-6b x32")
    clock.done("15b two engines")
    for key, cfg, traffic, _ in models15:
        p15["c"][key] = graph_timing_phase(dev, cfg, f"15c {key}", traffic)
    clock.done("15c decode step, graph and eager in turns")

    # -- 16. serving across workers (the "model" axis) -----------------------
    p16 = tp_phase(dev)
    clock.done("16 serving across workers, model 2 and 4")

    # -- 12. result lines -------------------------------------------------------
    names = {
        "encode": ("src/repro_torch/csrc/quantencode.cu",
                   "src/repro/kernels/quantencode.py:200", dk_counts),
        "encode_ef": ("src/repro_torch/csrc/quantencode.cu",
                      "src/repro/kernels/quantencode.py:218", main_counts),
        "unpack_dequant": ("src/repro_torch/csrc/quantpack.cu",
                           "src/repro/kernels/quantpack.py:94", main_counts),
        "fwht": ("src/repro_torch/csrc/fwht.cu",
                 "src/repro/kernels/fwht.py:43", main_counts),
        "quantize_pack": ("src/repro_torch/csrc/quantpack.cu",
                          "src/repro/kernels/quantpack.py:59", serve_counts),
        "quant_decode_attention": ("src/repro_torch/csrc/quantdecode.cu",
                                   "src/repro/kernels/quantdecode.py:100",
                                   serve_counts),
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
    record = {"card": card, "build_s": build_s, "registers": registers,
              "kernels": kernels,
              "train_x4": {"losses": losses, "step_s": secs,
                           "peak_mem_GB": peak_gb},
              "train_x1_dithered": {"losses": losses1, "step_s": secs1},
              "serve_kernels": serve_times, "serve_x32": serve_numbers,
              "small_serve": small_serve, "algorithms": algorithms,
              "codecs": codec_numbers, "federation": fed_numbers,
              "quantize_pack_ratq_train": ratq_pack,
              "large_n": {"fwht": large_fwht, "encoders": large_encoders,
                          "train_x1_chunk16384": train_chunk},
              "dist_one_rank": dist_a, "dist_four_ranks": dist_ranks,
              "families": {"serve_mixtral_x4": moe_serve,
                           "serve_mixtral_x4_launches": moe_serve_counts,
                           "train_mixtral_x1": moe_train,
                           "serve_hymba_x32": hymba_serve,
                           "card_vs_cpu": families,
                           "train_xlstm_x24": xlstm_train},
              "phase14": p14, "phase15": p15, "phase16": p16,
              "phase_s": clock.seconds}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if "--rank" in sys.argv[1:]
             else main())
