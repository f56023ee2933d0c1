"""Serving launcher: batched prefill + greedy decode against explicit caches
(port of `repro.launch.serve`). Same flags, plus `--device` (default
`cuda`).

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Without a GPU, the default `--device cuda` raises rather than running on
the CPU. The prefill is a `repro_torch.graph.Program` binding the
parameters (as the reference jits it, unregistered): on the card its call
runs it and captures a CUDA graph. The decode loop calls
`dist.step.make_serve_step`'s captured program: on the card its first call
captures a CUDA graph, the later ones replay it. `with
repro_torch.graph.eager():` runs both as plain calls.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch import configs, graph, resolve_device
from repro_torch.dist import step as step_lib
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device=None, timings: dict | None = None) -> torch.Tensor:
    """Prefill `batch` random prompts of `prompt_len` tokens, then decode
    `gen` greedy tokens each, from seeded random weights on `device` (cuda
    by default). Returns the (batch, gen) generated tokens; a `timings`
    dict gets the prefill's and the decode loop's seconds."""
    if not cfg.decode_supported:
        raise SystemExit(f"{cfg.name}: {cfg.decode_refusal}")
    device = resolve_device(device)
    model_lib.disable_tf32()
    params = model_lib.init_params(seed, cfg, device)
    gen_cpu = torch.Generator()
    gen_cpu.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen_cpu, dtype=torch.int32).to(device)
    max_seq = prompt_len + gen

    # the parameters ("[0]") bound by pointer: no call copies the weights
    prefill = graph.Program(functools.partial(decode_lib.prefill, cfg,
                                              max_seq=max_seq), ("[0]",))
    _sync(device)
    t0 = time.perf_counter()
    logits, state = prefill(params, prompts)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill[{batch}×{prompt_len}] {prefill_s:.2f}s "
          f"(cache_len={decode_lib.cache_len(cfg, max_seq)}, "
          f"kv_bits={cfg.kv_quant_bits or 32}, device={device})")

    sstep = step_lib.make_serve_step(cfg)
    tok = decode_lib.greedy_token(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = sstep(params, state, tok)
        tok = decode_lib.greedy_token(logits)
        out.append(tok)
    seqs = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    if timings is not None:
        timings.update(prefill_s=prefill_s, decode_s=dt)
    print(f"decode {gen-1} steps in {dt:.2f}s "
          f"({(gen-1)*batch/max(dt,1e-9):.1f} tok/s)")
    for b in range(min(batch, 4)):
        print(f"  seq[{b}]: {seqs[b].tolist()}")
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
