"""Training driver: LM training with compressed gradient consensus (port of
`repro.launch.train`). Same flags, plus `--device` (default `cuda`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 50 --batch 8 --seq 128 --bits 4 --device cpu

Without a GPU, the default `--device cuda` raises rather than running on
the CPU. Checkpointing (`--ckpt-dir` in the reference) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import batch_for_shape
from repro_torch.dist import step as step_lib
from repro_torch.dist.gradcomp import GradCompConfig, wire_bytes_tree
from repro_torch.models.model import disable_tf32
from repro_torch.optimizer.optim import adamw, warmup_cosine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, *, steps: int, batch_size: int, seq_len: int,
          gc: GradCompConfig, lr: float = 3e-4, log_every: int = 10,
          seed: int = 0, device=None, on_step=None):
    """Train `steps` steps from seeded random weights on `device` (cuda by
    default). Returns (params, losses, step_seconds); `on_step(step,
    metrics)` is called after each step, once the device has finished it."""
    device = resolve_device(device)
    disable_tf32()
    opt = adamw(warmup_cosine(lr, max(steps // 20, 1), steps),
                weight_decay=0.1)
    tstep = step_lib.make_train_step(cfg, opt, gc, clip_norm=1.0)
    params, opt_state, ef = step_lib.init_train_state(
        cfg, opt, gc, seed=seed, device=device)

    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    print(f"model={cfg.name} layers={cfg.num_layers} "
          f"params={n_params/1e6:.1f}M workers=1 strategy={gc.strategy} "
          f"R={gc.effective_bits if gc.compresses else 32} bits/dim "
          f"device={device}")
    if gc.compresses:
        audit = wire_bytes_tree(params, gc, 1)
        print(f"wire audit: f32={audit['f32_bytes']/2**20:.1f}MiB → "
              f"payload={audit['payload_bytes']/2**20:.1f}MiB "
              f"({audit['compression_x']:.1f}× smaller)")
    else:
        print("wire audit: uncompressed f32 all-reduce (psum)")

    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = batch_for_shape(cfg, batch_size, seq_len, step, seed,
                                device=device)
        _sync(device)
        ts = time.perf_counter()
        params, opt_state, ef, metrics = tstep(params, opt_state, ef, batch)
        _sync(device)
        step_seconds.append(time.perf_counter() - ts)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"step {step_seconds[-1]:.3f}s  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return params, losses, step_seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b", choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--bits", type=int, default=4, choices=(1, 2, 4, 8))
    ap.add_argument("--strategy", default="allgather_packed",
                    choices=("psum", "psum_decoded", "allgather_packed"))
    ap.add_argument("--keep-fraction", type=float, default=1.0,
                    help="chunk keep rate: R_eff = bits × keep (< 1 is the "
                         "paper's sub-linear regime)")
    ap.add_argument("--dithered", action="store_true",
                    help="unbiased dithered codec — drops the params-sized "
                         "error-feedback state")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    gc = GradCompConfig(bits=args.bits, strategy=args.strategy,
                        keep_fraction=args.keep_fraction,
                        dithered=args.dithered,
                        error_feedback=not args.dithered)
    return train(cfg, steps=args.steps, batch_size=args.batch,
                 seq_len=args.seq, gc=gc, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
