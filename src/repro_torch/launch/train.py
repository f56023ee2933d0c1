"""Training driver: LM training with compressed gradient consensus (port of
`repro.launch.train`). Same flags, plus `--device` (default `cuda`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 50 --batch 8 --seq 128 --bits 4 --device cpu

Without a GPU, the default `--device cuda` raises rather than running on
the CPU. `--ckpt-dir DIR` saves {"params", "opt_state"} after the last
step at DIR/step_<steps> (`repro_torch.checkpoint`). Over m workers, every
rank calls `train(..., group=group)` with the same arguments
(`repro_torch.launch.mesh`): each takes its rows of the global batch.
`group` may be a ("data", "model") mesh (`make_host_group(data, model)`):
the workers are its data ranks, and at model > 1 a rank holds its slices
of the params and optimizer state (`dist.step.make_train_step`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.pipeline import batch_for_shape
from repro_torch.dist import sharding
from repro_torch.dist import step as step_lib
from repro_torch.dist.gradcomp import GradCompConfig, wire_bytes_tree
from repro_torch.models.model import disable_tf32, param_count
from repro_torch.optimizer.optim import adamw, warmup_cosine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, *, steps: int, batch_size: int, seq_len: int,
          gc: GradCompConfig, lr: float = 3e-4, log_every: int = 10,
          seed: int = 0, device=None, on_step=None, group=None,
          ckpt_dir=None):
    """Train `steps` steps from seeded random weights on `device` (cuda by
    default), over the workers of `group` (None: one). Returns (params,
    losses, step_seconds), the params this rank's slices on a mesh with
    model > 1; `on_step(step, metrics)` is called after each step, once
    the device has finished it. With `ckpt_dir`, rank 0 saves the whole
    {"params", "opt_state"} at `ckpt_dir/step_<steps>` after the last
    step."""
    device = resolve_device(device)
    disable_tf32()
    opt = adamw(warmup_cosine(lr, max(steps // 20, 1), steps),
                weight_decay=0.1)
    tstep = step_lib.make_train_step(cfg, opt, gc, group, clip_norm=1.0)
    params, opt_state, ef = step_lib.init_train_state(
        cfg, opt, gc, group, seed=seed, device=device)
    m = sharding.num_workers(group)

    n_params = param_count(cfg)
    print(f"model={cfg.name} layers={cfg.num_layers} "
          f"params={n_params/1e6:.1f}M workers={m} strategy={gc.strategy} "
          f"R={gc.effective_bits if gc.compresses else 32} bits/dim "
          f"device={device}")
    if gc.compresses:
        audit = wire_bytes_tree(step_lib.meta_params(cfg), gc, m)
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
    if ckpt_dir:
        whole = step_lib.whole_train_state(cfg, group, params, opt_state)
        if sharding.worker_index(group) == 0 and (
                not isinstance(group, sharding.HostMesh)
                or group.model_index == 0):
            path = save_checkpoint(ckpt_dir, steps, {"params": whole[0],
                                                     "opt_state": whole[1]})
            print(f"checkpoint → {path}")
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
    ap.add_argument("--ckpt-dir", default=None)
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
                 seq_len=args.seq, gc=gc, lr=args.lr, device=args.device,
                 ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
