"""Time of the optimizer phase's kernels on one card, in turns against the
tree maps they replace, at the 12 leaf shapes of the 8-layer yi-6b tree
(1,908,477,952 f32 values, the `yi6b-train-*` cells' tree).

    python3 tools/optim_time.py [--reps N] [--sgd]

The inputs, the checks and the calls are chip_smoke's phase 3g
(`optim_tree`, `check_optim_kernels`, `optim_calls`): the updates
bitwise against the plain ones given the same scale, the norm within
1e-6 of the f64 sum. Arms, each timed over the whole tree by CUDA
events, in turns (the sides' order reversed every other turn):
- norm: `ops.sum_squares` over the leaves (the tile kernel and its
  finishing kernel), against `ref.sum_squares` (a square and a sum a
  leaf) and the library's reduction (`torch.linalg.vector_norm` a leaf,
  then the norm of those);
- update: AdamW (0.9, 0.95, 1e-8, weight decay 0.1, lr 3e-4) with the
  clip's scale folded in, `ops.adamw_update` a leaf, against the clip's
  map and `ref.adamw_update` a leaf (the tree maps' 15 kernels);
- phase: the two, with the norm's square root and the clip scale between
  them, as the train step runs its optimizer phase;
- with --sgd, plain SGD at lr 0.01 without clip (`mixtral-train-ndsc`'s
  rule) against its map.
Each side's median and quartiles in ms, and its share of the arm's bound
at 3.35 TB/s: 4 B a value for the norm, 28 for the update, 32 for the
phase, 8 for SGD (the least the mathematics reads and writes at f32).
Prints one JSON object, the card's name and power limit in it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PEAK_BYTES_S = 3.35e12
BYTES_PER_VALUE = {"norm": 4, "update": 28, "phase": 32, "sgd": 8}


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": q.stdout.strip()}


def timed_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    del out
    return start.elapsed_time(end)


def run(cfg, dev: torch.device, reps: int, sgd: bool) -> dict:
    """The arms at `cfg`'s leaf shapes on `dev` (module docstring)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.optimizer import optim

    t = cs.optim_tree(cfg, dev)
    n = sum(g.numel() for g in t["grads"])
    checked = cs.check_optim_kernels(ops, ref, t)
    calls = cs.optim_calls(ops, ref, t, checked.pop("scale_t"))
    norm_kernel, norm_plain, norm_library = calls["sum_squares"]

    def phase(norm, side):
        scale = optim.clip_scale(torch.sqrt(norm()), 1.0)
        return cs.optim_calls(ops, ref, t, scale)["adamw_update"][side]()

    arms = {"norm": {"plain": norm_plain, "kernel": norm_kernel,
                     "library": norm_library},
            "update": {"plain": calls["adamw_update"][1],
                       "kernel": calls["adamw_update"][0]},
            "phase": {"plain": lambda: phase(norm_plain, 1),
                      "kernel": lambda: phase(norm_kernel, 0)}}
    if sgd:
        arms["sgd"] = {"plain": calls["sgd_update"][1],
                       "kernel": calls["sgd_update"][0]}
    for sides in arms.values():           # warm-up
        for fn in sides.values():
            timed_ms(fn)

    ms = {k: {side: [] for side in sides} for k, sides in arms.items()}
    for r in range(reps):
        for name, sides in arms.items():
            order = list(sides) if r % 2 == 0 else list(sides)[::-1]
            for side in order:
                ms[name][side].append(timed_ms(sides[side]))
    out = {"values": n, "leaves": len(t["grads"]), "reps": reps,
           **checked}
    for name, sides in ms.items():
        bound = n * BYTES_PER_VALUE[name] / PEAK_BYTES_S * 1e3
        out[name] = {"bound_ms": bound, "bytes_per_value":
                     BYTES_PER_VALUE[name]}
        for side, xs in sides.items():
            q = statistics.quantiles(xs, n=4)
            med = statistics.median(xs)
            out[name][side] = {"median_ms": med, "q1": q[0], "q3": q[2],
                               "share_of_bound": bound / med}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sgd", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.model import disable_tf32

    if not torch.cuda.is_available():
        raise SystemExit("optim_time needs a CUDA card")
    disable_tf32()
    cfg = dataclasses.replace(configs.get("yi-6b"),
                              num_layers=cs.OPT_LAYERS)
    out = {**card(), **run(cfg, torch.device("cuda"), args.reps, args.sgd)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
