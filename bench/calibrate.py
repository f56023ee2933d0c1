"""The readings a cell's correctness limits are set from: for each seed,
the program's checked steps against the reference (the lower readings);
on the first `--control` seeds the control against the reference (the
reference itself in the program's place at the next precision down: TF32
products, on the card with `allow_tf32`, on the CPU by rounding each
product's operands); and on as many seeds each planted fault of the
timed path (`bench.train.FAULTS`) against the reference.

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control 3

One process, one seed after another, on the card. The frozen state
reads 1 by construction (`bench.train.FAULTS`) and is not run here.
Prints one JSON line a seed and a last line with the largest sound
reading, the smallest control reading and each fault's smallest reading
of each number.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness, weights  # noqa: E402
from bench import train as train_cell  # noqa: E402
from bench.reference import model as ref_model  # noqa: E402
from bench.reference import train as reference  # noqa: E402

NUMBERS = ("loss1", "grad", "grad2", "change", "loss")
SEED0 = 3_000_000_011


@contextlib.contextmanager
def tf32(device):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = device.type == "cuda"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def control_gaps(cell: dict, seed: int, device) -> dict:
    """The control against the reference on the cell's checked steps."""
    cfg, mix = cell["cfg"], cell["mix"]
    pool = weights.token_rows(cfg, seed, train_cell.CHECKED_STEPS,
                              mix["batch"], mix["seq"], device)
    want = reference.run(cfg, mix, seed, pool, device)
    matmul = (ref_model._f32_matmul if device.type == "cuda"
              else ref_model.tf32_matmul)
    with tf32(device):
        got = reference.run(cfg, mix, seed, pool, device, matmul)
    return reference.gaps(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=SEED0,
                    help="the first seed; seed k is first + 7919 k")
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    device = torch.device("cuda", 0)
    sound, control = [], []
    faults = {f: [] for f in train_cell.FAULTS if f != "frozen_state"}
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        t = time.perf_counter()
        out = train_cell.run(harness.Run(cell, seed, 0.0, False, device,
                                            t))
        sound.append(out["gaps"])
        line = {"seed": seed, "program": out["gaps"],
                "correct": out["correct"], "s": time.perf_counter() - t,
                "metrics": out["metrics"]}
        if k < args.control:
            if device.type == "cuda":
                torch.cuda.empty_cache()
            control.append(control_gaps(cell, seed, device))
            line["control"] = control[-1]
            for f in faults:
                faults[f].append(train_cell.run(harness.Run(
                    cell, seed, 0.0, False, device, t, f))["gaps"])
                line[f] = faults[f][-1]
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": {n: max(g[n] for g in sound) for n in NUMBERS},
        "control_least": {n: min(g[n] for g in control) for n in NUMBERS}
        if control else None,
        "faults_least": {f: {n: min(g[n] for g in v) for n in NUMBERS}
                         for f, v in faults.items() if v}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
