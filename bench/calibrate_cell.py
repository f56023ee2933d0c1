"""`bench/calibrate.py` for a cell of any train mode: the readings a cell's
correctness limits are set from, by the mode's own driver
(`bench/<mode>.py`: `run`, `FAULTS`, `control_gaps`).

    python3 bench/calibrate_cell.py --workload <cell> --seeds 6 \
        --control 2 --faults 2

For each seed the program's checked steps against the reference (the
lower readings); on the first `--control` seeds the control (the
reference at TF32 products) against the reference; on the first
`--faults` seeds each planted fault of the mode but the frozen state
(which reads 1 by construction). One process, on the card. Prints one
JSON line a reading and a last line with the largest sound reading, the
smallest control reading and each fault's smallest reading of each
number.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import calibrate, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--control", type=int, default=2)
    ap.add_argument("--faults", type=int, default=2)
    ap.add_argument("--first", type=int, default=calibrate.SEED0,
                    help="the first seed; seed k is first + 7919 k")
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    driver = importlib.import_module(f"bench.{cell['mix']['mode']}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    readings = {"sound": [], "control": []}
    faults = [f for f in driver.FAULTS if f != "frozen_state"]
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        jobs = [("sound", None)]
        jobs += [("control", None)] if k < args.control else []
        jobs += [(f, f) for f in faults] if k < args.faults else []
        for what, fault in jobs:
            t = time.perf_counter()
            torch.cuda.empty_cache()
            if what == "control":
                gaps = driver.control_gaps(cell, seed, device)
            else:
                out = driver.run(harness.Run(cell, seed, 0.0, False, device,
                                             t, fault))
                gaps = out["gaps"]
            readings.setdefault(what, []).append(gaps)
            print(json.dumps({"seed": seed, "reading": what, "gaps": gaps,
                              "s": time.perf_counter() - t}), flush=True)
    numbers = calibrate.NUMBERS
    print(json.dumps({
        "workload": args.workload,
        "lower": {n: max(g[n] for g in readings["sound"]) for n in numbers},
        "least": {w: {n: min(g[n] for g in v) for n in numbers}
                  for w, v in readings.items() if v and w != "sound"}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
