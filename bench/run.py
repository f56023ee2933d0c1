"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration and traffic mix (`bench.harness`); the mix's `mode` names
the driver, `bench/<mode>.py`, whose `run` sets up, measures for
--seconds and checks the timed path's output against the plain
reference. The run prints one JSON object as its last line of standard
output: with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, a `device` with the traced window's busy and total
seconds, and a `breakdown`. Each number the check compared is printed beside its limit,
last on standard error and under `checks`, the line's last key.

Exits 2 without a CUDA card or with fewer than the cell asks for, and 3
if JAX or the JAX package was loaded; no result is printed then. The
program's kernels build once into `build/repro_torch/` inside the
checkout, keyed by their sources.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# transformers and its kin load JAX when they find it; the port needs none
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from bench import harness, tracing  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: dict, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, fault=None) -> dict:
    """Everything of a run after the look for a card: the mode's run,
    then the metrics the line reports. Returns {"line", "checks", "out"}
    (`out` the driver's whole result)."""
    driver = importlib.import_module(f"bench.{cell['mix']['mode']}")
    out = driver.run(harness.Run(cell, seed, seconds, trace, device,
                                 t_start, fault))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if trace:
        t = out["trace"]
        metrics = {}
        for m in cell["per_layer"]:
            value = harness.metric_reader(m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = harness.metric(value, m["unit"])
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        breakdown = tracing.breakdown(t)
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: harness.metric(v, units[k])
                   for k, v in out["metrics"].items() if k in units}
    line = harness.result_line(out["correct"], out["attempted"],
                               out["failed"], metrics, dev, out["checks"],
                               breakdown)
    return {"line": line, "checks": out["checks"], "out": out}


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    done = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(done["line"], flush=True)
    harness.print_checks(done["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
