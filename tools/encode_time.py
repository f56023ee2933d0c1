"""Time of the NDSC encoders above N = 8192 on one card, for one or several
source trees.

    python3 tools/encode_time.py [--no-train] [SRC ...]

Each SRC is a directory that holds a `repro_torch` package (default: this
checkout's `src`); each is timed in a process of its own, in the order
given, so `tools/encode_time.py build/parent/src src src build/parent/src`
compares two trees on one card in turns. For each tree: chip_smoke.py
phase 3f's encoders (`time_large_encoders`: encode_ef with EF and the
dithered, keep-0.5 encode on the 1-layer yi-6b tree's leaves at chunks
16384 and 32768, each leaf bitwise its plain version, the tree timed by
CUDA events, median of 5, beside its bound, and the device activities
per call under torch.profiler); then, unless --no-train, phase 5b's training
at chunk 16384 (2 steps of the captured step, the first of which
captures) and 17c's rerun of its steps inside graph.eager(), as s/step.
Prints the card's name and power limit, then one JSON object per SRC.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def time_tree(src: Path, train: bool) -> dict:
    sys.path.insert(0, str(src.resolve()))
    from repro_torch import configs
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    cfg1 = dataclasses.replace(configs.get("yi-6b"), num_layers=1)
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    for chunk in cs.ROW_CHUNKS:
        enc = cs.time_large_encoders(ops, ref, dev, cfg1, chunk, plain=False)
        out[f"chunk {chunk}"] = {
            name: {"ms": enc[name]["ms"], "bound_ms": enc[name]["bound_ms"],
                   "share_of_bound": enc[name]["share_of_bound"],
                   "launches_per_tree": enc[name]["launches_per_tree"],
                   "device_activities_per_call": len(
                       enc[name][f"device_activities_of_{cs.ROW_CALLS}_"
                                 "calls"]) / cs.ROW_CALLS,
                   "device_activities": sorted(set(
                       enc[name][f"device_activities_of_{cs.ROW_CALLS}_"
                                 "calls"]))}
            for name in ("encode_ef", "encode")}
    if train:
        box = {}
        with cs.kept_train(box):
            run = cs.train_chunk_phase(dev)
        box["losses"] = list(run["losses"])
        gc = G.GradCompConfig(bits=4, chunk=cs.LARGE_CHUNK)
        rerun = cs.eager_rerun(dev, cfg1, gc, box, "c chunk 16384 x1")
        out["train_x1_chunk16384"] = {"graph_step_s": run["step_s"],
                                      "eager_step_s": rerun["eager_step_s"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    train = "--no-train" not in args
    srcs = [a for a in args if a != "--no-train"] or [str(ROOT / "src")]
    if len(srcs) == 1:
        print(json.dumps(time_tree(Path(srcs[0]), train)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    flag = [] if train else ["--no-train"]
    for src in srcs:                   # one process per tree
        rc = subprocess.run([sys.executable, __file__, *flag, src]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
