"""Time of the NDSC encoders above N = 8192 on one card, for one or several
source trees.

    python3 tools/encode_time.py [--no-train] [--no-row] [SRC ...]

Each SRC is a directory that holds a `repro_torch` package (default: this
checkout's `src`); each is timed in a process of its own, in the order
given, so `tools/encode_time.py build/parent/src src src build/parent/src`
compares two trees on one card in turns. For each tree: unless --no-row,
chip_smoke.py phase 3f's encoders at chunks 16384 and 32768
(`time_large_encoders`: encode_ef with EF and the dithered, keep-0.5
encode on the 1-layer yi-6b tree's leaves, each leaf bitwise its plain
version, the tree timed by CUDA events, median of 5, beside its bound,
and the device activities per call under torch.profiler); then both
encoders on one tensor of that tree's coordinates in rows of 65536 and
131072 (the "cluster" route) and of 2^20 (the passes)
(`large_encoders_one_tensor`: bitwise, CUDA events, the kernels' device
time per call under torch.profiler, and at 65536 and 131072 the device
activities per call; "not measured" where the profiler loses a window's
fences); then, unless --no-train, phase 5b's and 5c's
training at chunks 16384 and 65536 (2 steps of the captured step, the
first of which captures) and 17c's and 17h's reruns of their steps inside
graph.eager(), as s/step. Prints the card's name and power limit, then
one JSON object per SRC.
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

FLAGS = ("--no-train", "--no-row")


def time_tree(src: Path, train: bool, row: bool) -> dict:
    sys.path.insert(0, str(src.resolve()))
    from repro_torch import configs
    from repro_torch.dist import gradcomp as G
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    cfg1 = dataclasses.replace(configs.get("yi-6b"), num_layers=1)
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    for chunk in cs.ROW_CHUNKS if row else ():
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
    key = f"device_activities_of_{cs.ROW_CALLS}_calls"
    for chunk in cs.CLUSTER_CHUNKS + (cs.PASS_CHUNK,):
        try:
            enc = cs.large_encoders_one_tensor(
                ops, ref, dev, cfg1, chunk, plain=False,
                activities=chunk in cs.CLUSTER_CHUNKS)
        except AssertionError:   # the profiler lost every window's fences
            enc = cs.large_encoders_one_tensor(ops, ref, dev, cfg1, chunk,
                                               plain=False)
        out[f"one tensor, chunk {chunk}"] = {
            name: {"ms": enc[name]["ms"], "device_ms": enc[name]["device_ms"],
                   "bound_ms": enc[name]["bound_ms"],
                   "share_of_bound": enc[name]["share_of_bound"],
                   "launches": enc[name]["launches"],
                   **({"device_activities_per_call":
                       len(enc[name][key]) / cs.ROW_CALLS,
                       "device_activities": sorted(set(enc[name][key]))}
                      if key in enc[name] else
                      {"device_activities_per_call": "not measured"})}
            for name in ("encode_ef", "encode")}
    for chunk in (cs.LARGE_CHUNK, cs.CLUSTER_CHUNK) if train else ():
        box = {}
        with cs.kept_train(box):
            run = cs.train_chunk_phase(dev, chunk=chunk)
        box["losses"] = list(run["losses"])
        gc = G.GradCompConfig(bits=4, chunk=chunk)
        rerun = cs.eager_rerun(dev, cfg1, gc, box, f"chunk {chunk} x1")
        out[f"train_x1_chunk{chunk}"] = {
            "graph_step_s": run["step_s"],
            "eager_step_s": rerun["eager_step_s"]}
        del box
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    flags = [a for a in args if a in FLAGS]
    srcs = [a for a in args if a not in FLAGS] or [str(ROOT / "src")]
    if len(srcs) == 1:
        print(json.dumps(time_tree(Path(srcs[0]), "--no-train" not in flags,
                                   "--no-row" not in flags)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for src in srcs:                   # one process per tree
        rc = subprocess.run([sys.executable, __file__, *flags, src]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
