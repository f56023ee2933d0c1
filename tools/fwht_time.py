"""Time of the FWHT above N = 8192 and of the encoders that run its passes,
on one card, for one or several source trees.

    python3 tools/fwht_time.py [--train] [SRC ...]

Each SRC is a directory that holds a `repro_torch` package (default: this
checkout's `src`); each is timed in a process of its own, in the order
given, so `tools/fwht_time.py build/parent/src src src build/parent/src`
compares two trees on one card in turns. For each tree, in this order:
encode_ef (EF) and the dithered, keep-0.5 encode on the 1-layer yi-6b tree
at chunks 16384 and 32768 (`time_large_encoders`, the encoders' row
kernel) and on one tensor of 3f's rows at chunk 2^20
(`large_encoders_one_tensor`, the passes route); the FWHT at
chip_smoke.py phase 3f's shapes (LARGE_LIB_SHAPES and one row of each
checks.FWHT_HUGE_N), bitwise its plain version, timed by CUDA events
(median of 5) and by its kernels' device time (torch.profiler, 5 calls)
beside its bound, with its pass count and, at 2^14 and 2^15, the device
activities of ROW_CALLS calls (torch.profiler; "not measured" where it
drops a window's fence); with --train, phase 5b's training at chunk 16384
(2 steps of the captured step, the first of which captures), as s/step.
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
    from repro_torch.kernels import checks, ops, ref
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fwht as F
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    cfg1 = dataclasses.replace(configs.get("yi-6b"), num_layers=1)
    out = {"src": str(src), "card": torch.cuda.get_device_name(0)}
    for chunk in cs.ROW_CHUNKS:
        enc = cs.time_large_encoders(ops, ref, dev, cfg1, chunk, plain=False,
                                     activities=False)
        out[f"chunk {chunk}"] = {
            name: {k: enc[name][k] for k in ("ms", "bound_ms",
                                             "share_of_bound")}
            for name in ("encode_ef", "encode")}
    out[f"chunk {cs.PASS_CHUNK}"] = cs.large_encoders_one_tensor(
        ops, ref, dev, cfg1, cs.PASS_CHUNK, plain=False)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    for n, rows in (list(cs.LARGE_LIB_SHAPES)
                    + [(n, 1) for n in checks.FWHT_HUGE_N]):
        x = torch.randn(rows, n, generator=g, device=dev)
        b, _ = cs.bound_ms(*kcost.fwht(x.numel(), n))
        ms = cs.timed(lambda: ops.fwht(x))
        r = {"exact": torch.equal(ops.fwht(x), ref.fwht(x)), "ms": ms,
             "device_ms": cs.device_ms(lambda: ops.fwht(x), 5),
             "bound_ms": b, "share_of_bound": b / ms,
             "passes": len(F.fwht_plan(n.bit_length() - 1))}
        if rows > 1:
            try:
                acts = cs.device_activities(lambda: ops.fwht(x))
                r["device_activities_per_call"] = len(acts) / cs.ROW_CALLS
                r["device_activities"] = sorted(set(acts))
            except AssertionError:             # the profiler lost a fence
                r["device_activities_per_call"] = "not measured"
        out[f"fwht/{rows}x2^{n.bit_length() - 1}"] = r
        del x
        torch.cuda.empty_cache()
    if train:
        with cs.kept_train({}):
            run = cs.train_chunk_phase(dev)
        out["train_x1_chunk16384_step_s"] = run["step_s"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fwht_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    train = "--train" in args
    srcs = [a for a in args if a != "--train"] or [str(ROOT / "src")]
    if len(srcs) == 1:
        print(json.dumps(time_tree(Path(srcs[0]), train)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    flag = ["--train"] if train else []
    for src in srcs:                   # one process per tree
        rc = subprocess.run([sys.executable, __file__, *flag, src]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
