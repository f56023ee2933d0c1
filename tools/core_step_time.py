"""Seconds of Alg. 1's runs as captured step programs on one card, split
into the first call and the replays, with the allocator-cache rule of
`repro_torch.graph` on and off.

    python3 tools/core_step_time.py

On chip_smoke phase 9's Alg. 1 problem (fig1b: n 116, m 200), 120-step
runs of gd, dqgd_schedule, naive dqgd and DGD-DEF (NDE-Hadamard, R 4),
in turns, ROUNDS times: each run once with `graph._CACHE_SLACK` at its
default (the cache is freed around a first call only above it) and once
at 0 (freed at every first call). For each run: its seconds, the seconds
of its first call (eager run and capture), of `torch.cuda.empty_cache`
inside it, and the same run inside `graph.eager()`. Then 2000-step runs
of gd and DGD-DEF, whose steps/s are the replay rate (the first call
amortized). Prints one JSON object with medians per family and arm, and
the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 5
STEPS, LONG_STEPS = 120, 2000


def main() -> int:
    if not torch.cuda.is_available():
        print("core_step_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import graph
    from repro_torch import random as rnd
    from repro_torch.core import baselines as B
    from repro_torch.core import coding as C
    from repro_torch.core import frames as F
    from repro_torch.core import optim as O
    from repro_torch.kernels import _build
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    model_lib.disable_tf32()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    acc = {"empty_cache_s": 0.0, "first_call_s": 0.0}
    empty_cache, first_run = torch.cuda.empty_cache, graph.Program._first_run

    def counted_empty_cache():
        t = time.perf_counter()
        empty_cache()
        acc["empty_cache_s"] += time.perf_counter() - t

    def counted_first_run(self, *args):
        t = time.perf_counter()
        out = first_run(self, *args)
        acc["first_call_s"] += time.perf_counter() - t
        return out

    torch.cuda.empty_cache = counted_empty_cache
    graph.Program._first_run = counted_first_run

    p = cs._to(cs.paper_problems()["alg1"], dev)
    n = cs.ALG1_N
    alpha = O.alpha_star(p["L"], p["mu"])
    grad = lambda x: p["h"] @ x - p["atb"]                     # noqa: E731
    x0, xs = torch.zeros(n, device=dev), p["x_star"]
    codec = C.Codec(F.hadamard_frame(rnd.key(0, device=dev), n),
                    C.CodecConfig(bits_per_dim=4.0))
    runs = {
        "gd": lambda s: O.gd(grad, x0, alpha, s, x_star=xs),
        "dqgd_schedule": lambda s: O.dqgd_schedule(
            grad, x0, 16, alpha, s, p["L"], p["mu"], 10.0, n, x_star=xs),
        "dqgd_naive": lambda s: O.dqgd(grad, x0, B.naive_uniform(16)
                                       .roundtrip, alpha, s, x_star=xs),
        "dgd_def_nde_hadamard": lambda s: O.dgd_def(grad, x0, codec, alpha,
                                                    s, x_star=xs)}

    def timed(fn, steps, ctx=contextlib.nullcontext):
        for k in acc:
            acc[k] = 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx():
            fn(steps)
        torch.cuda.synchronize()
        return dict(acc, total_s=time.perf_counter() - t)

    default_slack = graph._CACHE_SLACK
    samples: dict = {}
    for r in range(ROUNDS):
        arms = (("slack", default_slack), ("always_free", 0))
        for arm, slack in arms if r % 2 == 0 else arms[::-1]:
            graph._CACHE_SLACK = slack
            for name, fn in runs.items():
                samples.setdefault((name, arm), []).append(timed(fn, STEPS))
        graph._CACHE_SLACK = default_slack
        for name, fn in runs.items():
            samples.setdefault((name, "eager"), []).append(
                timed(fn, STEPS, graph.eager))
    out = {"card": card, "rounds": ROUNDS, "steps": STEPS, "runs": {}}
    for (name, arm), got in samples.items():
        out["runs"].setdefault(name, {})[arm] = {
            k: statistics.median(g[k] for g in got) for k in got[0]}
    for name in ("gd", "dgd_def_nde_hadamard"):
        got = timed(runs[name], LONG_STEPS)
        out[f"{name}_{LONG_STEPS}_steps_per_s"] = LONG_STEPS / got["total_s"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
