"""The run of a train cell whose model `bench/train.py` does not build:
`bench/train_layer_types.py` (layers of mixed attention). Not a mode
itself.

`run(r, job)` goes through `bench.train.run`'s sequence with what the
job gives: the one step object of `make_train_step` of one worker, driven through the checked steps by the window's own call and
feed (the first eager, then replays of its graph), the window of whole
steps, a traced stretch of `TRACE_STEPS` steps where asked for, then,
after the program is freed, the job's reference of the checked steps
and the comparison (`bench.reference.train.gaps`). A traced run also logs
the model's obs counters of its first call. It uses
`bench.train`'s helpers and constants, and builds its weights, token
rows and first-gradient reads from the job's weights view of the
configuration (`job.cfg`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from bench import harness, tracing, weights
from bench import train as one
from bench.reference import train as reference


@dataclasses.dataclass
class Job:
    cfg: dict                   # the configuration as `bench.weights` reads it
    mcfg: object                # the program's ModelConfig
    pool: torch.Tensor          # (POOL, rows, seq + 1): the batches fed
    tokens_per_step: int        # tokens a step
    flops_per_step: float       # model FLOPs a step
    reference: Callable         # checked batches -> the reference's readings
    faults: dict = dataclasses.field(default_factory=dict)  # name -> wrap
    # (params, batch) before each checked step: what the reference follows
    observe: Optional[Callable] = None


def _faulty(step, fault, faults):
    if fault in faults:
        return faults[fault](step)
    return one._faulty(step, fault)


@contextlib.contextmanager
def _counted(on: bool):
    """With `on`, an obs session around the block, and the model's counters
    it gathered (`attn.*`, `moe.*`: host ints from the shapes, emitted
    where the Python runs: the eager first run, its remat recompute and
    the capture) logged as total over calls."""
    if not on:
        yield
        return
    from repro_torch import obs

    session = obs.enable(costs=False)
    try:
        yield
    finally:
        obs.disable()
        counters = session.summary()["counters"]
        harness.log("counters (total / calls): " + ", ".join(
            f"{name} {c['total']:.0f} / {c['count']}"
            for name, c in sorted(counters.items())
            if name.startswith(("attn.", "moe."))))


def run(r: harness.Run, job: Job) -> dict:
    """Set-up, window, optional traced stretch, reference: the pieces of
    the result line (see `bench.run`)."""
    from repro_torch.dist import step as step_lib
    from repro_torch.models.model import disable_tf32

    cfg, mix, dev = job.cfg, r.cell["mix"], r.device
    train = cfg["training"]
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)
    disable_tf32()
    opt = one.optimizer(train)
    gc = one.codec_config(mix)
    step = _faulty(step_lib.make_train_step(
        job.mcfg, opt, gc, None, clip_norm=train.get("clip_norm")),
        r.fault, job.faults)
    params = weights.make_params(cfg, r.seed, dev)
    opt_state = opt.init(params)
    ef = ({"blocks": {k: torch.zeros((1,) + tuple(v.shape), device=dev)
                      for k, v in params["blocks"].items()},
           **{k: torch.zeros((1,) + tuple(v.shape), device=dev)
              for k, v in params.items() if k != "blocks"}}
          if gc.uses_ef else {})
    pool = job.pool

    leaves = weights.leaves(params)
    got = {"losses": [], "leaves": weights.leaf_names(cfg)}
    t_first = time.perf_counter()
    for k in range(one.CHECKED_STEPS):
        if k == 1:
            before = [reference.sample(x)
                      for x in one._read(train, params, opt_state)]
        if job.observe is not None:
            job.observe(params, {"tokens": pool[k]})
        with _counted(r.trace and k == 0):
            params, opt_state, ef, m = step(params, opt_state, ef,
                                            {"tokens": pool[k]})
        got["losses"].append(float(m["loss"]))
        if k == 0:
            first_s = time.perf_counter() - t_first
            first_peak = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)
            got["first_grad"] = one._first_grad(cfg, r.seed, train, leaves,
                                                opt_state, dev)
        if k == 1:
            got["second_grad"] = [
                reference.second(reference.sample(x), b, train)
                for x, b in zip(one._read(train, params, opt_state), before)]
            del before
    got["change"] = [one._norm(p - weights.make_leaf(cfg, r.seed, i, dev))
                     for i, p in enumerate(leaves)]
    del m
    one._sync(dev)
    setup_s = time.perf_counter() - r.t_start
    harness.log(f"setup {setup_s:.3f} s: weights and the first call "
                f"{first_s:.3f} s, steps 2-{one.CHECKED_STEPS} and their "
                f"reads {setup_s - first_s - (t_first - r.t_start):.3f} s, "
                f"before them {t_first - r.t_start:.3f} s; the first call's "
                f"peak {first_peak} B; losses {got['losses']!r}")

    losses = []
    i = one.CHECKED_STEPS

    def one_step():
        nonlocal params, opt_state, ef, i
        with tracing.span("step.call"):
            params, opt_state, ef, m = step(params, opt_state, ef,
                                            {"tokens": pool[i % one.POOL]})
        with tracing.span("step.read_loss"):
            losses.append(float(m["loss"]))
        i += 1

    t0 = time.perf_counter()
    while True:
        one_step()
        window_s = time.perf_counter() - t0
        if window_s >= r.seconds:
            break
    steps = len(losses)
    out = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "attempted": steps,
           "failed": sum(not math.isfinite(x) for x in losses),
           "metrics": {"train_tokens_per_s": steps * job.tokens_per_step
                       / window_s, "setup_s": setup_s}}
    if r.trace:
        traced_from = len(losses)

        def traced():
            for _ in range(one.TRACE_STEPS):
                one_step()
            one._sync(dev)

        window, ops, gaps = tracing.record(traced, dev)
        out["trace"] = tracing.Trace(
            cell=dict(r.cell, cfg=cfg), steps=len(losses) - traced_from,
            window_s=window, ops=ops, gaps=gaps,
            host={"step_s": window_s / steps,
                  "flops_per_step": job.flops_per_step})
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    # free the program, then the reference follows the checked steps
    del step, params, opt_state, ef, leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_ref = time.perf_counter()
    want = job.reference(pool[:one.CHECKED_STEPS])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    harness.log(f"reference {time.perf_counter() - t_ref:.3f} s, peak "
                f"{peak} B")
    gaps_ = reference.gaps(got, want)
    out["gaps"] = gaps_
    out["correct"], out["checks"] = harness.judge(gaps_, r.cell["limits"])
    if want.get("routing_faults"):      # discrete decisions past a near-tie
        out["correct"] = False
    return out
