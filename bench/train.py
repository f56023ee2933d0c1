"""Train cells: the captured `dist.step` of one data-parallel worker
(`repro_torch.dist.step.make_train_step`), fed token rows from the seed.

Set-up builds the one step object with its weights, optimizer state and
EF (the weights made by `bench.weights`, handed to the program as its
initial parameters), drives it through its first steps (the first call
runs eagerly and captures the step's CUDA graph, the next ones replay
it), and reads from its state what the correctness check compares: the
first loss and gradient from the eager first call, the second gradient
from the first replay, the weights' change after the third step. The
same object then runs the window. A traced run adds a profiled stretch of
`TRACE_STEPS` steps after the window. Once the window has closed and the
peak memory is read, the program's state is freed and the reference
(`bench.reference.train`) follows the checked steps from the same seed.

The traffic file sets the consensus: `strategy` (`allgather_packed`, the
paper's packed all-gather through the NDSC codec, or `psum`, the exact
mean), `bits`, `chunk`, `error_feedback`, `codec_seed`; and the shape:
`batch` rows of `seq` tokens a step.
"""
from __future__ import annotations

import math
import time

import torch

from bench import harness, tracing, weights
from bench.frozen import flops
from bench.reference import train as reference

CHECKED_STEPS = 3       # the steps the reference follows
POOL = 64               # distinct batches the window cycles through
TRACE_STEPS = 8


def model_config(cfg: dict):
    """The program's ModelConfig for a configuration file."""
    from repro_torch.models.model import ModelConfig

    experts = cfg.get("num_local_experts", 0)
    window = cfg.get("sliding_window")
    return ModelConfig(
        name=cfg["name"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim"),
        block="attn_moe" if experts else "attn_mlp",
        attention_kind="sliding" if window else "full",
        window=window or 4096, rope_theta=float(cfg["rope_theta"]),
        num_experts=experts, top_k=cfg.get("num_experts_per_tok", 2),
        capacity_factor=cfg.get("capacity_factor", 1.25),
        moe_aux_coeff=cfg.get("router_aux_loss_coef", 0.0),
        norm_eps=cfg["rms_norm_eps"], dtype="float32",
        vocab_pad_multiple=weights.VOCAB_PAD)


def optimizer(train: dict):
    from repro_torch.optimizer import optim

    if train["optimizer"] == "sgd":
        return optim.sgd(train["lr"])
    return optim.adamw(train["lr"], b1=train["b1"], b2=train["b2"],
                       eps=train["eps"], weight_decay=train["weight_decay"])


def codec_config(mix: dict):
    from repro_torch.dist.gradcomp import GradCompConfig

    if mix["strategy"] == "psum":
        return GradCompConfig(strategy="psum", error_feedback=False)
    return GradCompConfig(bits=mix["bits"], chunk=mix["chunk"],
                          strategy=mix["strategy"],
                          error_feedback=mix["error_feedback"],
                          seed=mix.get("codec_seed", 0))


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(step, fault):
    """The step broken as the correctness test plants faults."""
    if fault is None:
        return step

    def frozen_state(params, opt_state, ef, batch):
        state = [x.clone() for x in _state_leaves(params, opt_state, ef)]
        out = step(params, opt_state, ef, batch)
        for x, old in zip(_state_leaves(params, opt_state, ef), state):
            x.copy_(old)
        return out

    def half_batch(params, opt_state, ef, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(params, opt_state, ef, {"tokens": batch["tokens"][:rows]})

    calls = [0]

    def replay_bf16(params, opt_state, ef, batch):
        if calls[0]:
            for w in _state_leaves(params):
                w.copy_(w.to(torch.bfloat16))
        calls[0] += 1
        return step(params, opt_state, ef, batch)

    return {"frozen_state": frozen_state, "half_batch": half_batch,
            "replay_bf16": replay_bf16}[fault]


# the faults a one-worker train cell can have (no exchange between
# chips): its state left unchanged (reads 1 by construction), half of
# the batch left out, and the replayed steps alone on weights rounded to
# bfloat16 (a precision lost where the captured graph replays, which the
# first, eager step does not show)
FAULTS = ("frozen_state", "half_batch", "replay_bf16")


def _state_leaves(*trees) -> list:
    from repro_torch import tree as tree_lib

    return [x for t in trees for x in tree_lib.leaves(t)]


def run(r: harness.Run) -> dict:
    """Set-up, window, optional traced stretch, reference: the pieces of
    the result line (see `bench.run`)."""
    from repro_torch.dist import step as step_lib
    from repro_torch.models.model import disable_tf32

    cfg, mix, dev = r.cell["cfg"], r.cell["mix"], r.device
    train = cfg["training"]
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)     # a calibration's runs
    disable_tf32()
    mcfg = model_config(cfg)
    opt = optimizer(train)
    gc = codec_config(mix)
    step = _faulty(step_lib.make_train_step(
        mcfg, opt, gc, None, clip_norm=train.get("clip_norm")), r.fault)
    params = weights.make_params(cfg, r.seed, dev)
    opt_state = opt.init(params)
    ef = ({"blocks": {k: torch.zeros((1,) + tuple(v.shape), device=dev)
                      for k, v in params["blocks"].items()},
           **{k: torch.zeros((1,) + tuple(v.shape), device=dev)
              for k, v in params.items() if k != "blocks"}}
          if gc.uses_ef else {})
    pool = weights.token_rows(cfg, r.seed, POOL, mix["batch"], mix["seq"],
                              dev)
    tokens_per_step = mix["batch"] * mix["seq"]

    # the checked steps, through the window's own call and feed
    leaves = weights.leaves(params)
    got = {"losses": [], "leaves": weights.leaf_names(cfg)}
    t_first = time.perf_counter()
    for k in range(CHECKED_STEPS):
        if k == 1:
            before = [reference.sample(x) for x in _read(train, params,
                                                         opt_state)]
        params, opt_state, ef, m = step(params, opt_state, ef,
                                        {"tokens": pool[k]})
        got["losses"].append(float(m["loss"]))
        if k == 0:
            first_s = time.perf_counter() - t_first
            first_peak = (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)
            got["first_grad"] = _first_grad(cfg, r.seed, train, leaves,
                                            opt_state, dev)
        if k == 1:
            got["second_grad"] = [
                reference.second(reference.sample(x), b, train)
                for x, b in zip(_read(train, params, opt_state), before)]
            del before
    got["change"] = [_norm(p - weights.make_leaf(cfg, r.seed, i, dev))
                     for i, p in enumerate(leaves)]
    del m
    _sync(dev)
    setup_s = time.perf_counter() - r.t_start
    harness.log(f"setup {setup_s:.3f} s: weights and the first call "
                f"{first_s:.3f} s, steps 2-{CHECKED_STEPS} and their reads "
                f"{setup_s - first_s - (t_first - r.t_start):.3f} s, "
                f"before them {t_first - r.t_start:.3f} s; the first "
                f"call's peak {first_peak} B")

    # the window: whole steps until --seconds have passed
    losses = []
    i = CHECKED_STEPS

    def one_step():
        nonlocal params, opt_state, ef, i
        with tracing.span("step.call"):
            params, opt_state, ef, m = step(params, opt_state, ef,
                                            {"tokens": pool[i % POOL]})
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
           "metrics": {"train_tokens_per_s": steps * tokens_per_step
                       / window_s, "setup_s": setup_s}}
    if r.trace:
        traced_from = len(losses)

        def traced():
            for _ in range(TRACE_STEPS):
                one_step()
            _sync(dev)

        window, ops, gaps = tracing.record(traced, dev)
        out["trace"] = tracing.Trace(
            cell=r.cell, steps=len(losses) - traced_from, window_s=window,
            ops=ops, gaps=gaps,
            host={"step_s": window_s / steps,
                  "flops_per_step": flops.train_flops_per_token(
                      cfg, mix["seq"]) * tokens_per_step})
    # the process's peak, the first (eager) step's included
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    # free the program, then the reference follows the checked steps
    del step, params, opt_state, ef, leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_ref = time.perf_counter()
    want = reference.run(cfg, mix, r.seed, pool[:CHECKED_STEPS], dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    harness.log(f"reference {time.perf_counter() - t_ref:.3f} s, peak "
                f"{peak} B")
    gaps_ = reference.gaps(got, want)
    out["gaps"] = gaps_
    out["correct"], out["checks"] = harness.judge(gaps_, r.cell["limits"])
    return out


def _read(train, params, opt_state) -> list:
    """The leaves the second step's gradient is read from: AdamW's first
    moment, or SGD's weights (`reference.second`)."""
    from repro_torch import tree as tree_lib

    if train["optimizer"] == "sgd":
        return weights.leaves(params)
    return tree_lib.leaves(opt_state["mu"])


def _first_grad(cfg, seed, train, leaves, opt_state, dev) -> list:
    """Each leaf's first gradient as the optimizer received it, read from
    its state after one step: AdamW's first moment over 1 − β1; for SGD
    the weights' change over the learning rate."""
    if train["optimizer"] == "sgd":
        return [_norm(p - weights.make_leaf(cfg, seed, i, dev)) / train["lr"]
                for i, p in enumerate(leaves)]
    from repro_torch import tree as tree_lib

    return [_norm(m) / (1.0 - train["b1"])
            for m in tree_lib.leaves(opt_state["mu"])]
