"""Train cells of a model whose layers differ in their attention: sliding
and full layers in one stack, each layer type with its own RoPE table
(`layer_types`, `rope_parameters`; Mellum2-12B-A2.5B). The captured
`dist.step` of one data-parallel worker, fed token rows from the seed.

The run is `bench.train`'s sequence (`bench.train_loop`): set-up through
the checked steps by the window's own call, the window, the traced
stretch, then the plain reference (`bench.reference.layer_types`, its
steps by `bench.reference.steps`) after the program is freed. Before each
checked step the program's model runs the batch once more, eagerly and
without gradients, to read its expert choices, which the reference
follows and checks (`followed`): a run whose first-step choices differ
from the reference's past a near-tie, whose kept assignments differ
from the capacity rule's, or that leads the reference to other top-k
sets than its own on more (token, layer) pairs of a step than the cell's
`routing_flips` limits allow, is not correct. The
configuration file keeps the published keys; `weights_cfg` is the view
`bench.weights` and the reference read (the experts' width under
`intermediate_size`, their count under `num_local_experts`).

The traffic file is `bench.train`'s: the consensus (`strategy`, `bits`,
`chunk`, `error_feedback`, `codec_seed`) and `batch` rows of `seq`
tokens a step.
"""
from __future__ import annotations

import torch

from bench import harness, train_loop, weights
from bench import train as one
from bench.frozen import flops_layer_types as flops
from bench.reference import layer_types as ref_model
from bench.reference import model as ref_base
from bench.reference import steps as ref_steps
from bench.reference import train as reference

# a one-worker cell's faults: its state left unchanged (reads 1 by
# construction), each row's second half left out (one row cannot be
# halved by rows), and the replays alone on weights rounded to bfloat16
FAULTS = ("frozen_state", "half_positions", "replay_bf16")


def weights_cfg(cfg: dict) -> dict:
    """The configuration as `bench.weights` reads it: the published
    `intermediate_size` (7,168) is a dense layer's width, which this model
    has none of; its experts are `moe_intermediate_size` wide and
    `num_experts` many."""
    return dict(cfg, intermediate_size=cfg["moe_intermediate_size"],
                num_local_experts=cfg["num_experts"])


def _rope_spec(spec: dict):
    from repro_torch.models.model import RopeSpec

    theta = float(spec["rope_theta"])
    if spec.get("rope_type", "default") == "default":
        return RopeSpec(theta)
    return RopeSpec(
        theta, factor=float(spec["factor"]),
        original_max_position=int(spec["original_max_position_embeddings"]),
        beta_fast=float(spec.get("beta_fast", 32)),
        beta_slow=float(spec.get("beta_slow", 1)),
        attention_factor=spec.get("attention_factor"))


def model_config(cfg: dict):
    """The program's ModelConfig for a configuration file: the first
    `num_hidden_layers` of its `layer_types`, a RopeSpec a layer type."""
    from repro_torch.models.model import ModelConfig

    kinds = tuple(ref_model.layer_kinds(cfg))
    specs = cfg["rope_parameters"]
    rope = tuple((kind, _rope_spec(specs[f"{kind}_attention"]))
                 for kind in sorted(set(kinds)))
    return ModelConfig(
        name=cfg["name"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], block="attn_moe", layer_types=kinds,
        window=cfg["sliding_window"], rope_by_type=rope,
        rope_theta=float(rope[0][1].theta),
        num_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        capacity_factor=cfg["capacity_factor"],
        moe_aux_coeff=cfg.get("router_aux_loss_coef", 0.0),
        norm_eps=cfg["rms_norm_eps"], dtype="float32",
        vocab_pad_multiple=weights.VOCAB_PAD)


def _half_positions(step):
    def run(params, opt_state, ef, batch):
        keep = (batch["tokens"].shape[1] - 1) // 2 + 1
        return step(params, opt_state, ef,
                    {"tokens": batch["tokens"][:, :keep]})
    return run


def program_routes(mcfg, params, batch) -> dict:
    """The program's expert choices and kept assignments by layer on one
    batch, {layer: (choice (T, k), kept (T·k,))}: its model's forward,
    eager and without gradients (the captured step's ops on the same
    weights), with `moe.route` observed; and that forward's loss."""
    from repro_torch.models import model as port
    from repro_torch.models import moe as port_moe

    seen = []
    route = port_moe.route

    def observed(*args, **kwargs):
        out = route(*args, **kwargs)
        seen.append((out["expert_idx"].clone(), out["keep"].clone()))
        return out

    port_moe.route = observed
    try:
        with torch.no_grad():
            loss = port.loss_fn(mcfg, params, batch)
    finally:
        port_moe.route = route
    return dict(enumerate(seen)), float(loss)


def followed(cfg, mix, seed, batches, device, matmul, routes,
             flip_limits=None) -> dict:
    """The reference's readings of the checked steps, each step's layers
    following `routes[step]` (the program's choices, or a control run's)
    and checking them (`ref_model.Routes`). `routing_flips` counts by
    step the followed top-k sets other than the reference's own;
    `routing_faults` the differences past a near-tie, and each step whose
    count exceeds its entry of `flip_limits` (None where unchecked)."""
    steps, tally = iter(routes), []

    def loss(cfg_, params, tokens, matmul_):
        tally.append(ref_model.Routes(next(steps), strict=not tally))
        return ref_model.loss(cfg_, params, tokens, matmul_, tally[-1])

    want = ref_steps.run(cfg, mix, seed, batches, device, loss, matmul)
    flips = [sum(t.flips.values()) for t in tally]
    over = [i for i, (n, most) in enumerate(zip(flips, flip_limits or ()))
            if most is not None and n > most]
    want["routing_flips"] = flips
    want["routing_faults"] = (sum(sum(t.faults.values()) for t in tally)
                              + len(over))
    harness.log(f"routing: other top-k sets followed a step {flips} "
                f"(limits {flip_limits}; steps past them {over}), faults "
                f"{want['routing_faults']}")
    return want


def flip_limits(cell: dict):
    """The cell's limits on followed top-k sets by checked step
    (`routing_flips` of `bench/workloads/<cell>.json`), or None."""
    path = harness.ROOT / "bench" / "workloads" / f"{cell['name']}.json"
    if not path.exists():
        return None
    return harness.load_json(path).get("routing_flips", {}).get("limits")


def _job(cell: dict, seed: int, device):
    cfg, mix = weights_cfg(cell["cfg"]), cell["mix"]
    tokens = mix["batch"] * mix["seq"]
    mcfg = model_config(cfg)
    routes = []

    def observe(params, batch):
        layers, loss = program_routes(mcfg, params, batch)
        routes.append(layers)
        harness.log(f"routing read from the program's forward, loss "
                    f"{loss!r}")

    return train_loop.Job(
        cfg=cfg, mcfg=mcfg,
        pool=weights.token_rows(cfg, seed, one.POOL, mix["batch"],
                                mix["seq"], device),
        tokens_per_step=tokens,
        flops_per_step=flops.train_flops_per_token(cfg, mix["seq"]) * tokens,
        reference=lambda batches: followed(cfg, mix, seed, batches, device,
                                           ref_base._f32_matmul, routes,
                                           flip_limits(cell)),
        faults={"half_positions": _half_positions}, observe=observe)


def run(r: harness.Run) -> dict:
    return train_loop.run(r, _job(r.cell, r.seed, r.device))


def control_gaps(cell: dict, seed: int, device) -> dict:
    """The reference in the program's place with its products in TF32 (on
    the card by `allow_tf32`, on the CPU by rounding their operands),
    against the reference, on the cell's checked steps."""
    from bench import calibrate

    cfg, mix = weights_cfg(cell["cfg"]), cell["mix"]
    batches = weights.token_rows(cfg, seed, one.CHECKED_STEPS, mix["batch"],
                                 mix["seq"], device)
    tally = []

    def recorded(cfg_, params, tokens, matmul_):
        tally.append(ref_model.Routes())
        return ref_model.loss(cfg_, params, tokens, matmul_, tally[-1])

    matmul = (ref_base._f32_matmul if device.type == "cuda"
              else ref_base.tf32_matmul)
    with calibrate.tf32(device):
        got = ref_steps.run(cfg, mix, seed, batches, device, recorded, matmul)
    want = followed(cfg, mix, seed, batches, device, ref_base._f32_matmul,
                    [t.recorded for t in tally])
    return reference.gaps(got, want)
