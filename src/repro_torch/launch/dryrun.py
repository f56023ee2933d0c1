"""Dry-run of the production meshes on meta tensors (port of
`repro.launch.dryrun`).

For each (arch × shape) on the 16×16 ("data", "model") or 2×16×16 ("pod",
"data", "model") layout (`launch.mesh.make_production_mesh`), with no
process started and nothing allocated on any device:
  1. the placement of every input as StateSpecs: `train_state_specs` (or
     `zero_state_specs`) and the batch's `batch_specs` for a train shape,
     `serve_state_specs` for a decode shape;
  2. bytes per device: those arguments at `local_shape`;
  3. the collectives one device puts in per step: the decode step's
     tensor-parallel plan, counted by running `decode_step` on meta
     tensors of one rank's shapes through a `sharding.DryShard`; the
     train step's consensus (`gradcomp.wire_bytes_tree`) and its gather
     of the params over "model";
  4. the roofline terms with the H100's peaks (`launch.hlo_analysis`).

The reference lowers and compiles each step with XLA and reads its memory
analysis, cost analysis and partitioned HLO; the port has no compiled
program, so the record's `compile_s`, `xla_cost` and the memory analysis's
output, temp and code sizes are null. A prefill shape is SKIP: the port's
prefill (`models.decode.prefill`) runs on one worker, with no
tensor-parallel forward to place on a mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --sweep --json-out results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.dist import sharding
from repro_torch.dist import step as step_lib
from repro_torch.dist.gradcomp import GradCompConfig, wire_bytes_tree
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode as decode_lib
from repro_torch.optimizer.optim import adamw, sgd

_KIND_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "all_to_all": "all-to-all"}


def make_opt(name: str):
    """The dry-run's optimizer, as the reference's."""
    return (adamw(1e-4, weight_decay=0.1) if name == "adamw"
            else sgd(1e-2, momentum=0.9))


def _batch_specs(cfg, shape, mesh) -> dict:
    batch = input_specs(cfg, shape)
    return tree_lib.map(
        lambda x, e: step_lib.StateSpec(tuple(x.shape), x.dtype, e), batch,
        sharding.batch_specs(batch, mesh))


def argument_specs(cfg, shape, mesh, gc: GradCompConfig, opt) -> tuple:
    """The step's arguments as StateSpec trees: (params, opt_state, ef,
    batch) for a train shape, (params, state, tokens) for a decode
    shape."""
    if shape.mode == "train":
        specs_fn = (step_lib.zero_state_specs
                    if gc.strategy == "alltoall_zero1"
                    else step_lib.train_state_specs)
        return specs_fn(cfg, opt, gc, mesh) + (_batch_specs(cfg, shape,
                                                             mesh),)
    if shape.mode == "decode":
        return step_lib.serve_state_specs(cfg, mesh, shape.global_batch,
                                          shape.seq_len)
    raise ValueError(f"no {shape.mode} step on a mesh in the port")


def argument_bytes(cfg, shape, mesh, gc: GradCompConfig, opt) -> int:
    """Bytes of the step's arguments one device holds (`argument_specs` at
    `local_shape`)."""
    return sum(s.nbytes(mesh) for s in tree_lib.leaves(
        argument_specs(cfg, shape, mesh, gc, opt)))


def _meta_local(specs, mesh):
    return tree_lib.map(lambda s: torch.empty(
        s.local_shape(mesh), dtype=s.dtype, device="meta"), specs)


def _entry(out: dict, kind: str, nbytes: int, calls: int,
           group: int) -> None:
    """Add `calls` collectives of `kind` putting in `nbytes` in all over a
    group of `group` ranks to the census `out` (none on one rank)."""
    if group > 1 and calls:
        k = out.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                  "wire_bytes": 0.0})
        k["count"] += calls
        k["operand_bytes"] += nbytes
        k["wire_bytes"] += hlo_analysis.wire_bytes(kind, nbytes, group)


def decode_census(cfg, shape, mesh) -> dict:
    """{kind: {"count", "operand_bytes", "wire_bytes"}}: the collectives
    one rank's decode step puts in, counted by running `decode_step` on
    meta tensors of that rank's shapes through a `DryShard` (with an MoE
    config's gather of the routing over the data axes when the batch is
    split over them)."""
    model = sharding.model_axis_size(mesh)
    params, state, tokens = step_lib.serve_state_specs(
        cfg, mesh, shape.global_batch, shape.seq_len)
    split = (cfg.num_experts > 0
             and bool(sharding.data_axes_for(shape.global_batch, mesh)))
    dry = sharding.DryShard(step_lib.meta_params(cfg), model,
                            batch_size=sharding.num_workers(mesh) if split
                            else 1)
    local = _meta_local(state, mesh)
    decode_lib.decode_step(
        cfg, _meta_local(params, mesh),
        decode_lib.DecodeState(caches=local.caches, pos=local.pos),
        torch.empty(tokens.local_shape(mesh), dtype=torch.int32,
                    device="meta"), tp=dry if model > 1 or split else None)
    out: dict = {}
    for (kind, group), v in dry.census.items():
        _entry(out, _KIND_NAMES[kind], v["bytes"], v["calls"], group)
    return out


def train_census(cfg, mesh, gc: GradCompConfig, opt) -> dict:
    """{kind: {"count", "operand_bytes", "wire_bytes"}}: one rank's
    collectives per train step: the loss mean (and ZeRO-1's grad norm),
    the consensus (`wire_bytes_tree` over the whole params), ZeRO-1's
    gather of the owned rows, and at model > 1 the gather of the params
    and their optimizer state over "model"."""
    m = sharding.num_workers(mesh)
    model = sharding.model_axis_size(mesh)
    wire = wire_bytes_tree(step_lib.meta_params(cfg), gc, m)
    out: dict = {}

    n_leaves = len(tree_lib.leaves(step_lib.meta_params(cfg)))
    _entry(out, "all-reduce", 4, 1, m)                        # the loss
    if gc.strategy in ("psum", "psum_decoded"):
        _entry(out, "all-reduce", wire["f32_bytes"], n_leaves, m)
    elif gc.strategy == "allgather_packed":
        _entry(out, "all-gather", wire["payload_bytes"], n_leaves, m)
    else:                                                     # ZeRO-1
        owned = step_lib.zero_state_specs(cfg, opt, gc, mesh)[0]
        _entry(out, "all-to-all", wire["payload_bytes"], n_leaves, m)
        _entry(out, "all-gather", sum(s.nbytes(mesh) for s in
                                      tree_lib.leaves(owned)), n_leaves, m)
        _entry(out, "all-reduce", 4, 1, m)                    # grad norm
    if model > 1 and gc.strategy != "alltoall_zero1":
        params, opt_state, _ = step_lib.train_state_specs(cfg, opt, gc, mesh)
        split = [s for s in tree_lib.leaves((params, opt_state))
                 if s.entries and "model" in s.entries]
        _entry(out, "all-gather", sum(s.nbytes(mesh) for s in split),
               len(split), model)
    return out


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              gc: GradCompConfig, opt_name: str = "adamw",
              verbose: bool = True, kv_quant: int | None = None) -> dict:
    cfg = configs.get(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant_bits=kv_quant)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "strategy": gc.strategy, "bits": gc.bits}
    ok, reason = applicable(cfg, shape)
    if ok and shape.mode == "prefill":
        ok, reason = False, ("no tensor-parallel prefill in the port: "
                             "models.decode.prefill runs on one worker")
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        opt = make_opt(opt_name)
        args = argument_bytes(cfg, shape, mesh, gc, opt)
        if shape.mode == "train":
            coll = train_census(cfg, mesh, gc, opt)
            flops = hlo_analysis.model_flops_train(
                cfg, shape.global_batch * shape.seq_len)
        else:
            coll = decode_census(cfg, shape, mesh)
            flops = hlo_analysis.model_flops_decode(cfg, shape.global_batch)
        roof = hlo_analysis.roofline_terms(flops, mesh.size, float(args),
                                           coll)
        rec.update(
            xla_cost=None, status="OK", compile_s=None,
            analysis_s=round(time.time() - t0, 3), num_devices=mesh.size,
            memory={"argument_size_in_bytes": args,
                    "output_size_in_bytes": None,
                    "temp_size_in_bytes": None,
                    "generated_code_size_in_bytes": None},
            bytes_per_device=args, roofline=roof.table_row(),
            collectives={k: {"count": v["count"],
                             "operand_bytes": v["operand_bytes"]}
                         for k, v in coll.items()})
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] OK "
                  f"({rec['analysis_s']}s on meta tensors)")
            print(f"  memory/device: args={args / 2**30:.2f}GiB")
            print(f"  flops/device={roof.flops_per_device:.3e} "
                  f"hbm_bytes={roof.hbm_bytes_per_device:.3e} "
                  f"coll_bytes={roof.collective_bytes_per_device:.3e}")
            print(f"  terms (H100): compute={roof.compute_s * 1e3:.2f}ms "
                  f"memory={roof.memory_s * 1e3:.2f}ms "
                  f"collective={roof.collective_s * 1e3:.2f}ms "
                  f"→ {roof.dominant}-bound")
            print(f"  collectives: {rec['collectives']}")
    except Exception as e:  # noqa: BLE001 — a failed combo is a data point
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   analysis_s=round(time.time() - t0, 3))
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAIL: "
                  f"{rec['error']}")
            traceback.print_exc()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="all (arch × shape) on the selected mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--bits", type=int, default=4, choices=(1, 2, 4, 8))
    ap.add_argument("--strategy", default="allgather_packed",
                    choices=("psum", "psum_decoded", "allgather_packed",
                             "alltoall_zero1"))
    ap.add_argument("--opt", default="adamw", choices=("adamw", "sgd"))
    ap.add_argument("--kv-quant", type=int, default=None, choices=(4, 8),
                    help="NDSC-packed KV cache bits for decode shapes")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    gc = GradCompConfig(bits=args.bits, strategy=args.strategy)
    records = []
    if args.sweep:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for arch in configs.ARCH_NAMES:
            for shape_name in SHAPES:
                for mp in meshes:
                    records.append(run_combo(arch, shape_name, mp, gc,
                                             args.opt, kv_quant=args.kv_quant))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --sweep)")
        records.append(run_combo(args.arch, args.shape, args.multi_pod, gc,
                                 args.opt, kv_quant=args.kv_quant))

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records → {args.json_out}")
    failures = [r for r in records if r["status"] == "FAIL"]
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
