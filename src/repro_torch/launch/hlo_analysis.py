"""Roofline terms of a step on the H100, from analytic numerators (port of
`repro.launch.hlo_analysis`).

The reference reads its numerators from the compiled, partitioned XLA
program (`hlo_static`: flops, bytes accessed and the collectives of the
HLO text). PyTorch compiles no such program, so the port counts them from
what it runs, per device:

  flops        model flops ÷ devices (`model_flops_train`: 6·N_active·D;
               `model_flops_decode`: 2·N_active per token);
  bytes        a rank's argument bytes, from the StateSpecs at
               `local_shape` (`launch.dryrun.argument_bytes`);
  collectives  the bytes a rank puts into the step's collectives: the
               decode step's tensor-parallel plan (a `sharding.DryShard`
               census of `decode_step` on meta tensors), the train step's
               consensus (`gradcomp.wire_bytes_tree`) and its gather of
               the params over "model".

Peaks: `kernels/cost.py`, the H100 SXM data sheet (HBM3 3.35 TB/s, f32
67 TFLOP/s with TF32 off, NVLink 450 GB/s per direction). The collective
term divides by one card's NVLink rate, the reference's convention for
per-device bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels import cost
from repro_torch.models.model import active_param_count


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None

    def table_row(self) -> dict:
        return dataclasses.asdict(self)


def wire_bytes(kind: str, operand: float, group: int) -> float:
    """Ring-model bytes crossing links for `operand` bytes a rank puts in
    over a group of `group` ranks (the reference's conventions)."""
    if group <= 1:
        return 0.0
    if kind == "all-gather":
        return operand * (group - 1)
    if kind == "all-reduce":
        return 2.0 * operand * (group - 1) / group
    return operand * (group - 1) / group          # all-to-all


def roofline_terms(model_flops: float, num_devices: int,
                   hbm_bytes_per_device: float,
                   collectives: dict) -> Roofline:
    """`collectives`: {kind: {"count", "operand_bytes", "wire_bytes"}}
    per device (`launch.dryrun`)."""
    flops = model_flops / num_devices
    coll = float(sum(v["operand_bytes"] for v in collectives.values()))
    wire = float(sum(v["wire_bytes"] for v in collectives.values()))
    terms = {"compute": flops / cost.PEAK_F32_FLOP_S,
             "memory": hbm_bytes_per_device / cost.PEAK_BYTES_S,
             "collective": coll / cost.NVLINK_BYTES_S}
    return Roofline(
        flops_per_device=flops, hbm_bytes_per_device=hbm_bytes_per_device,
        collective_bytes_per_device=coll, collective_wire_bytes=wire,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], dominant=max(terms, key=terms.get),
        model_flops=model_flops)


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D (fwd+bwd) — the roofline's MODEL_FLOPS."""
    return 6.0 * active_param_count(cfg) * tokens


def model_flops_decode(cfg, batch: int) -> float:
    """2·N_active per generated token (fwd only)."""
    return 2.0 * active_param_count(cfg) * batch
