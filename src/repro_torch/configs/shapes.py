"""The four assigned input shapes and their input specs (port of
`repro.configs.shapes`).

  train_4k     seq=4096     global_batch=256   (training: train_step)
  prefill_32k  seq=32768    global_batch=32    (inference prefill: forward)
  decode_32k   seq=32768    global_batch=128   (decode: serve_step, 1 token
                                                against a 32k cache)
  long_500k    seq=524288   global_batch=1     (long-context decode; only
                                                sub-quadratic archs)

Applicability rules, as in the reference:
  * encoder-only (hubert): no decode → decode_32k / long_500k skipped;
    prefill_32k is the encoder forward.
  * long_500k requires sub-quadratic sequence mixing: runs for sliding-window
    attention (hymba, mixtral) and recurrent state (xlstm); skipped for pure
    full-attention archs (phi3, yi, arctic, pixtral, llama3.2, mistral-large).

`input_specs` gives `meta` tensors, the port's stand-in for the reference's
`jax.ShapeDtypeStruct`: shape and dtype, no storage.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.mode == "decode":
        if not cfg.decode_supported:
            return False, ("encoder-only: no autoregressive decode"
                           if cfg.block == "encoder"
                           else cfg.decode_refusal)
        if shape.name == "long_500k" and not cfg.subquadratic:
            return False, ("pure full attention: O(s²) at 524k infeasible; "
                           "needs sliding-window/recurrent mixing")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: InputShape) -> dict:
    """`meta` tensors of a train/prefill batch (no allocation). Decode
    shapes use `repro_torch.dist.step.serve_state_specs` (the state IS the
    input there)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.frontend == "audio":
        return {"embeds": _meta((b, s, cfg.d_model), torch.float32),
                "targets": _meta((b, s), i32)}
    if cfg.frontend == "vision":
        text = s - cfg.num_patches
        if text <= 0:
            raise ValueError(f"seq {s} shorter than the {cfg.num_patches}"
                             " image patches")
        return {"image_embeds": _meta((b, cfg.num_patches, cfg.d_model),
                                      torch.float32),
                "tokens": _meta((b, text + 1), i32)}
    return {"tokens": _meta((b, s + 1), i32)}
