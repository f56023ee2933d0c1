"""Codec stages: the NDSC leaf codec (port of `repro.codecs.stages.NdscLeaf`).

Only the NDSC leaf (hadamard + chunk_drop + uniform/dithered + int32) is
ported; it delegates to `repro_torch.dist.gradcomp`, as the reference
delegates to `repro.dist.gradcomp`, which keeps its payloads identical to
the gradcomp path and its `encode_ef` on the fused kernel. RATQ,
sparsify-then-embed, `Pipeline` and the registry are not ported yet
(ROADMAP, queue 1 item 6).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import gradcomp as G


@dataclasses.dataclass(frozen=True)
class NdscLeaf:
    """hadamard + (chunk_drop) + uniform/dithered + int32, delegating to
    `gradcomp`."""

    cfg: G.GradCompConfig

    @property
    def effective_bits(self) -> float:
        return self.cfg.effective_bits

    def encode(self, x, leaf_idx, round_idx=0, key=None):
        return G.encode_leaf(x, leaf_idx, self.cfg, round_idx, key=key)

    def encode_ef(self, x, leaf_idx, round_idx=0, key=None,
                  residual_dtype=None):
        return G.encode_leaf_ef(x, leaf_idx, self.cfg, round_idx, key=key,
                                residual_dtype=residual_dtype)

    def decode(self, payload, leaf_idx, size, shape, dtype, extra_lead=0):
        return G.decode_leaf(payload, leaf_idx, size, shape, dtype, self.cfg,
                             extra_lead=extra_lead)

    def wire_bits(self, size: int) -> float:
        template = torch.empty(int(size), device="meta")
        return G.wire_bytes_tree([template], self.cfg)["payload_bytes"] * 8.0

    def wire_bytes(self, payload, size: int) -> float:
        return G.wire_bytes_payload(payload, self.cfg)


def ndsc_leaf(cfg: G.GradCompConfig) -> NdscLeaf:
    """The NDSC stage codec for an explicit GradCompConfig (what
    `repro_torch.dist.step` routes its consensus encode/decode through)."""
    return NdscLeaf(cfg)
