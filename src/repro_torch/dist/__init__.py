"""Distributed compressed consensus (port of `repro.dist`).

  sharding — placement rules, the workers of a `torch.distributed` group,
             and the collectives
  gradcomp — chunked NDSC gradient codec + wire audit (the paper's E/D pair)
  step     — train / ZeRO-1 / serve step factories over the workers
  zero     — ZeRO-1 owned layout + compressed all-to-all reduce-scatter
"""
from repro_torch.dist import gradcomp, sharding, step, zero
from repro_torch.dist.gradcomp import (GradCompConfig, compress_tree,
                                       decode_leaf, decode_payload,
                                       encode_leaf, wire_bytes_tree)
from repro_torch.dist.sharding import (batch_specs, data_axes_for,
                                       param_spec, param_specs, shardable)
