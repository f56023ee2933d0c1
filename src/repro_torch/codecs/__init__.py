"""repro_torch.codecs — the single home for compression (port of
`repro.codecs`).

Composable stages (`repro_torch.codecs.stages`) assemble into the
`TreeCodec` `(key, tree, budget)` convention (`repro_torch.codecs.base`);
the registry (`repro_torch.codecs.registry`) names the assembled pipelines:

    from repro_torch import codecs, random

    codec = codecs.make("ndsc", budget=1.5, chunk=128)
    wire  = codec.encode(random.key(0, device="cuda"), tree, round_idx)
    tree2 = codec.decode(wire, codec.meta(tree))

Wire codecs: `ndsc`, `ratq`, `sparsify_then_embed`, `dsc`, `identity`.
Simulation-only baselines: `sign`, `ternary`, `qsgd`, `naive`, `dither`,
`topk`, `randk`. A codec runs where its tensors are: on a CUDA tensor
through the CUDA kernels, on a CPU tensor through their plain versions.
"""
from repro_torch.codecs import base, registry, stages
from repro_torch.codecs.base import TreeCodec, TreeMeta, total_dims, tree_meta
from repro_torch.codecs.registry import (available, codec_spec,
                                         gradcomp_config_for_budget, make,
                                         register)
from repro_torch.codecs.stages import (Pack, Pipeline, Quantize, Sparsify,
                                       Transform)

__all__ = [
    "Pack", "Pipeline", "Quantize", "Sparsify", "Transform", "TreeCodec",
    "TreeMeta", "available", "base", "codec_spec",
    "gradcomp_config_for_budget", "make", "register", "registry", "stages",
    "total_dims", "tree_meta",
]
