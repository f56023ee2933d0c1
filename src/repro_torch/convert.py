"""Carry state between the JAX package and the port as numpy trees.

The port keeps the reference's tree layouts (stacked `(L, …)` block
weights, `{"mu", "nu", "step"}` AdamW state, `(m, …)` EF leaves), so a
conversion is leafwise: `from_numpy(jax_tree_as_numpy)` gives the port's
tree. Nothing here imports JAX; the caller turns JAX arrays into numpy
arrays first (`np.asarray`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib


def from_numpy(tree, device="cpu"):
    """numpy tree (params, optimizer state or EF) → tree of torch tensors.
    Scalars such as the optimizer's step become 0-d tensors."""
    return tree_lib.map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)

