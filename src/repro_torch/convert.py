"""Carry state and frames between the JAX package and the port as numpy.

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
from repro_torch.core import frames as frames_lib


def from_numpy(tree, device="cpu"):
    """numpy tree (params, optimizer state or EF) → tree of torch tensors.
    Scalars such as the optimizer's step become 0-d tensors."""
    return tree_lib.map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)



def frame_from_numpy(kind: str, arrays: dict, device="cpu"):
    """A frame of the JAX package, as numpy arrays, → the port's frame on
    `device`: kind 'dense' takes {"S"} (a Haar or sub-Gaussian frame),
    kind 'hadamard' {"signs", "rows"}."""
    if kind == "dense":
        return frames_lib.DenseFrame(S=_tensor(arrays["S"], np.float32,
                                               device))
    if kind == "hadamard":
        return frames_lib.HadamardFrame(
            signs=_tensor(arrays["signs"], np.int8, device),
            rows=_tensor(arrays["rows"], np.int32, device))
    raise ValueError(f"unknown frame kind {kind!r}; want 'dense' or "
                     "'hadamard'")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)
