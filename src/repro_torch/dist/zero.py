"""ZeRO-1 layout and the compressed reduce-scatter (port of
`repro.dist.zero`).

Owned layout: each leaf is flattened, zero-padded so its chunk count is a
multiple of the worker count m, and reshaped (padded_chunks, chunk). Worker
w owns the contiguous row block [w·rows, (w+1)·rows): its optimizer state
exists only for those rows (the ZeRO-1 memory saving). Reconstruction is
`owned.reshape(-1)[:size].reshape(shape)`.

Consensus: every worker encodes ALL its gradient chunks with the shared
per-leaf frame (`repro_torch.dist.gradcomp`), then an all-to-all routes
each row block's m payloads to its owner, who decodes the stacked payloads
and takes their mean (`sharding.fold_mean`). The frames, the quantizer
and the mean's order are the all-gather consensus's, so the updated owned
rows are bitwise those of `allgather_packed`.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import gradcomp as G
from repro_torch.dist import sharding


def leaf_layout(shape, chunk: int, num_workers: int) -> tuple:
    """(padded_chunks, rows_per_owner) for a leaf of `shape`."""
    size = math.prod(shape) if shape else 1
    c = -(-size // chunk)
    padded = -(-c // num_workers) * num_workers
    return padded, padded // num_workers


def params_meta(params, gc: G.GradCompConfig, num_workers: int):
    """(spec, [(size, shape, dtype, (padded_chunks, rows)), ...]). Leaves
    may be tensors (on the `meta` device too)."""
    leaves, spec = tree_lib.flatten(params)
    infos = []
    for x in leaves:
        shape = tuple(x.shape)
        size = math.prod(shape) if shape else 1
        infos.append((size, shape, x.dtype,
                      leaf_layout(shape, gc.chunk, num_workers)))
    return spec, infos


def to_owned(leaf: torch.Tensor, chunk: int,
             num_workers: int) -> torch.Tensor:
    """Full leaf → f32 (padded_chunks, chunk) owned layout (global view)."""
    padded, _ = leaf_layout(tuple(leaf.shape), chunk, num_workers)
    flat = leaf.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, padded * chunk - flat.numel()))
    return flat.reshape(padded, chunk)


def from_owned(owned: torch.Tensor, size: int, shape, dtype) -> torch.Tensor:
    """Inverse of to_owned (drops the zero padding)."""
    return owned.reshape(-1)[:size].reshape(shape).to(dtype)


def valid_mask(size: int, padded_chunks: int, chunk: int,
               device=None) -> torch.Tensor:
    """f32 (padded_chunks, chunk): 1 on real coordinates, 0 on padding."""
    pos = (torch.arange(padded_chunks, device=device)[:, None] * chunk
           + torch.arange(chunk, device=device)[None, :])
    return (pos < size).to(torch.float32)


def compressed_reduce_scatter(u: torch.Tensor, leaf_idx: int,
                              gc: G.GradCompConfig, group, num_workers: int,
                              round_idx: int = 0,
                              logical_chunks: int | None = None):
    """One leaf's ZeRO-1 consensus step on this rank.

    u: the worker's (padded_chunks, chunk) gradient(+EF) chunks.
    `logical_chunks` is the leaf's PRE-PAD chunk count ⌈size/chunk⌉: the
    codec draws its keep mask and dither at that count, so the payload is
    bitwise the un-padded all-gather encode's even at keep_fraction < 1
    (the padded chunks are always dropped).
    Returns (owned_mean (rows, chunk), decoded_own (padded_chunks, chunk)):
    the consensus mean of this worker's rows, and the decode of its OWN
    payload (for its error-feedback update)."""
    rows = u.shape[0] // num_workers
    payload = G.encode_leaf(u, leaf_idx, gc, round_idx,
                            logical_chunks=logical_chunks)
    gathered = {k: sharding.all_to_all_rows(
        t.reshape((num_workers, rows) + tuple(t.shape[1:])), group)
        for k, t in payload.items()}                 # (m, rows, …) per key
    stacked = G.decode_leaf(gathered, leaf_idx, rows * gc.chunk,
                            (rows, gc.chunk), torch.float32, gc,
                            extra_lead=1)
    owned_mean = sharding.fold_mean(stacked)
    decoded_own = G.decode_leaf(payload, leaf_idx, u.numel(),
                                tuple(u.shape), torch.float32, gc)
    return owned_mean, decoded_own
