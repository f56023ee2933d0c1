"""Placement rules and the collectives (port of `repro.dist.sharding`).

The reference places params and batches on a ("data", "model") mesh. The
port runs one process per data-parallel worker, and the workers are the
ranks of a `torch.distributed` process group, in rank order (the
reference's row-major worker order over its data axes). `None` stands for
one worker and no collective. The port has no "model" axis: its train step
replicates the params, as the reference's does (the NOTE in
`repro/dist/step.py`), and a model axis > 1 raises
(`repro_torch.launch.mesh.make_host_group`).

Parameter rules (`param_spec`), kept for the placement they describe: a
leaf's spec is a tuple with one entry per dim, `None` or "model", equal to
the reference's `PartitionSpec` entries. No tensor-parallel execution is
ported. Batch rules: dim 0 of every batch leaf is the global batch, split
over the workers when divisible (`shard_batch`).

The collectives map the reference's as follows; each takes the group and
returns a new tensor:

  psum / pmean            → `all_reduce_sum` (then a division by m)
  all_gather(axis=0)      → `all_gather_stack`: the list `all_gather`,
                            stacked in rank order
  all_to_all(0, 0)        → `all_to_all_rows`: `all_to_all_single` over
                            the leading (m, …) row-block axis

Backend rule (`backend_for`, applied when a group is made): NCCL when every
rank has its own card; gloo for CPU tensors and for ranks that share a
card, since NCCL cannot put two ranks of one communicator on one card.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib


def shardable(dim: int, axis_size: int) -> bool:
    """Can a dimension of `dim` elements be split `axis_size` ways evenly?"""
    return axis_size > 0 and dim % axis_size == 0


# Candidate eff-axis preferences per leaf basename. Axes are indices into the
# per-layer shape (leading stacked-layer axis stripped); negative = from end.
_AXIS_PREFS = {
    "embed": (0,),              # (V, d): vocab rows
    "head": (-1,),              # (d, V): vocab cols
    "wq": (-1,), "wk": (-1,), "wv": (-1,),      # column-parallel
    "w_gate": (-1,), "w_up": (-1,),
    "wo": (0,), "w_down": (0,),                 # row-parallel
    "router": (-1,),            # (d, E): shard experts when divisible
    "e_gate": (0, -1), "e_up": (0, -1),         # (E, d, f): experts, else d_ff
    "e_down": (0, 1),                           # (E, f, d): experts, else d_ff
}


def param_spec(name: str, shape: tuple, model_axis: int,
               in_blocks: bool) -> tuple:
    """The placement of one parameter leaf: one entry per dim, `None` or
    "model". `name` is the dotted tree path (".blocks.wq"); `in_blocks`
    marks leaves with a leading stacked-layer axis (never split)."""
    lead = 1 if in_blocks else 0
    eff = shape[lead:]
    replicated = (None,) * len(shape)
    if model_axis <= 1 or len(eff) < 2:
        return replicated
    base = name.rsplit(".", 1)[-1]
    # unknown leaves: prefer the last axis, then earlier ones
    prefs = _AXIS_PREFS.get(base, tuple(range(len(eff) - 1, -1, -1)))
    for ax in prefs:
        ax = ax % len(eff)
        if shardable(eff[ax], model_axis):
            entries = [None] * len(eff)
            entries[ax] = "model"
            return (None,) * lead + tuple(entries)
    return replicated


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def param_specs(params, model_axis: int):
    """The tree of `param_spec`s for `params`, a nested dict (or list) whose
    leaves are tensors or shape tuples (`models.model.param_shapes`)."""

    def visit(path: str, t):
        if isinstance(t, dict):
            return {k: visit(f"{path}.{k}", v) for k, v in t.items()}
        if isinstance(t, list) or (isinstance(t, tuple) and not _is_shape(t)):
            return type(t)(visit(f"{path}.{i}", v) for i, v in enumerate(t))
        shape = tuple(t) if _is_shape(t) else tuple(t.shape)
        return param_spec(path, shape, model_axis,
                          in_blocks=".blocks." in path + ".")

    return visit("", params)


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------
def data_axis_names(group=None) -> tuple:
    """The data-parallel axes: the port's one "data" axis, whose devices
    are the group's ranks."""
    return ("data",)


def num_workers(group=None) -> int:
    """Ranks along the data axis: workers for `repro_torch.dist`, lane
    slots per stacked-tree shard for `repro_torch.fed.mesh`."""
    return 1 if group is None else dist.get_world_size(group)


def worker_index(group=None) -> int:
    """This rank's worker index (the stacking order of `all_gather_stack`
    and `all_to_all_rows`)."""
    return 0 if group is None else dist.get_rank(group)


def padded_lanes(n: int, axis_size: int) -> int:
    """Lane count a stacked cohort tree is padded to before it splits
    evenly over `axis_size` ranks (padding lanes carry zero weight
    downstream). Every rank's slice keeps ≥ 2 lanes, as the reference's
    does (a 1-lane XLA program sums in another order there); a 1-rank
    axis needs no padding."""
    if axis_size <= 0:
        raise ValueError("axis_size must be positive")
    if axis_size == 1:
        return max(n, 1)
    return axis_size * max(2, -(-max(n, 1) // axis_size))


def data_axes_for(global_batch: int, group=None) -> tuple:
    """The axes the batch dim splits over (empty when it does not divide)."""
    axes = data_axis_names(group)
    while axes and global_batch % num_workers(group):
        axes = axes[1:]
    return axes


def batch_specs(batch, group=None):
    """Placement of a batch tree: dim 0 over the data axis when divisible."""

    def spec(leaf):
        axes = data_axes_for(leaf.shape[0], group)
        rest = (None,) * (len(leaf.shape) - 1)
        return (axes[0],) + rest if axes else (None,) + rest

    return tree_lib.map(spec, batch)


def shard_batch(batch, group=None):
    """This rank's rows of a global batch tree: dim 0 split over the
    workers when divisible, else the whole leaf (`batch_specs`)."""
    m, r = num_workers(group), worker_index(group)

    def take(leaf):
        if not data_axes_for(leaf.shape[0], group):
            return leaf
        rows = leaf.shape[0] // m
        return leaf[r * rows:(r + 1) * rows]

    return tree_lib.map(take, batch)


# ---------------------------------------------------------------------------
# Backend rule and the collectives
# ---------------------------------------------------------------------------
def backend_for(device: torch.device, world_size: int) -> str:
    """"nccl" when the ranks are on CUDA and every rank has its own card
    (rank r on card r), else "gloo" (CPU tensors, or ranks sharing a
    card)."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


_KINDS = ("all_reduce", "all_gather", "all_to_all")


def _zero_counts() -> dict:
    return {k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in _KINDS}


_counts = _zero_counts()


def transport_counts() -> dict:
    """Per collective kind since the last reset: calls, the bytes this rank
    put in, and the host seconds spent in gloo collectives (an NCCL
    collective is queued on the stream, and its seconds are not taken)."""
    return {k: dict(v) for k, v in _counts.items()}


def reset_transport_counts() -> None:
    global _counts
    _counts = _zero_counts()


def _collective(kind: str, group, x: torch.Tensor, fn) -> torch.Tensor:
    """`fn(x)` → out on the group's transport, counted. gloo takes CUDA
    tensors for all three kinds (torch 2.11 and 2.13), so nothing is
    staged through the host; under gloo the card is synchronized before
    and after, so the seconds are the collective's own."""
    c = _counts[kind]
    c["calls"] += 1
    c["bytes"] += x.numel() * x.element_size()
    x = x.contiguous()
    if dist.get_backend(group) != "gloo":
        return fn(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = fn(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    c["seconds"] += time.perf_counter() - t0
    return out


def all_reduce_sum(x: torch.Tensor, group=None,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Σ over the ranks (the reference's `psum`), in the backend's order:
    held to a tolerance, never bitwise. `op` MAX is exact."""
    if group is None:
        return x

    def fn(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return _collective("all_reduce", group, x, fn)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """(m, *x.shape): every rank's x, stacked in rank order (exact)."""
    if group is None:
        return x[None]

    def fn(t):
        outs = [torch.empty_like(t) for _ in range(num_workers(group))]
        dist.all_gather(outs, t, group=group)
        return torch.stack(outs)

    return _collective("all_gather", group, x, fn)


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x is (m, rows, …) with block j bound for rank j; returns (m, rows, …)
    whose block j came from rank j (exact)."""
    if group is None:
        return x

    def fn(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    return _collective("all_to_all", group, x, fn)


# ---------------------------------------------------------------------------
# The mean over a stacked worker (or lane) axis
# ---------------------------------------------------------------------------
def fold(ys) -> torch.Tensor:
    """ys[0] + ys[1] + ... + ys[-1], added left to right (the rows of a
    stacked tensor, or any iterable of tensors): elementwise adds in a fixed
    order, so every device gives the same bits (a library reduction sums in
    another order on the card than on the CPU)."""
    it = iter(ys)
    acc = next(it)
    for y in it:
        acc = acc + y
    return acc


def fold_mean(ys, n: int | None = None) -> torch.Tensor:
    """The mean of `n` tensors (default len(ys): the rows of a stacked
    tensor) as XLA's CPU reduce takes it (`jnp.mean`): `fold`, then a
    multiply by the f32 reciprocal of the count (XLA folds the division by
    a constant into that multiply)."""
    n = len(ys) if n is None else n
    acc = fold(ys)
    recip = torch.tensor(1.0, dtype=torch.float32) / n
    return acc * recip.to(dtype=acc.dtype, device=acc.device)


def tree_checksum(tree) -> torch.Tensor:
    """An int64 (1,) checksum of a tree's bits (every leaf's bits summed as
    integers, weighted by its position), equal on ranks holding equal
    trees."""
    total = None
    for i, x in enumerate(tree_lib.leaves(tree)):
        x = x.detach().contiguous()
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}[x.element_size()]
        s = (torch.sum(x.view(bits), dtype=torch.int64) * (2 * i + 1)
             + x.numel())
        total = s if total is None else total + s
    return total.reshape(1)


def check_replicas_equal(tree, group=None, what: str = "params") -> None:
    """Raise unless every rank holds a bitwise equal `tree` (one
    `all_reduce` of the checksum and its negation under MAX)."""
    if group is None or num_workers(group) == 1:
        return
    c = tree_checksum(tree)
    both = all_reduce_sum(torch.cat([c, -c]), group, op=dist.ReduceOp.MAX)
    if int(both[0]) != -int(both[1]):
        raise ValueError(
            f"the ranks hold different {what}: every rank must derive them "
            "from the same seed")

