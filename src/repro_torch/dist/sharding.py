"""Placement rules, meshes and the collectives (port of `repro.dist.sharding`).

The reference places params and batches on a ("data", "model") mesh. The
port's workers are processes, the ranks of `torch.distributed`, and its
meshes are:

  None                   one worker, no collective;
  a process group        `data` workers in rank order (the reference's
                         row-major worker order over its data axes);
  `HostMesh`             a ("data", "model") layout of this host's ranks,
                         rank = d·model + j (`launch.mesh.make_host_group`),
                         with a model group per data index and a data group
                         per model index;
  `MeshLayout`           a layout alone, with no processes
                         (`launch.mesh.make_production_mesh`): the dry-run
                         reads its shape.

`num_workers`, `worker_index`, `data_axis_names` and `data_axes_for` count
the data axes only, as the reference's do; the train step's consensus runs
over `data_group(mesh)`.

Parameter rules (`param_spec`): a leaf's placement is a tuple with one entry
per dim, `None` or "model", equal to the reference's `PartitionSpec`
entries (Megatron-style: wq/wk/wv, w_gate/w_up and head column-parallel,
wo and w_down row-parallel, embed on vocab rows, experts on the expert dim
when it divides; unknown leaves on their last divisible dim; 1-D leaves
and the stacked layer axis never split). `ModelShard` executes them: a
rank holds its slice of each split leaf (`ModelShard.cut`, leaf by leaf
at init; `ModelShard.take_tree` for a whole tree) and the decode step runs
its products as tensor parallelism over the model group
(`ModelShard.linears`, `.embed`, `.gather`, `.reduce`). Batch
rules: dim 0 of every batch leaf is the global batch, split over the data
axes when divisible (`shard_batch`).

The collectives map the reference's as follows; each takes the group and
returns a new tensor:

  psum / pmean            → `all_reduce_sum` (then a division by m)
  all_gather(axis=0)      → `all_gather_stack`: the list `all_gather`,
                            stacked in rank order
  all_gather(tiled, dim)  → `all_gather_cat`: concatenated along a dim
  all_to_all(0, 0)        → `all_to_all_rows`: `all_to_all_single` over
                            the leading (m, …) row-block axis

Backend rule (`backend_for`, applied when a group is made): NCCL when every
rank has its own card; gloo for CPU tensors and for ranks that share a
card, since NCCL cannot put two ranks of one communicator on one card.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

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
    return (isinstance(x, tuple) and not hasattr(type(x), "_fields")
            and all(isinstance(d, int) for d in x))


def _map_named(fn, t, path: str = ""):
    """`t` with each leaf replaced by fn(dotted path, leaf): dict keys,
    NamedTuple fields (as the reference's tree path names them) and
    sequence indices joined by dots (".blocks.mamba.in_proj")."""
    if isinstance(t, dict):
        return {k: _map_named(fn, v, f"{path}.{k}") for k, v in t.items()}
    if hasattr(type(t), "_fields"):
        return type(t)(*[_map_named(fn, v, f"{path}.{f}")
                         for f, v in zip(t._fields, t)])
    if isinstance(t, list) or (isinstance(t, tuple) and not _is_shape(t)):
        return type(t)(_map_named(fn, v, f"{path}.{i}")
                       for i, v in enumerate(t))
    return fn(path, t)


def _leaf_spec(model_axis: int):
    def visit(path: str, t):
        shape = tuple(t) if _is_shape(t) else tuple(t.shape)
        return param_spec(path, shape, model_axis,
                          in_blocks=".blocks." in path + ".")
    return visit


def param_specs(params, model_axis: int):
    """The tree of `param_spec`s for `params`, a nested dict, list or
    NamedTuple (the Mamba and xLSTM weights) whose leaves are tensors or
    shape tuples (`models.model.param_shapes`). A NamedTuple field is
    named by its field name, as the reference's tree path names it."""
    return _map_named(_leaf_spec(model_axis), params)


def param_spec_table(params, model_axis: int) -> dict:
    """{dotted leaf path: its `param_spec`} for `params` (as
    `param_specs`), the lookup `ModelShard` reads."""
    table: dict = {}
    visit = _leaf_spec(model_axis)

    def record(path, t):
        table[path] = visit(path, t)

    _map_named(record, params)
    return table


# ---------------------------------------------------------------------------
# Meshes and workers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class MeshLayout:
    """A mesh's axis names and sizes, row-major over its ranks, as
    `jax.sharding.Mesh` names them (`shape` maps each name to its size).
    A layout alone has no processes."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh(MeshLayout):
    """A ("data", "model") layout whose ranks are processes: this rank,
    the world group, this rank's model group (the ranks of its data index,
    in model order) and data group (the ranks of its model index, in data
    order). A group of one rank is None: no collective."""

    rank: int = 0
    world: object = None
    model_group: object = None
    data_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]


def data_axis_names(group=None) -> tuple:
    """The data-parallel axes, major to minor: a mesh's "pod" and "data";
    for a process group (or None) the port's one "data" axis, whose
    devices are the group's ranks."""
    if isinstance(group, MeshLayout):
        return tuple(a for a in ("pod", "data") if a in group.axis_names)
    return ("data",)


def num_workers(group=None) -> int:
    """Ranks along the data axes: workers for `repro_torch.dist`, lane
    slots per stacked-tree shard for `repro_torch.fed.mesh`."""
    if group is None:
        return 1
    if isinstance(group, MeshLayout):
        return math.prod(group.shape[a] for a in data_axis_names(group))
    return dist.get_world_size(group)


def worker_index(group=None) -> int:
    """This rank's worker index along the data axes (the stacking order of
    `all_gather_stack` and `all_to_all_rows`)."""
    if group is None:
        return 0
    if isinstance(group, HostMesh):
        return group.data_index
    if isinstance(group, MeshLayout):
        raise ValueError("a mesh layout has no ranks: it has no worker "
                         "index (make_host_group makes one with ranks)")
    return dist.get_rank(group)


def model_axis_size(mesh) -> int:
    """The mesh's "model" axis (1 for None, a device or a process group)."""
    if isinstance(mesh, MeshLayout):
        return mesh.shape.get("model", 1)
    return 1


def data_group(group):
    """The group the workers' collectives run on: a HostMesh's data group
    (None when its data axis is 1); a process group or None as given."""
    return group.data_group if isinstance(group, HostMesh) else group


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


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a mesh layout's axes; for a process group (or
    None) its workers on the one "data" axis, of which an int is the
    count."""
    if isinstance(mesh, MeshLayout):
        return mesh.shape
    return {"data": mesh if isinstance(mesh, int) else num_workers(mesh)}


def data_axes_for(global_batch: int, group=None) -> tuple:
    """The axes the batch dim splits over: the largest divisible suffix of
    the data axes (empty when none divides)."""
    axes = data_axis_names(group)
    sizes = axis_sizes(group)
    while axes and global_batch % math.prod(sizes[a] for a in axes):
        axes = axes[1:]
    return axes


def lead_entry(axes: tuple):
    """The placement entry of a dim split over `axes`: the tuple for
    several, the bare name for one, None for none."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def batch_specs(batch, group=None):
    """Placement of a batch tree: dim 0 over the data axes when divisible."""

    def spec(leaf):
        rest = (None,) * (len(leaf.shape) - 1)
        return (lead_entry(data_axes_for(leaf.shape[0], group)),) + rest

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


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (exact): the
    reference's tiled `all_gather`."""
    if group is None:
        return x

    def fn(t):
        outs = [torch.empty_like(t) for _ in range(num_workers(group))]
        dist.all_gather(outs, t, group=group)
        return torch.cat(outs, dim)

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
# Tensor parallelism over "model"
# ---------------------------------------------------------------------------
class ModelShard:
    """One rank's part of the model on the "model" axis: its index j of m
    ranks, the model group (None: the collectives are not run, see
    `DryShard`) and the dim of each parameter leaf that `param_specs`
    splits over "model" (`split(name)`, None for a whole leaf; a block
    leaf is named without ".blocks." and counted without its stacked layer
    axis: "wq", "mamba.in_proj"; a top-level leaf by its key: "embed").
    The rank holds the slice `cut` takes of each split leaf.

    The decode path (`models.decode`, `layers.swiglu`, `moe.moe_ffn`,
    `ssm.mamba_decode_step`, `xlstm`) takes one as `tp` and runs its
    products through it: a column-split product's output is gathered, a
    row-split product takes its slice of the input and is summed by an
    all-reduce; a Megatron pair (a column-split producer feeding its
    row-split consumer) skips the gather. Every gather moves bits, and an
    all-reduce gives every rank the same bits, so each rank holds the
    same activations and recurrent states.

    `batch_group` is the group of data ranks over which the serve batch is
    split (None: the batch is whole on this rank) and `batch_index` this
    rank's place in it: the MoE routing gathers its top-k choices over it
    (`gather_batch`), so that it counts capacity over the global batch as
    the reference's GSPMD step does."""

    def __init__(self, params, size: int, index: int, group=None,
                 batch_group=None, batch_index: int = 0):
        self.size, self.index, self.group = size, index, group
        self.batch_group, self.batch_index = batch_group, batch_index
        self._table = param_spec_table(params, size)
        self._split = {}
        for path, entries in self._table.items():
            if "model" not in entries:
                continue
            lead = 1 if ".blocks." in path + "." else 0
            name = path[len(".blocks."):] if lead else path[1:]
            self._split[name] = entries.index("model") - lead

    def cut(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf at dotted `path` (the `cut`
        of `models.model.init_params`): a copy, so the whole leaf can be
        freed at once, or `x` itself where it is not split."""
        entries = self._table[path]
        if self.size == 1 or "model" not in entries:
            return x
        d = entries.index("model")
        n = x.shape[d] // self.size
        return x.narrow(d, self.index * n, n).clone()

    def take_tree(self, tree):
        """A whole tree shaped like the params cut to this rank's slices."""
        return _map_named(self.cut, tree)

    def gather_tree(self, tree):
        """The whole tree from this rank's slices (one all-gather a split
        leaf; exact)."""
        def whole(path, x):
            entries = self._table[path]
            if "model" not in entries:
                return x
            return self.gather(x, entries.index("model"))
        return _map_named(whole, tree)

    def split(self, name: str):
        """The dim of leaf `name` split over "model" (None: whole)."""
        return self._split.get(name)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' x concatenated along `dim` (exact)."""
        return all_gather_cat(x, dim, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks; every rank gets the same bits."""
        return all_reduce_sum(x, self.group)

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' x concatenated along dim 0 in data order: a
        per-token tensor of the global batch (exact); x itself when the
        batch is whole on this rank."""
        return all_gather_cat(x, 0, self.batch_group)

    def weight(self, w: torch.Tensor, name: str) -> torch.Tensor:
        """The whole leaf `name` from this rank's slice `w`: for a weight
        read whole (an elementwise or per-head use, not a product)."""
        d = self.split(name)
        return w if d is None else self.gather(w, d)

    def linears(self, x: torch.Tensor, pairs) -> list:
        """[x @ W for each (w, name)], W the whole leaf of this rank's
        slice w: the column-split products' outputs gathered together in
        ONE all-gather, each row-split product summed by an all-reduce."""
        outs, cols = [], []
        for w, name in pairs:
            d = self.split(name)
            if d is None:
                outs.append(x @ w)
            elif d == w.dim() - 1:
                cols.append(len(outs))
                outs.append(x @ w)
            else:
                if d != 0 or w.dim() != 2:
                    raise ValueError(f"{name}: a product needs a matrix "
                                     f"split on dim 0 or 1, got dim {d}")
                k = w.shape[0]
                outs.append(self.reduce(
                    x[..., self.index * k:(self.index + 1) * k] @ w))
        if cols:
            widths = [outs[i].shape[-1] for i in cols]
            stacked = self._gather_stack(
                torch.cat([outs[i] for i in cols], -1))
            for i, part in zip(cols, torch.split(stacked, widths, -1)):
                outs[i] = torch.cat(part.unbind(0), -1)
        return outs

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               name: str) -> torch.Tensor:
        """x @ W, W the whole leaf of this rank's slice w (`linears`)."""
        return self.linears(x, [(w, name)])[0]

    def embed(self, tokens: torch.Tensor, table: torch.Tensor,
              name: str = "embed") -> torch.Tensor:
        """The embedding lookup on a vocab-row-split table: each rank looks
        up the ids in its rows, writes zeros elsewhere, and one all-reduce
        sums them (exact: one row plus zeros, no scaling)."""
        if self.split(name) is None:
            return F.embedding(tokens, table)
        rows = table.shape[0]
        local = tokens - self.index * rows
        inside = (local >= 0) & (local < rows)
        e = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                        table)
        return self.reduce(torch.where(inside[..., None], e,
                                       torch.zeros_like(e)))

    def _gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_stack(x, self.group)


class DryShard(ModelShard):
    """A ModelShard that runs no collective: the dry-run drives the decode
    step on `meta` tensors through it and reads the plan's collectives
    (`census`: per (kind, ranks in the group), the calls and the bytes
    this rank puts in, as `transport_counts` counts them). `batch_size`:
    the data ranks the serve batch is split over (`gather_batch`)."""

    def __init__(self, params, size: int, index: int = 0,
                 batch_size: int = 1):
        super().__init__(params, size, index, None)
        self.batch_size = batch_size
        self.census: dict = {}

    def _count(self, kind: str, x: torch.Tensor, group: int) -> None:
        c = self.census.setdefault((kind, group), {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += x.numel() * x.element_size()

    def gather(self, x, dim):
        self._count("all_gather", x, self.size)
        return torch.cat([x] * self.size, dim)

    def reduce(self, x):
        self._count("all_reduce", x, self.size)
        return x.clone()

    def gather_batch(self, x):
        if self.batch_size == 1:
            return x
        self._count("all_gather", x, self.batch_size)
        return torch.cat([x] * self.batch_size, 0)

    def _gather_stack(self, x):
        self._count("all_gather", x, self.size)
        return torch.stack([x] * self.size)


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
    # the reciprocal rounded to f32, then to acc's dtype, as a host value:
    # a multiply by it rounds as by a 0-d tensor of that value, and copies
    # nothing to the device (a captured program cannot hold a copy)
    recip = torch.tensor(1.0, dtype=torch.float32) / n
    return acc * float(recip.to(acc.dtype))


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

