"""Captured programs: the port's counterpart of `jax.jit` for the serve
programs and the serve launcher's prefill, the train steps (`dist.step`,
`dist.step.zero1`), the federation's client rounds, decodes and
aggregates, the steps of the paper's algorithms (`core.optim`) and the
democratic embedding (`core.embeddings.democratic`), as CUDA graphs on
the card.

The reference compiles each of these programs once per specialization
(its static arguments, and the shape and dtype of every array leaf) and
reuses the compiled program. A `Program` does the same with
`torch.cuda.CUDAGraph`:

  * the first call of a specialization copies its inputs into static
    buffers and runs the function on them eagerly, on a side stream. That
    run IS the call (its result is returned, and a state it updates in
    place is updated once), and it warms up what a capture must not do for
    the first time: loading the kernels' library, setting their
    shared-memory attributes, making cuBLAS's handle and workspace, an
    NCCL communicator. Before that run and after it the allocator's
    cached blocks are freed when they exceed `_CACHE_SLACK`
    (`torch.cuda.empty_cache`: it caches per stream, and the capture
    allocates from a private pool, which cannot take them), so a first
    call's reserved memory is an eager step's, not twice its
    temporaries; then the function is captured into a graph over the
    same buffers, which records its launches without executing them (a
    capture that runs out of memory is made once more with the
    allocator's segments growing in place, `_grow_segments`);
  * a later call copies its inputs into the static buffers and replays
    the graph: one launch in place of thousands of dispatches.

A graph bakes in every pointer it reads or writes. The arguments named by
`bound` (keystr prefixes of the argument tuple, e.g. `("[0]",
"[1].caches")` for the parameters and a state's in-place caches, or
`("[0]", "[1]", "[2]")` for a train step's params, optimizer state and
EF, which it updates in place) are bound by pointer: a graph is captured
per (specialization, bound pointers), so two engines over one model get
graphs of their own and no graph writes through another engine's
caches. A graph dies with the
tensors it is bound to. Every other tensor argument is copied into a
static buffer at each call. A Python int, float or bool argument is
traced, as `jax.jit` traces it: the function receives it as a 0-d tensor
on the program's device, so a new value (a slot index) is no new
specialization.

Outputs keep the reference's value semantics: an output that is a bound
argument (an in-place cache or train state) comes back as the caller's
tensor; every other output is cloned out of the graph's buffers, so no
later replay can overwrite what a caller holds.

`_cache_size()` counts specializations, not graphs, as the reference's
compiled programs do; `repro_torch.obs.recompile` reads it. The kernel
launch counts (`kernels.ops.launch_counts`) stay device launches: the
launches a capture records (its wrappers count them, though nothing ran)
are taken back off the counts, and every replay adds them again.
`kernels.dispatch` (obs) fires where the Python runs: at the eager first
call and at the capture, as the reference counts at trace.

Set-up: a card's first call of a specialization adds the host seconds of
its three pieces to process-wide totals by the program's `name` (the
train steps' is the one they register under, "dist.step" or
"dist.step.zero1"; by default fn's qualified name): the eager first run,
up to the end of its side stream's work; the two cache releases around
it; the capture (`capture_s` keeps each capture's time inside it).
`setup_seconds(name)` reads them; they outlive the program. On the CPU
the first call's eager run is its first run, and nothing is released or
captured. While a `torch.profiler` trace is on, each call's host phases
stand in it as labels (`obs.core.label`): `graph.fill`, `graph.replay`
(the graph's launch), `graph.realize`, and at a first call
`graph.first_run`, `graph.release_cache`, `graph.capture`.

On the CPU there is no graph: every call copies its inputs into the
static buffers of its (specialization, bound pointers), runs the function
eagerly on them and clones the outputs as a replay would, so the CPU
exercises the binding, copying and cloning of the card. `eager()`, the counterpart of
`jax.disable_jit`, runs programs as plain calls and records no
specialization. There is no fallback: a capture that fails, other than
by running out of memory the first time, raises.

A Program called while another Program's function runs (its first run,
its capture, or its CPU run) is a plain call of its function: it records
no specialization, no first run and no capture of its own, as `jax.jit`
inlines a jitted function called under another trace. (The democratic
embedding inside a captured DGD-DEF step is one such call.)
"""
from __future__ import annotations

import collections
import contextlib
import gc
import os
import threading
import time
import weakref

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.obs import core as obs_lib

_EAGER = [0]
_SCALARS = {bool: torch.bool, int: torch.int64, float: torch.float32}
_SIDE_STREAMS: dict = {}
# whether _grow_segments has turned on segments that grow in place
_GROWING = [False]
# cached bytes above which a first call hands the allocator's cache back;
# below it what a side-stream run or a capture holds twice is small, and
# `empty_cache` (a device synchronization and a cudaFree per segment)
# cost 1-130 ms per first call of the small step programs of core.optim
_CACHE_SLACK = 1 << 30
# per thread: how many Program functions are running (nested calls inline)
_INSIDE = threading.local()
# host seconds of first calls by (program name, piece), process-wide
SETUP_PIECES = ("first_run", "release_cache", "capture")
_SETUP: collections.Counter = collections.Counter()


def setup_seconds(name: str) -> dict:
    """Host seconds the first calls of the programs named `name` spent in
    each piece of `SETUP_PIECES`, summed over their specializations, since
    the process started (0.0 where none ran)."""
    return {piece: float(_SETUP[(name, piece)]) for piece in SETUP_PIECES}


@contextlib.contextmanager
def eager():
    """Run every Program as a plain call of its function (no graph, no
    specialization recorded) inside this block."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def _inside() -> int:
    return getattr(_INSIDE, "depth", 0)


def _run(fn, args):
    """fn(*args) as a Program's function: Programs it calls run inline."""
    _INSIDE.depth = _inside() + 1
    try:
        return fn(*args)
    finally:
        _INSIDE.depth -= 1


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if type(x) in _SCALARS:
        return type(x)                      # traced: keyed by type only
    return ("static", x)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


@contextlib.contextmanager
def _setup_piece(name: str, piece: str):
    """The block's host seconds added to program `name`'s set-up `piece`;
    labelled `graph.<piece>` in a running profiler's trace."""
    t0 = time.perf_counter()
    with obs_lib.label(f"graph.{piece}"):
        yield
    _SETUP[(name, piece)] += time.perf_counter() - t0


def _release_cache(device: torch.device) -> None:
    """Free the allocator's cached blocks if they exceed _CACHE_SLACK."""
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    if cached > _CACHE_SLACK:
        torch.cuda.empty_cache()


def _grow_segments() -> bool:
    """Let the allocator's segments grow in place (`expandable_segments`),
    unless they already do or PYTORCH_CUDA_ALLOC_CONF names the setting;
    whether this call turned them on. A capture draws its temporaries
    from the graph's private pool, which cannot hand a freed segment back
    while it captures: with fixed-size segments a step whose forward and
    backward free blocks of many sizes (Mellum2's at 8,192 positions:
    60.8 GiB reserved against 39.6 GiB allocated at the optimizer) runs
    out of memory at the optimizer's leaf-sized outputs, where segments
    that grow in place keep what is reserved near what is allocated. They
    map their memory a piece at a time, which costs a step that fits
    without them seconds of set-up, so a capture turns them on only once
    it has run out of memory."""
    if _GROWING[0] or "expandable_segments" in os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF", ""):
        return False
    _GROWING[0] = True
    # the accelerator-wide setter where this torch has it (the CUDA one
    # warns that it is deprecated there)
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings",
                     None) or torch.cuda.memory._set_allocator_settings
    setter("expandable_segments:True")
    return True


def _drop(program_ref, key) -> None:
    """A bound tensor died: its graph goes. The callback holds its program
    weakly, so a program and its graphs form no cycle and die together
    when the program does, never later inside the collector."""
    program = program_ref()
    if program is not None:
        program._graphs.pop(key, None)


def _plan(out, args: list, bound: list) -> tuple:
    """How to give `out` back to a caller: (spec, per leaf ("arg", i) for
    bound argument i, ("own", tensor) for a tensor to clone, or ("const",
    value)). A plan keeps no bound argument alive."""
    by_ptr = {(x.data_ptr(), tuple(x.shape), x.stride(), x.dtype): i
              for i, x in enumerate(args) if bound[i]}
    leaves, spec = tree_lib.flatten(out)
    items = []
    for y in leaves:
        if not isinstance(y, torch.Tensor):
            items.append(("const", y))
            continue
        i = by_ptr.get((y.data_ptr(), tuple(y.shape), y.stride(), y.dtype))
        items.append(("own", y) if i is None else ("arg", i))
    return spec, items


def _realize(plan: tuple, args: list):
    spec, items = plan
    return tree_lib.unflatten(spec, [
        args[v] if kind == "arg" else v.clone() if kind == "own" else v
        for kind, v in items])


def _static_buffer(x, device):
    """Where a copied argument goes: a tensor's twin, a traced scalar's 0-d
    tensor; a static argument is kept as it is."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x)
    if type(x) in _SCALARS:
        return torch.empty((), dtype=_SCALARS[type(x)], device=device)
    return x


class _Graph:
    """One (specialization, bound pointers) of a Program: the static
    buffers of its copied inputs and, on the card, its graph, the plan of
    its outputs and the launches it replays."""

    def __init__(self, args: list, bound: list, device, on_death):
        self.static = [None if b else _static_buffer(x, device)
                       for x, b in zip(args, bound)]
        # liveness, never ownership: the graph dies with a bound tensor
        self.refs = [weakref.ref(x, on_death)
                     for x, b in zip(args, bound) if b]
        self.graph = None
        self.plan = None
        self.launches: dict = {}

    def fill(self, args: list, bound: list) -> list:
        """Copy the call's inputs into the static buffers; the argument
        list the graph was captured with (bound tensors: the caller's)."""
        full = []
        for x, s, b in zip(args, self.static, bound):
            if b:
                full.append(x)
            elif isinstance(x, torch.Tensor):
                full.append(s.copy_(x))
            elif type(x) in _SCALARS:
                full.append(s.fill_(x))
            else:
                full.append(s)
        return full


class Program:
    """`fn` as a captured program (see the module docstring). `bound`:
    keystr prefixes of the argument tuple whose tensors are bound by
    pointer (read in place, or written in place). `name`: the key of its
    set-up seconds (`setup_seconds`), by default fn's qualified name."""

    def __init__(self, fn, bound=(), name=None):
        self.fn = fn
        self.bound = tuple(bound)
        self.name = name or getattr(fn, "__qualname__", type(fn).__name__)
        self._keys: set = set()
        self._graphs: dict = {}        # (key, bound pointers) -> _Graph
        self._masks: dict = {}         # spec -> [leaf is bound]
        self._pool = None              # the live graphs' memory pool
        # per-capture host seconds; kernel launches recorded by captures
        # and added by replays (device launches = eager + replayed)
        self.capture_s: list = []
        self.captured = collections.Counter()
        self.replayed = collections.Counter()

    def _cache_size(self) -> int:
        return len(self._keys)

    def graphs(self) -> int:
        """Live (specialization, bound pointers) entries."""
        return len(self._graphs)

    def _mask(self, spec) -> list:
        mask = self._masks.get(spec)
        if mask is None:
            paths = [tree_lib.keystr(p) for p in tree_lib.spec_paths(spec)]
            mask = [any(p.startswith(b) for b in self.bound) for p in paths]
            self._masks[spec] = mask
        return mask

    def __call__(self, *args):
        if _EAGER[0] or _inside():
            return self.fn(*args)
        leaves, spec = tree_lib.flatten(args)
        mask = self._mask(spec)
        bound = [b and isinstance(x, torch.Tensor)
                 for x, b in zip(leaves, mask)]
        key = (spec, tuple(_leaf_sig(x) for x in leaves))
        self._keys.add(key)
        pins = (key, tuple((x.data_ptr(), x.stride())
                           for x, b in zip(leaves, bound) if b))
        entry = self._graphs.get(pins)
        if entry is not None and entry.graph is not None:
            with obs_lib.label("graph.fill"):
                entry.fill(leaves, bound)
            with obs_lib.label("graph.replay"):
                entry.graph.replay()
            ops.add_launches(entry.launches)
            self.replayed.update(entry.launches)
            with obs_lib.label("graph.realize"):
                return _realize(entry.plan, leaves)
        if entry is None:
            device = next(x.device for x in leaves
                          if isinstance(x, torch.Tensor))
            me = weakref.ref(self)
            # _drop bound now: a module-level program's entries may die
            # at interpreter exit, after this module's globals are gone
            entry = _Graph(leaves, bound, device,
                           lambda _, k=pins, drop=_drop: drop(me, k))
            with obs_lib.label("graph.fill"):
                full = entry.fill(leaves, bound)
            out = self._first_run(entry, spec, full, bound, device)
            self._graphs[pins] = entry
        else:                  # the CPU: fn runs on the static buffers
            with obs_lib.label("graph.fill"):
                full = entry.fill(leaves, bound)
            out = _run(self.fn, tree_lib.unflatten(spec, full))
        with obs_lib.label("graph.realize"):
            return _realize(_plan(out, full, bound), leaves)

    def _first_run(self, entry: _Graph, spec, full: list, bound: list,
                   device: torch.device):
        """fn over the static buffers, once; on the card on a side stream,
        then captured into entry. The run's seconds (on the card up to the
        end of its work on the side stream) count to the set-up."""
        if device.type != "cuda":
            with _setup_piece(self.name, "first_run"):
                return _run(self.fn, tree_lib.unflatten(spec, full))
        current = torch.cuda.current_stream(device)
        side = _side_stream(device)
        # the allocator caches freed blocks per stream and pool: the side
        # stream's run cannot draw on the current stream's cache, nor the
        # capture's private pool on either. Without handing them back
        # first, a train step's first call would hold its temporaries
        # twice (three times after an eager step)
        with _setup_piece(self.name, "release_cache"):
            _release_cache(device)
        with _setup_piece(self.name, "first_run"):
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = _run(self.fn, tree_lib.unflatten(spec, full))
            side.synchronize()
        with _setup_piece(self.name, "release_cache"):
            _release_cache(device)
        with _setup_piece(self.name, "capture"):
            try:
                self._capture(entry, spec, full, bound, side)
                again = False
            except torch.OutOfMemoryError:
                if not _grow_segments():
                    raise
                again = True
            if again:
                # the failed capture's graph and temporaries died with its
                # frames; its pool's segments go back before the second
                gc.collect()
                torch.cuda.empty_cache()
                self._capture(entry, spec, full, bound, side)
        current.wait_stream(side)
        return out

    def _capture(self, entry: _Graph, spec, full: list, bound: list,
                 side: torch.cuda.Stream) -> None:
        """Record fn over `full` into entry.graph on `side`, without
        executing it; the launches its wrappers counted come back off."""
        if not self._graphs:
            # graphs of one program share a memory pool (they replay one
            # at a time, and outputs are cloned before the next replay);
            # once all of them have died, the allocator retires the pool,
            # so a capture with no live sibling takes a new one
            self._pool = torch.cuda.graph_pool_handle()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # a graph destroyed while another is captured invalidates the
        # capture, and the cyclic collector may run at any allocation and
        # free whatever holds one: it waits until the capture has ended
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                # "thread_local": a capture fails on this thread's unsafe
                # calls (a host read, a host copy), not on another
                # thread's, such as the event queries of NCCL's watchdog
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = _run(self.fn, tree_lib.unflatten(spec, full))
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                finally:
                    after = ops.launch_counts()
                    recorded = {k: n - before[k] for k, n in after.items()
                                if n != before[k]}
                    ops.add_launches({k: -n for k, n in recorded.items()})
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.capture_s.append(time.perf_counter() - t0)
        entry.graph, entry.launches = graph, recorded
        entry.plan = _plan(out, full, bound)
        self.captured.update(recorded)
