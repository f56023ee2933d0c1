"""Phase marks of the train steps (`csrc/marks.cu`): one empty CUDA kernel
per phase boundary, launched on the current stream.

`dist.step`'s steps call `mark(phase, like)` before each phase of
`PHASES` in turn ("step_end" after the last write). Captured, the marks
are nodes of the step's CUDA graph and replay in order every step, so a
profiler's trace splits the graph's kernels into phases by the marks'
starts: a phase lasts from its mark's start to the next mark's start
(`bench/phases.py`, which reads `PHASES` and `kernel_name`). The launch
counts of `kernels.ops` leave the marks out. On the CPU (and on `meta`
tensors) `mark` does nothing and builds nothing.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import _stream, call_on

PHASES = ("forward", "backward", "consensus", "optimizer", "state_write",
          "step_end")
_INDEX = {p: i for i, p in enumerate(PHASES)}


def kernel_name(phase: str) -> str:
    """The mark kernel's name as a profiler's trace shows it."""
    return f"repro_mark_{phase}"


@functools.cache
def _kernel():
    return _build.library("marks").repro_mark


def mark(phase: str, like: torch.Tensor) -> None:
    """Launch `phase`'s mark <<<1, 1>>> on the current stream of `like`'s
    card; nothing for a tensor elsewhere."""
    if like.device.type != "cuda":
        return
    rc = call_on(like, _kernel(), _INDEX[phase], _stream(like))
    _build.check(rc, f"mark {phase}")
