"""Deprecation shim: `BatchScheduler` moved to `repro_torch.serve.engine.Engine`
(port of `repro.serve.scheduler`).

Constructing `BatchScheduler` emits `DeprecationWarning`; importing this
module does not. `run_to_completion` RAISES `EngineExhausted` when
`max_steps` runs out with requests still queued or active.
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.serve.engine import Engine, ServeConfig


class BatchScheduler(Engine):
    """Deprecated v1 constructor signature over `Engine`."""

    def __init__(self, cfg, params, *, slots: int, max_seq: int,
                 eos_id: Optional[int] = None, greedy: bool = True,
                 device=None):
        warnings.warn(
            "repro_torch.serve.BatchScheduler is deprecated; use "
            "repro_torch.serve.Engine(cfg, params, ServeConfig(slots=..., "
            "max_seq=..., eos_id=...))", DeprecationWarning, stacklevel=2)
        super().__init__(cfg, params,
                         ServeConfig(slots=slots, max_seq=max_seq,
                                     eos_id=eos_id, greedy=greedy),
                         device=device)
