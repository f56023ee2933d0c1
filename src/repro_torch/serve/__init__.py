"""`repro_torch.serve` — the serving runtime's public surface (port of
`repro.serve`, same `__all__`).

    from repro_torch.serve import Engine, ServeConfig, Request

    engine = Engine(model_cfg, params, ServeConfig(slots=8, max_seq=512))
    engine.register_prefix("system", system_tokens, prefill=True)
    engine.submit(Request(rid=0, prompt=suffix, prefix_id="system"))
    finished = engine.run_to_completion()

`BatchScheduler` remains importable as a deprecated alias of `Engine` —
construction emits `DeprecationWarning`; importing this package does not.
"""
from repro_torch.serve.engine import (Engine, EngineExhausted, Request,
                                      ServeConfig, verify_prefix_contract)
from repro_torch.serve.loadgen import Arrival, LoadConfig, generate, play
from repro_torch.serve.prefixcache import PrefixCache, PrefixEntry
from repro_torch.serve.scheduler import BatchScheduler

__all__ = [
    "Engine",
    "EngineExhausted",
    "Request",
    "ServeConfig",
    "verify_prefix_contract",
    "PrefixCache",
    "PrefixEntry",
    "LoadConfig",
    "Arrival",
    "generate",
    "play",
    "BatchScheduler",
]
