"""Serve engine: continuous batching with a fixed-prefix cache (port of
`repro.serve.engine`).

The engine keeps a fixed batch of decode slots saturated against a request
queue (one batched `decode_step` per `step()` call), and amortizes prefill
across requests that share a prefix:

  * `register_prefix(id, tokens)` — declare a shared prefix. Its prefill
    state is cached after the first admission that needs it (or eagerly
    with `prefill=True`), stored positionally trimmed — for NDSC-quantized
    caches, the packed words + scales.
  * `extend_prefix(id, tokens)`   — append-only growth with `decode_tokens`
    over the new tokens instead of a re-prefill.
  * `submit(Request)`             — `Request.prefix_id` (optional) names a
    registered prefix; the prompt is then the suffix after it.
  * `step()` / `run_to_completion()` — admission + one batched decode;
    `run_to_completion` RAISES `EngineExhausted` when `max_steps` runs out
    with work still queued.

The prefix bit-exactness contract: an admission that HITS the cache and one
that MISSES run the same two computations — `prefill(prefix)` then
`decode_tokens(prompt)` — with a cache round-trip (`extract_slot` →
`scatter_slot`) in between that is bitwise the identity, so their cached
K/V, positions and greedy tokens are bitwise identical;
`verify_prefix_contract` checks exactly this.

Where the reference jits five programs per (model, max_seq), the port calls
the same decode functions eagerly; there is nothing to compile. The five
programs are still made once per (model, max_seq) and registered with
`repro_torch.obs.recompile` under the reference's names. The engine runs
on `cuda` unless it is given `device="cpu"`, and the parameters must
already live there.

Observability (zero-overhead when disabled, bitwise the same tokens either
way), with the reference's names: queue depth / occupancy gauges, prefill
+ extend + admission + decode spans, a time-to-first-token histogram
(`serve.ttft_s`, tagged by admission kind), prefix hit/miss/evict and
prefill-bytes-saved counters, and a `serve.exhausted` counter when
`run_to_completion` gives up.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import decode as decode_lib
from repro_torch.obs import core as obs_lib
from repro_torch.obs import recompile as recompile_lib
from repro_torch.serve import prefixcache as prefixcache_lib


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The engine's knobs. `slots` decode lanes, sequences up to `max_seq`
    total positions, retirement on `eos_id` (None: budget/max_seq only),
    and an LRU prefix cache of `prefix_cache_entries` entries."""
    slots: int
    max_seq: int
    eos_id: Optional[int] = None
    prefix_cache_entries: int = 8
    greedy: bool = True       # only greedy decoding is implemented

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("ServeConfig.slots must be >= 1")
        if not self.greedy:
            raise NotImplementedError("only greedy decoding is implemented")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor                 # (S,) int32 — suffix after prefix
    max_new_tokens: int = 32
    prefix_id: Optional[str] = None      # a prefix registered on the engine
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False
    admission: Optional[str] = None      # cold | prefix_hit | prefix_cold
    # host-side stamps (perf_counter); loadgen pre-sets submit_time to the
    # scheduled arrival so TTFT under saturation measures queueing too
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class EngineExhausted(RuntimeError):
    """`run_to_completion(max_steps)` ran out of steps with work pending.

    Carries the partial results: `.finished` (retired requests), `.pending`
    (queued count), `.active` (mid-flight count), `.steps`."""

    def __init__(self, steps: int, finished: list, pending: int, active: int):
        self.steps = steps
        self.finished = finished
        self.pending = pending
        self.active = active
        super().__init__(
            f"engine exhausted after {steps} steps with {pending} queued + "
            f"{active} active requests ({len(finished)} finished)")


@functools.lru_cache(maxsize=64)
def _programs(cfg, max_seq: int):
    """The engine's five programs per (model config, max_seq), shared by
    every engine over that model, as the reference shares its compiled
    ones."""
    step = recompile_lib.register(
        "serve.decode_step", functools.partial(decode_lib.decode_step, cfg))
    prefill = recompile_lib.register(
        "serve.prefill", functools.partial(decode_lib.prefill, cfg,
                                           max_seq=max_seq))
    extend = recompile_lib.register(
        "serve.extend", functools.partial(decode_lib.decode_tokens, cfg))
    admit_cold = recompile_lib.register(
        "serve.admit_cold", functools.partial(decode_lib.prefill_into, cfg,
                                              max_seq=max_seq))
    admit_prefix = recompile_lib.register(
        "serve.admit_prefix", functools.partial(decode_lib.extend_into, cfg,
                                                max_seq=max_seq))
    return step, prefill, extend, admit_cold, admit_prefix


class Engine:
    """The continuous-batching scheduler. See the module docstring."""

    def __init__(self, cfg, params, config: ServeConfig, device=None):
        if not cfg.decode_supported:
            raise ValueError(f"{cfg.name} is encoder-only")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.config = config
        self.state = decode_lib.init_decode_state(
            cfg, config.slots, config.max_seq, device=self.device)
        self.active: list[Optional[Request]] = [None] * config.slots
        self.last_token = torch.zeros((config.slots, 1), dtype=torch.int32,
                                      device=self.device)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.prefix_cache = prefixcache_lib.PrefixCache(
            config.prefix_cache_entries)
        self._prefixes: dict[str, np.ndarray] = {}   # id -> tokens
        (self._step, self._prefill, self._extend, self._admit_cold,
         self._admit_prefix) = _programs(cfg, config.max_seq)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)

    # -- prefix registry -----------------------------------------------------
    def register_prefix(self, prefix_id: str, tokens, *,
                        prefill: bool = False) -> None:
        """Declare a prefix. With `prefill=True` its state is computed and
        cached now (warmup); otherwise lazily on the first admission."""
        toks = np.asarray(tokens, np.int32)
        if toks.ndim != 1 or toks.shape[0] < 1:
            raise ValueError("prefix tokens must be a non-empty 1-D array")
        if toks.shape[0] >= self.config.max_seq:
            raise ValueError(f"prefix of {toks.shape[0]} tokens cannot fit "
                             f"max_seq={self.config.max_seq}")
        self._prefixes[prefix_id] = toks
        if prefill:
            self._prefill_prefix(prefix_id)

    def extend_prefix(self, prefix_id: str, tokens) -> None:
        """Append-only growth: extend the registered prefix (and its cached
        entry, if present) with `tokens` — a growing chat history pays
        `decode_tokens` over the NEW tokens only, never a re-prefill."""
        more = np.asarray(tokens, np.int32)
        if more.ndim != 1 or more.shape[0] < 1:
            raise ValueError("extension tokens must be a non-empty 1-D array")
        if prefix_id not in self._prefixes:
            raise KeyError(f"unknown prefix {prefix_id!r}: register it first")
        joined = np.concatenate([self._prefixes[prefix_id], more])
        if joined.shape[0] >= self.config.max_seq:
            raise ValueError(f"extended prefix of {joined.shape[0]} tokens "
                             f"cannot fit max_seq={self.config.max_seq}")
        self._prefixes[prefix_id] = joined
        entry = self.prefix_cache.peek(prefix_id)
        if entry is None:
            return                       # rebuilt lazily on next admission
        full = decode_lib.expand_state(self.cfg, entry.state,
                                       self.config.max_seq)
        more_arr = self._tokens(more[None, :])
        obs_lib.observe_program_call("serve.extend", self._extend,
                                     (self.params, full, more_arr))
        with obs_lib.span("serve.prefix_extend", prefix_id=prefix_id,
                          new_tokens=int(more.shape[0])):
            _, full = self._extend(self.params, full, more_arr)
        self.prefix_cache.put(prefix_id, joined,
                              decode_lib.extract_slot(full, 0))

    def _prefill_prefix(self, prefix_id: str) -> prefixcache_lib.PrefixEntry:
        toks = self._prefixes[prefix_id]
        toks_arr = self._tokens(toks[None, :])
        obs_lib.observe_program_call("serve.prefill", self._prefill,
                                     (self.params, toks_arr))
        with obs_lib.span("serve.prefill", prefix_id=prefix_id,
                          prompt_len=int(toks.shape[0])):
            _, state1 = self._prefill(self.params, toks_arr)
        return self.prefix_cache.put(prefix_id, toks,
                                     decode_lib.extract_slot(state1, 0))

    # -- client API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue `req`; its prompt becomes an int32 tensor on the engine's
        device."""
        if req.prefix_id is not None and req.prefix_id not in self._prefixes:
            raise KeyError(f"unknown prefix {req.prefix_id!r}: "
                           "register_prefix before submitting against it")
        if len(req.prompt) < 1:
            raise ValueError("requests need a non-empty prompt")
        req.prompt = torch.as_tensor(req.prompt, dtype=torch.int32,
                                     device=self.device)
        if req.submit_time is None:
            req.submit_time = time.perf_counter()
        obs_lib.counter("serve.submitted", 1, prompt_len=len(req.prompt),
                        prefix=req.prefix_id or "")
        self.queue.append(req)

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        """Step until queue and slots drain. Raises `EngineExhausted` if
        `max_steps` runs out first — never silently returns partials."""
        steps = 0
        while not self.idle():
            if steps >= max_steps:
                pending = len(self.queue)
                active = sum(r is not None for r in self.active)
                obs_lib.counter("serve.exhausted", 1, steps=steps,
                                pending=pending, active=active)
                raise EngineExhausted(steps, self.finished, pending, active)
            self.step()
            steps += 1
        return self.finished

    # -- engine --------------------------------------------------------------
    def step(self) -> None:
        self._admit()
        occupancy = sum(r is not None for r in self.active)
        if obs_lib.enabled():
            obs_lib.gauge("serve.queue_depth", len(self.queue))
            obs_lib.gauge("serve.active_slots", occupancy,
                          slots=self.config.slots)
            obs_lib.histogram("serve.batch_occupancy",
                              occupancy / self.config.slots)
        if occupancy == 0:
            return
        obs_lib.observe_program_call(
            "serve.decode_step", self._step,
            (self.params, self.state, self.last_token))
        with obs_lib.span("serve.decode_step", occupancy=occupancy):
            logits, self.state = self._step(self.params, self.state,
                                            self.last_token)
        obs_lib.counter("serve.tokens", occupancy)
        self.last_token = decode_lib.greedy_token(logits)
        next_tok = self.last_token[:, 0].tolist()
        pos = self.state.pos.tolist()
        eos = self.config.eos_id
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = next_tok[slot]
            req.tokens_out.append(tok)
            hit_eos = eos is not None and tok == eos
            if hit_eos or len(req.tokens_out) >= req.max_new_tokens \
                    or pos[slot] >= self.config.max_seq - 1:
                req.done = True
                self._retire(req, "eos" if hit_eos else
                             ("budget" if len(req.tokens_out)
                              >= req.max_new_tokens else "max_seq"))
                self.active[slot] = None

    def _retire(self, req: Request, reason: str) -> None:
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        if not obs_lib.enabled():
            return
        obs_lib.counter("serve.requests", 1, reason=reason,
                        tokens=len(req.tokens_out))
        if req.submit_time is not None:
            obs_lib.histogram("serve.request_latency_s",
                              req.finish_time - req.submit_time, rid=req.rid)

    # -- admission -----------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.config.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            self._admit_one(self.queue.pop(0), slot)

    def _admit_one(self, req: Request, slot: int) -> None:
        if req.prefix_id is not None:
            entry = self.prefix_cache.get(req.prefix_id)
            if entry is None:
                req.admission = "prefix_cold"
                entry = self._prefill_prefix(req.prefix_id)
            else:
                req.admission = "prefix_hit"
            obs_lib.observe_program_call(
                "serve.admit_prefix", self._admit_prefix,
                (self.params, self.state, entry.state, req.prompt, slot))
            with obs_lib.span("serve.admit_prefix", slot=slot,
                              prompt_len=len(req.prompt),
                              admission=req.admission):
                self.state, logits1 = self._admit_prefix(
                    self.params, self.state, entry.state, req.prompt, slot)
        else:
            req.admission = "cold"
            obs_lib.observe_program_call(
                "serve.admit_cold", self._admit_cold,
                (self.params, self.state, req.prompt, slot))
            with obs_lib.span("serve.admit_cold", slot=slot,
                              prompt_len=len(req.prompt)):
                self.state, logits1 = self._admit_cold(
                    self.params, self.state, req.prompt, slot)
        first = int(torch.argmax(logits1))
        req.tokens_out.append(first)
        req.first_token_time = time.perf_counter()
        self.last_token[slot, 0] = first
        self.active[slot] = req
        if obs_lib.enabled() and req.ttft_s is not None:
            obs_lib.histogram("serve.ttft_s", req.ttft_s,
                              admission=req.admission,
                              prompt_len=len(req.prompt))


# ---------------------------------------------------------------------------
# The prefix bit-exactness contract, as an executable check
# ---------------------------------------------------------------------------
def verify_prefix_contract(cfg, params, serve_cfg: ServeConfig,
                           prefix_tokens, prompt_tokens,
                           max_new_tokens: int = 4, device=None) -> dict:
    """Prove the prefix-cache contract on (cfg, params): a prefix-HIT
    admission's slot state (quantized K/V words / f32 cache, positions) and
    its full greedy token stream are bitwise identical to a COLD admission
    that prefills the same prefix on the spot. Raises AssertionError on any
    mismatch; returns the compared evidence sizes."""

    def admit_and_finish(warm: bool):
        eng = Engine(cfg, params, serve_cfg, device=device)
        eng.register_prefix("ctr", prefix_tokens, prefill=warm)
        eng.submit(Request(rid=0, prompt=prompt_tokens,
                           max_new_tokens=max_new_tokens, prefix_id="ctr"))
        eng.step()                                   # admission + 1st decode
        snap = decode_lib.extract_slot(eng.state, 0, trim=False)
        finished = eng.run_to_completion()
        entry = eng.prefix_cache.peek("ctr")
        return snap, finished[0], entry

    cold_state, cold_req, cold_entry = admit_and_finish(warm=False)
    hit_state, hit_req, hit_entry = admit_and_finish(warm=True)
    assert cold_req.admission == "prefix_cold", cold_req.admission
    assert hit_req.admission == "prefix_hit", hit_req.admission
    assert hit_req.tokens_out == cold_req.tokens_out, \
        (hit_req.tokens_out, cold_req.tokens_out)
    leaves = 0
    for a, b in [(cold_state, hit_state),
                 (cold_entry.state, hit_entry.state)]:
        assert a.caches.keys() == b.caches.keys()
        la = [a.caches[k] for k in sorted(a.caches)] + [a.pos]
        lb = [b.caches[k] for k in sorted(b.caches)] + [b.pos]
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(
                x.contiguous().view(torch.uint8),
                y.contiguous().view(torch.uint8)), \
                "prefix contract violated: slot state differs bitwise"
        leaves += len(la)
    return {"tokens": len(cold_req.tokens_out), "state_leaves": leaves,
            "entry_bytes": cold_entry.nbytes}
