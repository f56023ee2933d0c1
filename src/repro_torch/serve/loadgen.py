"""Bursty open-loop request generation: arrivals don't wait for the engine
(port of `repro.serve.loadgen`; host-side numpy, prompts stay numpy arrays
until `Engine.submit` puts them on the engine's device).

Arrival times follow a piecewise-Poisson process: a base rate with periodic
burst phases at a (much) higher rate, which is what makes saturation
OBSERVABLE — an open-loop clock keeps admitting work while the engine falls
behind, so queue depth and time-to-first-token grow instead of the load
politely throttling itself (closed-loop generators hide exactly this; see
the coordinated-omission literature).

`generate` draws the whole trace up front (deterministic in the seed):
arrival time, prompt length / output budget from uniform mixes, and a
prefix flag with probability `prefix_ratio` (those requests carry
`prefix_id` and a SHORT suffix prompt; the rest carry the full
prefix+suffix tokens, so both classes process the same token count and the
TTFT gap is pure prefill amortization).

`play` replays a trace against an engine on the wall clock without
back-pressure: requests are submitted the moment their arrival time passes
(stamped with the SCHEDULED time, so queueing delay lands in TTFT), and the
engine steps continuously in between.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve.engine import Engine, EngineExhausted, Request


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Knobs of the open-loop trace (all times in seconds)."""
    n_requests: int = 64
    base_rate: float = 20.0        # arrivals/s outside bursts
    burst_rate: float = 100.0      # arrivals/s inside bursts
    burst_period_s: float = 2.0    # one burst every period
    burst_len_s: float = 0.5       # burst duration within the period
    prompt_len: tuple = (4, 12)    # uniform [lo, hi] suffix tokens
    max_new_tokens: tuple = (4, 16)  # uniform [lo, hi] output budget
    prefix_ratio: float = 0.5      # P(request reuses the shared prefix)
    seed: int = 0

    def rate_at(self, t: float) -> float:
        if self.burst_period_s <= 0:
            return self.base_rate
        return (self.burst_rate
                if (t % self.burst_period_s) < self.burst_len_s
                else self.base_rate)


@dataclasses.dataclass
class Arrival:
    time: float
    request: Request


def generate(cfg: LoadConfig, vocab_size: int, *,
             prefix_id: Optional[str] = None,
             prefix_tokens: Optional[np.ndarray] = None) -> list[Arrival]:
    """Draw the open-loop trace. With `prefix_id`, a `prefix_ratio` share of
    requests reference it (suffix-only prompts); the others get
    `prefix_tokens` prepended so every request covers the same tokens."""
    if prefix_id is not None and prefix_tokens is None:
        raise ValueError("prefix_id needs prefix_tokens for the cold class")
    rng = np.random.default_rng(cfg.seed)
    arrivals: list[Arrival] = []
    t = 0.0
    for rid in range(cfg.n_requests):
        t += rng.exponential(1.0 / cfg.rate_at(t))
        lo, hi = cfg.prompt_len
        suffix = rng.integers(0, vocab_size, rng.integers(lo, hi + 1),
                              dtype=np.int32)
        lo_n, hi_n = cfg.max_new_tokens
        budget = int(rng.integers(lo_n, hi_n + 1))
        use_prefix = (prefix_id is not None
                      and rng.random() < cfg.prefix_ratio)
        if use_prefix:
            prompt, pid = suffix, prefix_id
        else:
            pid = None
            prompt = (np.concatenate([np.asarray(prefix_tokens, np.int32),
                                      suffix])
                      if prefix_tokens is not None else suffix)
        arrivals.append(Arrival(t, Request(
            rid=rid, prompt=prompt, max_new_tokens=budget,
            prefix_id=pid)))
    return arrivals


def play(engine: Engine, arrivals: list[Arrival], *,
         max_steps: int = 100_000) -> dict:
    """Replay `arrivals` open-loop on the wall clock until everything
    retires. Returns wall time, decode steps, and the finished requests.
    Raises `EngineExhausted` past `max_steps` (a stuck engine must not
    report throughput)."""
    pending = sorted(arrivals, key=lambda a: a.time)
    t0 = time.perf_counter()
    steps = 0
    i = 0
    while i < len(pending) or not engine.idle():
        now = time.perf_counter() - t0
        while i < len(pending) and pending[i].time <= now:
            req = pending[i].request
            req.submit_time = t0 + pending[i].time   # scheduled, not actual
            engine.submit(req)
            i += 1
        if engine.idle():
            # nothing to decode yet: sleep to (at most) the next arrival
            time.sleep(min(max(pending[i].time - now, 0.0), 0.01))
            continue
        if steps >= max_steps:
            raise EngineExhausted(steps, engine.finished,
                                  len(engine.queue) + len(pending) - i,
                                  sum(r is not None for r in engine.active))
        engine.step()
        steps += 1
    return {"wall_s": time.perf_counter() - t0, "steps": steps,
            "finished": engine.finished}
