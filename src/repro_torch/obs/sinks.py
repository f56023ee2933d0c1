"""Event sinks (port of `repro.obs.sinks`): in-memory (tests / summaries)
and JSONL (artifacts).

Every sink consumes the flat event dicts `repro_torch.obs.core` emits:

  {"type": "span",    "name": ..., "ts": t0, "dur": s, "pid", "tid",
   "depth", "attrs": {...}}
  {"type": "counter" | "gauge" | "hist", "name": ..., "ts": ...,
   "value": v, "pid", "tid", "attrs": {...}}
  {"type": "meta",    "name": ..., "ts": ..., "data": {...}}

`ts` is seconds since the owning Obs session's epoch (a `perf_counter`
origin captured at enable time); durations are seconds. The Chrome-trace
sink lives in `repro_torch.obs.trace` (it rescales to microseconds).
"""
from __future__ import annotations

import json
import os


class MemorySink:
    """Keeps every event in a list — the sink tests and `Obs.summary()`
    read back."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, append-on-emit. The file handle stays open
    (and buffered) for the session; `close()` flushes it."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event, separators=(",", ":"),
                                 default=str) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class EventList(list):
    """`load_jsonl`'s return type: a list of event dicts plus a `truncated`
    flag — True when the file ended mid-record (a crashed writer) and the
    parsed prefix is everything that survived."""
    truncated: bool = False


def load_jsonl(path: str, *, strict: bool = False) -> EventList:
    """Read a JSONL event file back into a list of event dicts.

    A malformed FINAL record — the signature of a writer that died
    mid-`write` — is tolerated: the parsed prefix is returned with
    `.truncated == True`. Malformed records with valid ones after them are
    real corruption and still raise (as does any bad record under
    `strict=True`)."""
    events = EventList()
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            events.append(json.loads(stripped))
        except json.JSONDecodeError:
            if strict or any(rest.strip() for rest in lines[i + 1:]):
                raise
            events.truncated = True
            break
    return events
