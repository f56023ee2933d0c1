"""Fixed-prefix cache: prefill a shared prompt once, reuse its state (port of
`repro.serve.prefixcache`).

Entries hold the batch-1 `DecodeState` a prefill of the prefix produced,
positionally TRIMMED to the prefix length (`decode.extract_slot`), so an
entry costs exactly the slot bytes it covers — for NDSC-quantized caches
the packed int32 words + per-vector scales, bits/32 of the f32 slot. The
trimmed state holds copies, never views of the engine's live state, which
the port updates in place: a later decode step cannot rewrite an entry.
Admission re-seats the entry in fresh full-size caches
(`decode.expand_state`) and continues with the request's own prompt.

Eviction is LRU over a fixed entry budget. `get` misses return None and the
engine decides (its registered-prefix table keeps the token content, so an
evicted prefix is rebuilt on the next cold admission).

Hits, misses, evictions and the prefill bytes a hit saves are counted on
the object and, when a `repro_torch.obs` session is active, as the
reference's `serve.prefix.*` and `serve.prefill_bytes_saved` counters.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.models import decode as decode_lib
from repro_torch.obs import core as obs_lib


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: its token content, trimmed state, and size."""
    prefix_id: str
    tokens: np.ndarray              # (P,) int32 — validation + extension
    state: decode_lib.DecodeState   # batch-1, positionally trimmed
    nbytes: int                     # state_bytes(state)

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])


class PrefixCache:
    """LRU map prefix_id -> PrefixEntry with a fixed entry budget."""

    def __init__(self, max_entries: int = 8):
        if max_entries < 1:
            raise ValueError("prefix cache needs max_entries >= 1")
        self.max_entries = max_entries
        self._entries: collections.OrderedDict[str, PrefixEntry] = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, prefix_id: str) -> bool:
        return prefix_id in self._entries

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def get(self, prefix_id: str) -> PrefixEntry | None:
        """Look up an entry, counting the hit/miss; None on miss."""
        entry = self._entries.get(prefix_id)
        if entry is None:
            self.misses += 1
            obs_lib.counter("serve.prefix.miss", 1, prefix_id=prefix_id)
            return None
        self._entries.move_to_end(prefix_id)
        self.hits += 1
        obs_lib.counter("serve.prefix.hit", 1, prefix_id=prefix_id,
                        prefix_len=entry.length)
        obs_lib.counter("serve.prefill_bytes_saved", entry.nbytes,
                        prefix_id=prefix_id)
        return entry

    def peek(self, prefix_id: str) -> PrefixEntry | None:
        """Entry without touching LRU order or counters (tests, extension)."""
        return self._entries.get(prefix_id)

    def put(self, prefix_id: str, tokens, state) -> PrefixEntry:
        """Insert (or replace) an entry; evicts LRU past the budget."""
        entry = PrefixEntry(prefix_id=prefix_id,
                            tokens=np.asarray(tokens, np.int32),
                            state=state,
                            nbytes=decode_lib.state_bytes(state))
        self._entries[prefix_id] = entry
        self._entries.move_to_end(prefix_id)
        while len(self._entries) > self.max_entries:
            evicted_id, evicted = self._entries.popitem(last=False)
            self.evictions += 1
            obs_lib.counter("serve.prefix.evict", 1, prefix_id=evicted_id,
                            bytes=evicted.nbytes)
        return entry

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self.nbytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
