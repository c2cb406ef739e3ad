"""Bounded LRU cache for interned evaluation collections.

A :class:`repro_torch.core.RelevanceEvaluator` pays its string costs (docno
vocabulary interning, qrel slab layout) at construction; the serve layer
therefore builds each collection's evaluator ONCE and reuses it across every
request that names the same ``qrel_id``.  This module provides the bounded
container for those entries: least-recently-used eviction keeps the resident
set under a fixed cap no matter how many collections clients register over a
service's lifetime.

The cache is deliberately generic (string key → arbitrary entry) so tests
can exercise the eviction policy without building evaluators, and
thread-safe — service handlers touch it from the event loop while backend
flushes run on executor threads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterator, Optional, TypeVar

T = TypeVar("T")

_MISSING = object()  # sentinel: distinguishes "absent" from "stored None"


class LRUCache:
    """A thread-safe, bounded, least-recently-used mapping.

    ``get`` and ``put`` both count as a "use".  When an insert pushes the
    size past ``capacity``, the least-recently-used entry is dropped and the
    optional ``on_evict(key, value)`` hook fires (the service uses it to
    count evictions and release per-collection state).  Replacing an
    existing key's entry with a DIFFERENT value fires the hook too — the
    displaced value leaves the cache just as surely as an evicted one, and
    whoever owns its resources must hear about it.  Re-putting the same
    object is a no-op refresh and fires nothing.

    >>> c = LRUCache(capacity=2)
    >>> c.put('a', 1); c.put('b', 2)
    >>> _ = c.get('a')          # 'a' is now most recently used
    >>> c.put('c', 3)           # evicts 'b', the LRU entry
    >>> sorted(c.keys()), c.get('b') is None
    (['a', 'c'], True)
    """

    def __init__(self, capacity: int,
                 on_evict: Optional[Callable[[str, T], None]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._on_evict = on_evict
        self._entries: "OrderedDict[str, T]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.replacements = 0

    def get(self, key: str) -> Optional[T]:
        """The entry for ``key`` (refreshing its recency), or ``None``."""
        with self._lock:
            if key not in self._entries:
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]

    def put(self, key: str, value: T) -> None:
        """Insert/replace ``key``, evicting the LRU entry past capacity.

        A replacement (same key, different value object) fires ``on_evict``
        for the displaced value; identity, not equality, decides — putting
        the same object back is a recency refresh only.
        """
        displaced = []  # (key, value) pairs leaving the cache; hook per pair
        with self._lock:
            old = self._entries.get(key, _MISSING)
            self._entries[key] = value
            self._entries.move_to_end(key)
            if old is not _MISSING and old is not value:
                self.replacements += 1
                displaced.append((key, old))
            if len(self._entries) > self.capacity:
                displaced.append(self._entries.popitem(last=False))
                self.evictions += 1
        if self._on_evict is not None:
            for pair in displaced:
                self._on_evict(*pair)

    def pop(self, key: str) -> Optional[T]:
        """Remove and return ``key``'s entry (no evict hook), or ``None``."""
        with self._lock:
            return self._entries.pop(key, None)

    def keys(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._entries))

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        """Counters for the service's ``stats`` op."""
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "replacements": self.replacements}
