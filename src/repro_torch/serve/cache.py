"""LRU result cache for the serving frontend (the port's copy of
``repro.serve.cache``).

Ranked retrieval over an immutable snapshot is a pure function of the
normalized request — ``(word ids, profile)`` — so caching is exact by
construction: a hit replays the stored answer for the *identical* key, it
never approximates.  Index updates need invalidation: the server versions
its keys with the engine's content tag and ``SearchServer.swap_engine``
clears the cache after the drain, so a hit can never cross engine versions
even mid-swap (DESIGN.md §8).

Thread-safe: ``get``/``put`` take a lock (submit threads race the dispatch
thread) and ``stats`` snapshots under the same lock — a reader can never
observe a half-updated hit/miss pair.  ``capacity=0`` disables caching
(every ``get`` is a miss, ``put`` drops), so callers don't need a second
code path.

Metrics: hits/misses/evictions mirror into a :mod:`repro_torch.obs` registry
(labeled by ``name`` so several caches can share one registry); recording is
free while the registry is disabled (DESIGN.md §10).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable

import repro_torch.obs as obs


class LRUCache:
    """Bounded least-recently-used map with hit/miss counters."""

    def __init__(self, capacity: int, *, registry: "obs.Registry | None" = None,
                 name: str = "result_cache"):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        reg = obs.resolve(registry)
        labels = {"cache": name}
        self._m_hits = reg.counter("repro_cache_hits_total", labels,
                                   "result-cache hits")
        self._m_misses = reg.counter("repro_cache_misses_total", labels,
                                     "result-cache misses")
        self._m_evictions = reg.counter("repro_cache_evictions_total", labels,
                                        "LRU entries evicted at capacity")

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Hashable):
        """The cached value (refreshing its recency) or None."""
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._data.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
            return val

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)          # evict the LRU entry
                self._m_evictions.inc()

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    @property
    def stats(self) -> dict:
        with self._lock:                  # consistent (hits, misses, size)
            hits, misses, size = self.hits, self.misses, len(self._data)
        n = hits + misses
        return {"hits": hits, "misses": misses,
                "hit_rate": hits / n if n else 0.0,
                "size": size, "capacity": self.capacity}
