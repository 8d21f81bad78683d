"""FIFO cache with hit-rate counters and a nanosecond clock.

Parity: khipu-base/.../util/FIFOCache.scala:25 (hit/miss counters feed
DataSource.cacheHitRate) and util/Clock.scala:3 (per-source accumulated
read time, surfaced in the per-block perf line, Ledger.scala:447-448).

The port's copy of ``khipu_tpu.storage.cache`` (no JAX there, but the port imports
nothing of the reference package).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class Clock:
    """Accumulates elapsed nanoseconds across timed sections."""

    __slots__ = ("_ns",)

    def __init__(self) -> None:
        self._ns = 0

    def start(self) -> int:
        return time.perf_counter_ns()

    def elapse(self, t0: int) -> None:
        self._ns += time.perf_counter_ns() - t0

    @property
    def elapsed_ns(self) -> int:
        return self._ns

    def reset(self) -> int:
        ns, self._ns = self._ns, 0
        return ns


class FIFOCache(Generic[K, V]):
    """Bounded FIFO cache; eviction order is insertion order."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._map: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            v = self._map.get(key)
            if v is None:
                self._misses += 1
            else:
                self._hits += 1
            return v

    def put(self, key: K, value: V) -> None:
        with self._lock:
            if key in self._map:
                self._map[key] = value
                return
            if len(self._map) >= self.capacity:
                self._map.popitem(last=False)
            self._map[key] = value

    def remove(self, key: K) -> None:
        with self._lock:
            self._map.pop(key, None)

    def __len__(self) -> int:
        return len(self._map)

    @property
    def hit_rate(self) -> float:
        n = self._hits + self._misses
        return self._hits / n if n else 0.0

    @property
    def read_count(self) -> int:
        return self._hits + self._misses

    def reset_counters(self) -> None:
        with self._lock:
            self._hits = 0
            self._misses = 0
