"""Reorg buffer: ring of unconfirmed per-block write batches.

Parity: khipu-base/.../util/SimpleMapWithUnconfirmed.scala:3 +
KeyValueCircularArrayQueue (CircularArrayQueue.scala:207). Updates
enqueue whole per-block batches; only when the ring is full does the
OLDEST batch flush to the underlying source, so disk state trails the
chain tip by <= depth blocks (SURVEY §5.3: block-resolving-depth = 20).
A reorg within the window is handled by clear_unconfirmed() — buffered
batches are dropped without ever touching the source.

The port's copy of ``khipu_tpu.storage.unconfirmed`` (no JAX there, but the port imports
nothing of the reference package).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

Batch = Tuple[frozenset, Dict[bytes, bytes]]  # (removes, upserts)


class SimpleMapWithUnconfirmed:
    """Buffered view over a KeyValue/Node data source."""

    def __init__(self, source, depth: int = 20):
        self.source = source
        self.depth = depth
        self._queue: Deque[Batch] = deque()
        self._lock = threading.RLock()
        self._buffered = True

    # -- mode switches (Storages.swithToWithUnconfirmed / clearUnconfirmed)

    @property
    def buffering(self) -> bool:
        return self._buffered

    def set_buffering(self, on: bool) -> None:
        with self._lock:
            if not on:
                self.flush()
            self._buffered = on

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            for removes, upserts in reversed(self._queue):
                if key in upserts:
                    return upserts[key]
                if key in removes:
                    return None
        return self.source.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self.update([], {key: value})

    def update(
        self, to_remove: Iterable[bytes], to_upsert: Mapping[bytes, bytes]
    ) -> None:
        """One call == one block's batch (update:24-40)."""
        batch: Batch = (
            frozenset(bytes(k) for k in to_remove),
            {bytes(k): bytes(v) for k, v in to_upsert.items()},
        )
        with self._lock:
            if not self._buffered:
                self.source.update(*batch)
                return
            self._queue.append(batch)
            while len(self._queue) > self.depth:
                self.source.update(*self._queue.popleft())

    def flush(self) -> None:
        with self._lock:
            while self._queue:
                self.source.update(*self._queue.popleft())

    def clear_unconfirmed(self) -> List[bytes]:
        """Drop all buffered batches; returns the keys they touched so
        callers can invalidate read caches selectively."""
        with self._lock:
            dropped: List[bytes] = []
            for removes, upserts in self._queue:
                dropped.extend(removes)
                dropped.extend(upserts.keys())
            self._queue.clear()
            return dropped

    @property
    def pending_batches(self) -> int:
        return len(self._queue)
