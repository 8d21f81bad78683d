"""In-memory content-addressed node store.

The port's counterpart of ``khipu_tpu.storage.datasource.
MemoryNodeDataSource`` (EphemNodeDataSource in the reference): a dict
behind the ``get`` / ``put`` / ``update`` surface that
``MerklePatriciaTrie`` reads and persists into.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Mapping, Optional


class MemoryNodeDataSource:
    """hash -> node RLP, content-addressed (key == keccak256(value))."""

    def __init__(self) -> None:
        self._map: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(bytes(key))

    def put(self, key: bytes, value: bytes) -> None:
        self.update([], {key: value})

    def update(
        self, to_remove: Iterable[bytes], to_upsert: Mapping[bytes, bytes]
    ) -> None:
        with self._lock:
            for k in to_remove:
                self._map.pop(bytes(k), None)
            for k, v in to_upsert.items():
                self._map[bytes(k)] = bytes(v)

    @property
    def count(self) -> int:
        return len(self._map)
