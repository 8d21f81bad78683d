"""DataSource SPI and the in-memory engines.

The port's counterpart of ``khipu_tpu.storage.datasource`` (parity:
khipu-storage/.../datasource/DataSource.scala:6, NodeDataSource.scala:5,
KeyValueDataSource.scala:3; EphemNodeDataSource is the model for the
Memory* engines; BlockDataSource.scala:3 for the block stores). The
memory engines' reads and writes are chaos seams (``storage.kv.*``,
``storage.node.*``, ``storage.block.*``): one global load and an
``is None`` test each while no fault plan is installed.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.storage.cache import Clock


class DataSource:
    """Common DataSource surface: metrics + lifecycle."""

    def __init__(self) -> None:
        self.clock = Clock()

    @property
    def count(self) -> int:
        raise NotImplementedError

    @property
    def cache_hit_rate(self) -> float:
        return 0.0

    @property
    def cache_read_count(self) -> int:
        return 0

    def stop(self) -> None:
        pass


class KeyValueDataSource(DataSource):
    """bytes -> bytes store."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        self.update([], {key: value})

    def remove(self, key: bytes) -> None:
        self.update([key], {})

    def update(
        self, to_remove: Iterable[bytes], to_upsert: Mapping[bytes, bytes]
    ) -> None:
        raise NotImplementedError


class NodeDataSource(KeyValueDataSource):
    """Content-addressed trie-node store: key == keccak256(value)."""


class BlockDataSource(DataSource):
    """block-number -> bytes append store tracking the best number."""

    def get(self, number: int) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, number: int, value: bytes) -> None:
        self.update([], {number: value})

    def remove(self, number: int) -> None:
        self.update([number], {})

    def update(
        self, to_remove: Iterable[int], to_upsert: Mapping[int, bytes]
    ) -> None:
        raise NotImplementedError

    @property
    def best_block_number(self) -> int:
        raise NotImplementedError


class MemoryKeyValueDataSource(KeyValueDataSource):
    # the chaos seams of a read and of a write
    _get_seam = "storage.kv.get"
    _put_seam = "storage.kv.put"

    def __init__(self) -> None:
        super().__init__()
        self._map: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        fault_point(self._get_seam)
        t0 = self.clock.start()
        try:
            return self._map.get(bytes(key))
        finally:
            self.clock.elapse(t0)

    def update(
        self, to_remove: Iterable[bytes], to_upsert: Mapping[bytes, bytes]
    ) -> None:
        fault_point(self._put_seam)
        with self._lock:
            for k in to_remove:
                self._map.pop(bytes(k), None)
            for k, v in to_upsert.items():
                self._map[bytes(k)] = bytes(v)

    @property
    def count(self) -> int:
        return len(self._map)

    def keys(self) -> List[bytes]:
        return list(self._map.keys())


class MemoryNodeDataSource(MemoryKeyValueDataSource, NodeDataSource):
    """In-memory content-addressed node store (EphemNodeDataSource):
    the store ``MerklePatriciaTrie`` reads and persists into."""

    _get_seam = "storage.node.get"
    _put_seam = "storage.node.put"


class MemoryBlockDataSource(BlockDataSource):
    def __init__(self) -> None:
        super().__init__()
        self._map: Dict[int, bytes] = {}
        self._best = -1
        self._lock = threading.Lock()

    def get(self, number: int) -> Optional[bytes]:
        fault_point("storage.block.get")
        t0 = self.clock.start()
        try:
            return self._map.get(int(number))
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        fault_point("storage.block.put")
        with self._lock:
            for n in to_remove:
                self._map.pop(int(n), None)
            for n, v in to_upsert.items():
                self._map[int(n)] = bytes(v)
                if n > self._best:
                    self._best = int(n)
            if to_remove:
                self._best = max(self._map.keys(), default=-1)

    @property
    def best_block_number(self) -> int:
        return self._best

    @property
    def count(self) -> int:
        return len(self._map)


def verify_content_address(key: bytes, value: bytes) -> bool:
    """Short-key collision guard (KesqueNodeDataSource.scala:61-63)."""
    from khipu_tpu_torch.base.keccak import keccak256

    return keccak256(value) == key
