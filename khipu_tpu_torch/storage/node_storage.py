"""Node storages over NodeDataSource.

Parity: khipu-eth/.../storage/NodeStorage.scala:7 (unconfirmed ring,
never deletes from the source :16-19), ReadOnlyNodeStorage (buffering
wrapper for eth_call simulation), ArchiveNodeStorage (no prune).
The port's copy of ``khipu_tpu.storage.node_storage``; ``mirror`` is
the port's ``DeviceNodeMirror``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

from khipu_tpu_torch.storage.cache import FIFOCache
from khipu_tpu_torch.storage.unconfirmed import SimpleMapWithUnconfirmed


class NodeStorage:
    """hash -> node-rlp store with reorg ring + FIFO read cache.

    Deletes are swallowed: a content-addressed archive store never
    removes nodes (NodeStorage.scala:16-19)."""

    def __init__(self, source, depth: int = 20, cache_size: int = 1 << 20):
        self.source = source
        self._unconfirmed = SimpleMapWithUnconfirmed(source, depth)
        self._unconfirmed.set_buffering(False)  # regular-sync switch turns on
        self._cache: FIFOCache = FIFOCache(cache_size)
        # device-resident read-through (storage/device_mirror.py): when
        # the window commit targets the device mirror, freshly committed
        # nodes live ONLY there until the async spill stage writes them
        # here. Set by Storages.attach_mirror; None = host-only reads.
        # Never cached on hit: the mirror ring-evicts, and the spill
        # lands the durable copy in the host store shortly after.
        self.mirror = None

    def get(self, key: bytes) -> Optional[bytes]:
        v = self._cache.get(key)
        if v is not None:
            return v
        v = self._unconfirmed.get(key)
        if v is not None:
            self._cache.put(key, v)
            return v
        m = self.mirror
        if m is not None:
            return m.get(key)
        return None

    def put(self, key: bytes, value: bytes) -> None:
        self.update([], {key: value})

    def update(
        self, to_remove: Iterable[bytes], to_upsert: Mapping[bytes, bytes]
    ) -> None:
        for k, v in to_upsert.items():
            self._cache.put(bytes(k), bytes(v))
        # to_remove intentionally dropped (never delete from source)
        self._unconfirmed.update([], to_upsert)

    def switch_to_unconfirmed(self) -> None:
        self._unconfirmed.set_buffering(True)

    def clear_unconfirmed(self) -> None:
        # The FIFO cache is populated by update()/get() with unconfirmed
        # values; dropping the ring without evicting those keys would
        # keep serving nodes that were never durably written (and mask
        # MPTNodeMissingException after a reorg + restart). Evict only
        # the dropped keys — confirmed hot nodes stay cached. The trie
        # layer's decoded-node cache (mpt.py attaches _mpt_dcache to its
        # source, i.e. this object) reads through get() and can hold the
        # same unconfirmed nodes — evict there too.
        dcache = getattr(self, "_mpt_dcache", None)
        for key in self._unconfirmed.clear_unconfirmed():
            self._cache.remove(key)
            if dcache is not None:
                dcache.pop(key, None)

    def flush(self) -> None:
        self._unconfirmed.flush()

    @property
    def cache_hit_rate(self) -> float:
        return self._cache.hit_rate

    @property
    def cache_read_count(self) -> int:
        return self._cache.read_count


class ReadOnlyNodeStorage:
    """Buffers writes in memory; underlying storage is never touched.

    Used by simulateTransaction / eth_call (ReadOnlyNodeStorage.scala).
    """

    def __init__(self, inner):
        self.inner = inner
        self._buffer: Dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        v = self._buffer.get(key)
        return v if v is not None else self.inner.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self._buffer[bytes(key)] = bytes(value)

    def update(self, to_remove, to_upsert) -> None:
        for k, v in to_upsert.items():
            self._buffer[bytes(k)] = bytes(v)
