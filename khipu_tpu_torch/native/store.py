"""The DataSource implementations over the native append-log store
(csrc/store.cc, bound in ``native/build.py``): the ``db.engine =
"native"`` persistent engine (Kesque role; SURVEY.md §2.3). The port's
copy of ``khipu_tpu.native.store``; a failed build of the host library
raises from the first store opened.

Content-addressed node stores never store keys: reads recompute
keccak256(value) to disambiguate 8-byte short-key collisions, exactly
the reference's KesqueNodeDataSource.scala:61-63 design. Explicit-key
stores serve blocks/KV; a zero-length value is a tombstone (all stored
values here are RLP, which is never empty).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from khipu_tpu_torch.native.build import load_library
from khipu_tpu_torch.storage.datasource import (
    BlockDataSource,
    KeyValueDataSource,
    NodeDataSource,
)


class NativeStoreError(Exception):
    pass


class _NativeStore:
    """One log+index pair; wraps the C handle with a lock (the C side
    is single-threaded by contract)."""

    def __init__(self, data_dir: str, topic: str, content_addressed: bool):
        lib = load_library()  # raises when g++ fails
        os.makedirs(data_dir, exist_ok=True)
        prefix = os.path.join(data_dir, topic)
        self._lib = lib
        self._lock = threading.RLock()
        # appends since the last flush: stdio may still hold them, and a
        # process death would lose them
        self._dirty = False
        self._handle = lib.kstore_open(
            prefix.encode(), 1 if content_addressed else 0
        )
        if not self._handle:
            raise NativeStoreError(f"cannot open store at {prefix}")

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            if self._handle is None:
                raise NativeStoreError("store is closed")
            cap = 4096  # one SSD block, the Kesque fetchMaxBytes default
            while True:
                buf = ctypes.create_string_buffer(cap)
                n = self._lib.kstore_get(
                    self._handle, bytes(key), len(key), buf, cap
                )
                if n < 0:
                    return None
                if n <= cap:
                    return buf.raw[:n]
                cap = int(n)

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if self._handle is None:
                raise NativeStoreError("store is closed")
            rc = self._lib.kstore_put(
                self._handle, bytes(key), len(key), bytes(value), len(value)
            )
            if rc != 0:
                raise NativeStoreError(
                    "append failed (disk full / IO error); log rolled back"
                )
            self._dirty = True

    def flush(self) -> None:
        """Hand the buffered appends to the OS (fflush, no fsync) and
        checkpoint the index header: what a process death leaves on
        disk then holds every record put so far. A store with nothing
        appended since its last flush skips the calls."""
        with self._lock:
            if self._handle is not None and self._dirty:
                self._lib.kstore_flush(self._handle)
                self._dirty = False

    @property
    def count(self) -> int:
        with self._lock:
            if self._handle is None:
                return 0
            return int(self._lib.kstore_count(self._handle))

    @property
    def max_key8(self) -> int:
        with self._lock:
            if self._handle is None:
                return -1
            return int(self._lib.kstore_max_key8(self._handle))

    def close(self) -> None:
        with self._lock:
            if self._handle is not None:
                self._lib.kstore_close(self._handle)
                self._handle = None
                self._dirty = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeNodeDataSource(NodeDataSource):
    """Persistent content-addressed node store (hash -> node RLP)."""

    def __init__(self, data_dir: str, topic: str):
        super().__init__()
        self._store = _NativeStore(data_dir, topic, content_addressed=True)

    def get(self, key: bytes) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            return self._store.get(key)
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        # content-addressed archive: removes are swallowed (NodeStorage
        # semantics), upserts dedup inside the C side
        for k, v in to_upsert.items():
            self._store.put(bytes(k), bytes(v))

    @property
    def count(self) -> int:
        return self._store.count

    def flush(self) -> None:
        self._store.flush()

    # appends sit in a stdio buffer until ``flush``:
    # ``Storages.flush_writes`` flushes the sources that say so
    buffered = True

    def stop(self) -> None:
        self._store.close()


class NativeKeyValueDataSource(KeyValueDataSource):
    """Persistent bytes -> bytes store (blocknum / tx / appState
    topics). Zero-length value = tombstone."""

    def __init__(self, data_dir: str, topic: str):
        super().__init__()
        self._store = _NativeStore(data_dir, topic, content_addressed=False)

    def get(self, key: bytes) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            v = self._store.get(key)
            return v if v else None  # b"" is the tombstone
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        for k in to_remove:
            self._store.put(bytes(k), b"")
        for k, v in to_upsert.items():
            self._store.put(bytes(k), bytes(v))

    @property
    def count(self) -> int:
        return self._store.count

    def flush(self) -> None:
        self._store.flush()

    buffered = True

    def stop(self) -> None:
        self._store.close()


class NativeBlockDataSource(BlockDataSource):
    """Persistent number -> bytes store; keys are 8-byte big-endian so
    the C side can track bestBlockNumber (max_key8)."""

    def __init__(self, data_dir: str, topic: str):
        super().__init__()
        self._store = _NativeStore(data_dir, topic, content_addressed=False)
        self._lock = threading.Lock()
        # max_key8 counts every appended 8-byte key, tombstones included
        # — walk down to the highest LIVE block so a pre-restart reorg
        # cannot leave best pointing at a removed record
        best = self._store.max_key8
        while best >= 0 and not self._store.get(self._key(best)):
            best -= 1
        self._best = best

    @staticmethod
    def _key(number: int) -> bytes:
        return int(number).to_bytes(8, "big")

    def get(self, number: int) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            v = self._store.get(self._key(number))
            return v if v else None
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        with self._lock:
            for n in to_remove:
                self._store.put(self._key(n), b"")
                if int(n) == self._best:
                    # conservative: walk down to the previous live block
                    m = self._best - 1
                    while m >= 0 and not self._store.get(self._key(m)):
                        m -= 1
                    self._best = m
            for n, v in to_upsert.items():
                self._store.put(self._key(n), bytes(v))
                if int(n) > self._best:
                    self._best = int(n)

    @property
    def best_block_number(self) -> int:
        return self._best

    @property
    def count(self) -> int:
        return self._store.count

    def flush(self) -> None:
        self._store.flush()

    buffered = True

    def stop(self) -> None:
        self._store.close()
