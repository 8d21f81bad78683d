"""Storage façade: the typed node stores, the block stores and the app
state.

The port's counterpart of ``khipu_tpu.storage.storages`` (parity:
khipu-eth/.../storage/Storages.scala:6-81: account/storage/evmcode
NodeStorages, header/body/receipts/td block storages, blocknum, tx,
appState; bestBlockNumber = min(bestBody, bestReceipts) :40) and the
window-commit journal's topic, with ServiceBoard.scala:99-138's engine
selection by ``db.engine``: ``memory`` | ``native`` (the C++ append-log,
``native/store.py``) | ``sqlite`` (the embedded-KV alternative,
``storage/sqlite_engine.py``) | ``kesque`` (the paper's log-structured
segment engine, ``storage/kesque.py``, with segment streaming and
compaction).
"""

from __future__ import annotations

from typing import List, Optional

from khipu_tpu_torch.storage.app_state import AppStateStorage
from khipu_tpu_torch.storage.block_storage import (
    BlockBytesStorage,
    BlockNumberStorage,
    BlockNumbers,
    TotalDifficultyStorage,
    TransactionStorage,
)
from khipu_tpu_torch.storage.datasource import (
    MemoryBlockDataSource,
    MemoryKeyValueDataSource,
    MemoryNodeDataSource,
)
from khipu_tpu_torch.storage.node_storage import NodeStorage


class Storages:
    def __init__(self, engine: str = "memory", data_dir: Optional[str] = None,
                 unconfirmed_depth: int = 20, cache_size: int = 1 << 20):
        self.engine = engine
        # set for engine == "kesque" only: the log-structured engine's
        # compaction and segment-streaming surface (storage/kesque.py)
        self.kesque_engine = None
        if engine == "memory":
            node_src = lambda topic: MemoryNodeDataSource()
            block_src = lambda topic: MemoryBlockDataSource()
            kv_src = lambda topic: MemoryKeyValueDataSource()
        elif engine == "native":
            if data_dir is None:
                raise ValueError("native engine requires data_dir")
            from khipu_tpu_torch.native.store import (
                NativeBlockDataSource,
                NativeKeyValueDataSource,
                NativeNodeDataSource,
            )

            node_src = lambda topic: NativeNodeDataSource(data_dir, topic)
            block_src = lambda topic: NativeBlockDataSource(data_dir, topic)
            kv_src = lambda topic: NativeKeyValueDataSource(data_dir, topic)
        elif engine == "sqlite":
            if data_dir is None:
                raise ValueError("sqlite engine requires data_dir")
            from khipu_tpu_torch.storage.sqlite_engine import (
                SqliteBlockDataSource,
                SqliteKeyValueDataSource,
                SqliteNodeDataSource,
            )

            node_src = lambda topic: SqliteNodeDataSource(data_dir, topic)
            block_src = lambda topic: SqliteBlockDataSource(data_dir, topic)
            kv_src = lambda topic: SqliteKeyValueDataSource(data_dir, topic)
        elif engine == "kesque":
            if data_dir is None:
                raise ValueError("kesque engine requires data_dir")
            from khipu_tpu_torch.storage.kesque import KesqueEngine

            self.kesque_engine = KesqueEngine(data_dir)
            node_src = self.kesque_engine.node_source
            block_src = self.kesque_engine.block_source
            kv_src = self.kesque_engine.kv_source
        else:
            raise ValueError(f"unknown db.engine {engine!r}")

        # topic names match DbConfig.scala:11-21
        self.account_node_storage = NodeStorage(
            node_src("account"), unconfirmed_depth, cache_size)
        self.storage_node_storage = NodeStorage(
            node_src("storage"), unconfirmed_depth, cache_size)
        self.evmcode_storage = NodeStorage(
            node_src("evmcode"), unconfirmed_depth, cache_size)
        self.block_header_storage = BlockBytesStorage(block_src("header"))
        self.block_body_storage = BlockBytesStorage(block_src("body"))
        self.receipts_storage = BlockBytesStorage(block_src("receipts"))
        self.total_difficulty_storage = TotalDifficultyStorage(
            block_src("td"))
        self.block_number_storage = BlockNumberStorage(kv_src("blocknum"))
        self.block_numbers = BlockNumbers(
            self.block_number_storage, self.block_header_storage)
        self.transaction_storage = TransactionStorage(kv_src("tx"))
        self.app_state = AppStateStorage(kv_src("appstate"))
        # write-ahead window-commit journal records (sync/journal.py);
        # same engine and durability as the block stores
        self.journal_source = kv_src("journal")
        self._window_journal = None
        self._node_storages = (
            self.account_node_storage,
            self.storage_node_storage,
            self.evmcode_storage,
        )

    @property
    def window_journal(self):
        """The crash-consistency WAL (lazy: sync/journal.py stays out of
        the storage layer's import graph)."""
        if self._window_journal is None:
            from khipu_tpu_torch.sync.journal import WindowJournal

            self._window_journal = WindowJournal(
                self.journal_source, barrier=self.flush_writes
            )
        return self._window_journal

    @property
    def best_block_number(self) -> int:
        """min(bestBody, bestReceipts) — Storages.scala:40."""
        return min(
            self.block_body_storage.best_block_number,
            self.receipts_storage.best_block_number,
        )

    def attach_mirror(self, mirror) -> None:
        """Route trie-node read misses through the device mirror (nodes
        are readable from the card before they land in the host store).
        evmcode is excluded — code bytes never enter the mirror."""
        self.account_node_storage.mirror = mirror
        self.storage_node_storage.mirror = mirror

    def detach_mirror(self) -> None:
        """Drop the device read-through (the mirror is volatile, so a
        recovery check must see host-durable state only)."""
        self.account_node_storage.mirror = None
        self.storage_node_storage.mirror = None

    def storage_repair_report(self) -> List[str]:
        """Open-time storage-layer repairs (the kesque engine's torn-tail
        scan-back and index rebuilds), as report lines for journal
        recovery to surface. Empty for the memory, native and sqlite
        engines, whose open path performs no repair."""
        if self.kesque_engine is None:
            return []
        return self.kesque_engine.repair_lines()

    def get_node_any(self, h: bytes):
        """One node/code lookup across the three content-addressed
        stores (the serving-side resolution)."""
        for store in self._node_storages:
            v = store.get(h)
            if v is not None:
                return v
        return None

    def node_keys(self) -> List[bytes]:
        """Sorted distinct keys across the three content-addressed
        node stores — the ``StreamNodeData`` iteration surface (live
        rebalance, cluster/rebalance.py). Serves durably-landed nodes
        only (the unconfirmed ring is by definition not yet part of
        the committed state a rebalance moves). Engines whose sources
        cannot enumerate raise, so a rebalance fails loudly instead of
        silently moving nothing."""
        out = set()
        for s in self._node_storages:
            keys = getattr(s.source, "keys", None)
            if keys is None:
                raise RuntimeError(
                    f"{type(s.source).__name__} cannot enumerate node "
                    "keys — live rebalance needs an enumerable node "
                    "store (memory, sqlite or kesque engine)"
                )
            out.update(bytes(k) for k in keys())
        return sorted(out)

    def switch_to_unconfirmed(self) -> None:
        for s in self._node_storages:
            s.switch_to_unconfirmed()

    def clear_unconfirmed(self) -> None:
        for s in self._node_storages:
            s.clear_unconfirmed()

    def _all_sources(self):
        for s in self._node_storages:
            yield s.source
        yield self.block_header_storage.source
        yield self.block_body_storage.source
        yield self.receipts_storage.source
        yield self.total_difficulty_storage.source
        yield self.block_number_storage.source
        yield self.transaction_storage.source
        yield self.app_state.source
        yield self.journal_source

    def flush(self) -> None:
        """Land the node stores' unconfirmed rings and flush every
        source that buffers (the persistent engines)."""
        for s in self._node_storages:
            s.flush()
        for src in self._all_sources():
            fl = getattr(src, "flush", None)
            if fl:
                fl()

    def flush_writes(self) -> None:
        """Make every write so far survive a process death: a source
        marked ``buffered`` (the native engine's, which keep each topic's
        newest appends in a stdio buffer) hands them to the OS (no fsync:
        the guarantee is against the process dying, as for the other
        engines). The sqlite and kesque sources write through on every
        put and are not marked. The commit journal calls this before a
        commit mark, and ``Blockchain.save_block`` after each block."""
        for src in self._all_sources():
            if getattr(src, "buffered", False):
                src.flush()

    def stop(self) -> None:
        """Flush, then close every source (a persistent engine's files
        can then be reopened by a new ``Storages``)."""
        self.flush()
        for src in self._all_sources():
            stop = getattr(src, "stop", None)
            if stop:
                stop()
