"""Storage façade: the typed node stores, the block stores and the app
state.

The port's counterpart of ``khipu_tpu.storage.storages`` (parity:
khipu-eth/.../storage/Storages.scala:6-81: account/storage/evmcode
NodeStorages, header/body/receipts/td block storages, blocknum, tx,
appState; bestBlockNumber = min(bestBody, bestReceipts) :40) and the
window-commit journal's topic. It carries the ``memory`` engine only;
the native, sqlite and kesque engines are not ported yet.
"""

from __future__ import annotations

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
    def __init__(self, engine: str = "memory"):
        if engine != "memory":
            raise ValueError(
                f"db.engine {engine!r} is not ported; khipu_tpu_torch has "
                "the 'memory' engine only"
            )
        self.engine = engine
        # topic names match DbConfig.scala:11-21
        self.account_node_storage = NodeStorage(MemoryNodeDataSource())
        self.storage_node_storage = NodeStorage(MemoryNodeDataSource())
        self.evmcode_storage = NodeStorage(MemoryNodeDataSource())
        self.block_header_storage = BlockBytesStorage(MemoryBlockDataSource())
        self.block_body_storage = BlockBytesStorage(MemoryBlockDataSource())
        self.receipts_storage = BlockBytesStorage(MemoryBlockDataSource())
        self.total_difficulty_storage = TotalDifficultyStorage(
            MemoryBlockDataSource())
        self.block_number_storage = BlockNumberStorage(
            MemoryKeyValueDataSource())
        self.block_numbers = BlockNumbers(
            self.block_number_storage, self.block_header_storage)
        self.transaction_storage = TransactionStorage(
            MemoryKeyValueDataSource())
        self.app_state = AppStateStorage(MemoryKeyValueDataSource())
        # write-ahead window-commit journal records (sync/journal.py);
        # same engine and durability as the block stores
        self.journal_source = MemoryKeyValueDataSource()
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

            self._window_journal = WindowJournal(self.journal_source)
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

    def get_node_any(self, h: bytes):
        """One node/code lookup across the three content-addressed
        stores (the serving-side resolution)."""
        for store in self._node_storages:
            v = store.get(h)
            if v is not None:
                return v
        return None
