"""Storage façade: the typed node stores and the app state.

The port's counterpart of ``khipu_tpu.storage.storages`` (parity:
khipu-eth/.../storage/Storages.scala:6-81). It carries the ``memory``
engine only, with the account, storage and evmcode node stores and the
app-state store; the native, sqlite and kesque engines, the block
stores and the window journal are not ported yet.
"""

from __future__ import annotations

from khipu_tpu_torch.storage.app_state import AppStateStorage
from khipu_tpu_torch.storage.datasource import (
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
        self.app_state = AppStateStorage(MemoryKeyValueDataSource())
        self._node_storages = (
            self.account_node_storage,
            self.storage_node_storage,
            self.evmcode_storage,
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
