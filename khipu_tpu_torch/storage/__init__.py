"""Storage: the DataSource SPI, the memory and sqlite engines (the
native append-log engine is ``native/store.py``), the Kesque segment
engine, node stores with their reorg ring and read cache, the remote
read-through, the app state, the ``Storages`` façade, the device node
mirror and the compactor."""

from khipu_tpu_torch.storage.datasource import (
    BlockDataSource,
    DataSource,
    KeyValueDataSource,
    MemoryBlockDataSource,
    MemoryKeyValueDataSource,
    MemoryNodeDataSource,
    NodeDataSource,
)
from khipu_tpu_torch.storage.cache import Clock, FIFOCache
from khipu_tpu_torch.storage.unconfirmed import SimpleMapWithUnconfirmed
from khipu_tpu_torch.storage.node_storage import (
    NodeStorage,
    ReadOnlyNodeStorage,
)
from khipu_tpu_torch.storage.app_state import AppStateStorage
from khipu_tpu_torch.storage.known_nodes import KnownNodesStorage
from khipu_tpu_torch.storage.remote import RemoteReadThroughNodeStorage
from khipu_tpu_torch.storage.kesque import KesqueEngine, KesqueStore
from khipu_tpu_torch.storage.storages import Storages

__all__ = [
    "AppStateStorage",
    "BlockDataSource",
    "Clock",
    "DataSource",
    "FIFOCache",
    "KesqueEngine",
    "KesqueStore",
    "KeyValueDataSource",
    "KnownNodesStorage",
    "MemoryBlockDataSource",
    "MemoryKeyValueDataSource",
    "MemoryNodeDataSource",
    "NodeDataSource",
    "NodeStorage",
    "ReadOnlyNodeStorage",
    "RemoteReadThroughNodeStorage",
    "SimpleMapWithUnconfirmed",
    "Storages",
]
