"""Remote read-through node storage: the self-healing missing-node path.

The port's counterpart of ``khipu_tpu.storage.remote``. Parity:
storage/DistributedNodeStorage.scala:13-57 (read-through the
cluster-sharded NodeEntity cache) and the MPTNodeMissingException
recovery loop (SURVEY §5.3: Ledger.scala:69,511,542 +
RegularSyncService.scala:336-345 — fetch that exact node from a healthy
peer, store it, resume). The fetch callback is a peer pool's
GetNodeData in production, the gRPC bridge or another store in tests;
fetched values are content-address verified (the native host hash)
before being admitted. ``from_cluster`` takes any object with
``fetch(keys)`` and ``replicate(nodes)``.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional

from khipu_tpu_torch.base.keccak import keccak256


class RemoteReadThroughNodeStorage:
    """Wraps a NodeStorage; on local miss, fetches by hash, verifies
    kec256(value) == hash, persists locally, serves the read.

    ``replicate_to`` (a sharded cluster client) additionally
    write-replicates every put onto the key's replica shards, so local
    commits keep the served cluster cache consistent."""

    def __init__(self, inner,
                 fetch: Callable[[List[bytes]], Mapping[bytes, bytes]],
                 replicate_to=None):
        self.inner = inner
        self.fetch = fetch
        self.replicate_to = replicate_to
        self.healed = 0  # nodes recovered from remote

    @classmethod
    def from_cluster(cls, inner, cluster, replicate_writes: bool = False):
        """Back the read-through by a sharded cluster client — per-key
        shard selection, replica failover, breakers — instead of a
        single endpoint. Duck-typed: ``cluster`` needs ``fetch(keys)``
        and, with ``replicate_writes``, ``replicate(nodes)``."""
        return cls(
            inner,
            cluster.fetch,
            replicate_to=cluster if replicate_writes else None,
        )

    def get(self, key: bytes) -> Optional[bytes]:
        v = self.inner.get(key)
        if v is not None:
            return v
        got = self.fetch([key])
        v = got.get(key)
        if v is None:
            return None
        if keccak256(v) != key:
            return None  # corrupt response: do not admit
        self.inner.put(key, v)
        self.healed += 1
        return v

    def put(self, key: bytes, value: bytes) -> None:
        self.inner.put(key, value)
        if self.replicate_to is not None:
            self.replicate_to.replicate({key: value})

    def update(self, to_remove, to_upsert) -> None:
        self.inner.update(to_remove, to_upsert)
        if self.replicate_to is not None and to_upsert:
            self.replicate_to.replicate(to_upsert)

    def __getattr__(self, name):
        return getattr(self.inner, name)
