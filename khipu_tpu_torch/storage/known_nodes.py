"""Persisted peer URIs (storage/KnownNodesStorage.scala).

The port's counterpart of ``khipu_tpu.storage.known_nodes``."""

from __future__ import annotations

from typing import Set

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode


class KnownNodesStorage:
    KEY = b"known-nodes"

    def __init__(self, source):
        self.source = source

    def get_known_nodes(self) -> Set[str]:
        raw = self.source.get(self.KEY)
        if raw is None:
            return set()
        return {uri.decode() for uri in rlp_decode(raw)}

    def update_known_nodes(
        self, to_add: Set[str] = frozenset(), to_remove: Set[str] = frozenset()
    ) -> Set[str]:
        nodes = (self.get_known_nodes() | set(to_add)) - set(to_remove)
        self.source.put(
            self.KEY, rlp_encode([uri.encode() for uri in sorted(nodes)])
        )
        return nodes
