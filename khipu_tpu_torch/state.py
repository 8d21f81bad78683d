"""Carry state from the JAX package into the port.

This system has no weights: its state — the content-addressed node
dict ``{hash: rlp}`` that ``khipu_tpu``'s ``bulk_build`` returns or its
``persist`` writes — plays their part. The dict is plain bytes, so the
port takes it as it is, without importing anything of the JAX package.
"""

from __future__ import annotations

from typing import Mapping

from khipu_tpu_torch.storage.datasource import MemoryNodeDataSource


def load_reference_nodes(nodes: Mapping[bytes, bytes]) -> MemoryNodeDataSource:
    """A port node store holding ``nodes`` ({node_hash: node_rlp})."""
    src = MemoryNodeDataSource()
    src.update([], {bytes(k): bytes(v) for k, v in nodes.items()})
    return src
