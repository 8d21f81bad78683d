"""Serve peers' data requests from local storage.

Parity: blockchain/sync/HostService.scala — GetBlockHeaders /
GetBlockBodies / GetReceipts / GetNodeData answered from the chain DB.
Install via ``service.install(peer_manager)``; limits follow the
reference's per-request caps (SURVEY §6: 50 headers / 20 bodies /
5 receipts / 100 nodes).
The port's copy of ``khipu_tpu.network.host_service``.
"""

from __future__ import annotations

from typing import List

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.network.messages import (
    BLOCK_BODIES,
    BLOCK_HEADERS,
    ETH_OFFSET,
    GET_BLOCK_BODIES,
    GET_BLOCK_HEADERS,
    GET_NODE_DATA,
    GET_RECEIPTS,
    NODE_DATA,
    RECEIPTS,
    GetBlockHeaders,
    encode_headers,
)

MAX_HEADERS = 50
MAX_BODIES = 20
MAX_RECEIPTS = 5
MAX_NODES = 100


class HostService:
    def __init__(self, blockchain: Blockchain):
        self.blockchain = blockchain

    def install(self, manager) -> None:
        manager.handlers[ETH_OFFSET + GET_BLOCK_HEADERS] = self.on_get_headers
        manager.handlers[ETH_OFFSET + GET_BLOCK_BODIES] = self.on_get_bodies
        manager.handlers[ETH_OFFSET + GET_RECEIPTS] = self.on_get_receipts
        manager.handlers[ETH_OFFSET + GET_NODE_DATA] = self.on_get_node_data

    def on_get_headers(self, body):
        req = GetBlockHeaders.from_body(body)
        if isinstance(req.block, bytes):
            start = self.blockchain.storages.block_numbers.number_of(req.block)
            if start is None:
                return ETH_OFFSET + BLOCK_HEADERS, []
        else:
            start = req.block
        step = (req.skip + 1) * (-1 if req.reverse else 1)
        headers = []
        n = start
        for _ in range(min(req.max_headers, MAX_HEADERS)):
            if n < 0:
                break
            h = self.blockchain.get_header_by_number(n)
            if h is None:
                break
            headers.append(h)
            n += step
        return ETH_OFFSET + BLOCK_HEADERS, encode_headers(headers)

    def on_get_bodies(self, body):
        out = []
        for block_hash in body[:MAX_BODIES]:
            n = self.blockchain.storages.block_numbers.number_of(block_hash)
            if n is None:
                continue
            raw = self.blockchain.storages.block_body_storage.get(n)
            if raw is not None:
                out.append(rlp_decode(raw))
        return ETH_OFFSET + BLOCK_BODIES, out

    def on_get_receipts(self, body):
        out = []
        for block_hash in body[:MAX_RECEIPTS]:
            n = self.blockchain.storages.block_numbers.number_of(block_hash)
            if n is None:
                continue
            raw = self.blockchain.storages.receipts_storage.get(n)
            if raw is not None:
                out.append(rlp_decode(raw))
        return ETH_OFFSET + RECEIPTS, out

    def on_get_node_data(self, body):
        """Serve trie nodes / code blobs by hash (the fast-sync
        supplier side); lookup shared with the bridge endpoint
        (Storages.get_node_any)."""
        s = self.blockchain.storages
        out: List[bytes] = []
        for h in body[:MAX_NODES]:
            v = s.get_node_any(h)
            if v is not None:
                out.append(v)
        return ETH_OFFSET + NODE_DATA, out
