"""devp2p + eth (PV62/63) wire messages.

Parity: khipu-eth/.../network/p2p/messages/ — WireProtocol.scala:13
(Hello/Disconnect/Ping/Pong), CommonMessages (Status/NewBlock/
SignedTransactions), PV62.scala:16 (GetBlockHeaders/BlockHeaders/
GetBlockBodies/BlockBodies/NewBlockHashes), PV63.scala:19 (GetNodeData/
NodeData/GetReceipts/Receipts). Frame payload = rlp(msg-code) ++
rlp(body) (p2p base codes 0x00-0x0f; eth sub-protocol offset 0x10).
The port's copy of ``khipu_tpu.network.messages``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes

P2P_VERSION = 5
ETH_VERSION = 63
ETH_OFFSET = 0x10

# p2p base protocol codes
HELLO, DISCONNECT, PING, PONG = 0x00, 0x01, 0x02, 0x03
# eth codes (add ETH_OFFSET on the wire)
STATUS = 0x00
NEW_BLOCK_HASHES = 0x01
TRANSACTIONS = 0x02
GET_BLOCK_HEADERS = 0x03
BLOCK_HEADERS = 0x04
GET_BLOCK_BODIES = 0x05
BLOCK_BODIES = 0x06
NEW_BLOCK = 0x07
GET_NODE_DATA = 0x0D
NODE_DATA = 0x0E
GET_RECEIPTS = 0x0F
RECEIPTS = 0x10


def encode_message(code: int, body) -> bytes:
    """Frame payload: rlp(code) ++ rlp(body)."""
    return rlp_encode(to_minimal_bytes(code)) + rlp_encode(body)


def decode_message(payload: bytes) -> Tuple[int, object]:
    # rlp(code) is a single small int: 1 byte (0x80 = 0)
    code = 0 if payload[0] == 0x80 else payload[0]
    return code, rlp_decode(payload[1:])


@dataclass
class Hello:
    client_id: str
    capabilities: List[Tuple[str, int]] = field(
        default_factory=lambda: [("eth", ETH_VERSION)]
    )
    listen_port: int = 30303
    node_id: bytes = b"\x00" * 64
    p2p_version: int = P2P_VERSION

    def body(self):
        return [
            to_minimal_bytes(self.p2p_version),
            self.client_id.encode(),
            [[name.encode(), to_minimal_bytes(v)]
             for name, v in self.capabilities],
            to_minimal_bytes(self.listen_port),
            self.node_id,
        ]

    @staticmethod
    def from_body(b) -> "Hello":
        return Hello(
            p2p_version=from_bytes(b[0]),
            client_id=b[1].decode(errors="replace"),
            capabilities=[(c[0].decode(), from_bytes(c[1])) for c in b[2]],
            listen_port=from_bytes(b[3]),
            node_id=b[4],
        )


@dataclass
class Status:
    """eth Status (CommonMessages): protocol/network/TD/best/genesis."""

    protocol_version: int
    network_id: int
    total_difficulty: int
    best_hash: bytes
    genesis_hash: bytes

    def body(self):
        return [
            to_minimal_bytes(self.protocol_version),
            to_minimal_bytes(self.network_id),
            to_minimal_bytes(self.total_difficulty),
            self.best_hash,
            self.genesis_hash,
        ]

    @staticmethod
    def from_body(b) -> "Status":
        return Status(
            protocol_version=from_bytes(b[0]),
            network_id=from_bytes(b[1]),
            total_difficulty=from_bytes(b[2]),
            best_hash=b[3],
            genesis_hash=b[4],
        )


@dataclass
class GetBlockHeaders:
    """PV62: block (hash | number), maxHeaders, skip, reverse."""

    block: Union[int, bytes]
    max_headers: int = 1
    skip: int = 0
    reverse: bool = False

    def body(self):
        start = (
            self.block
            if isinstance(self.block, bytes)
            else to_minimal_bytes(self.block)
        )
        return [
            start,
            to_minimal_bytes(self.max_headers),
            to_minimal_bytes(self.skip),
            to_minimal_bytes(1 if self.reverse else 0),
        ]

    @staticmethod
    def from_body(b) -> "GetBlockHeaders":
        block = b[0] if len(b[0]) == 32 else from_bytes(b[0])
        return GetBlockHeaders(
            block, from_bytes(b[1]), from_bytes(b[2]), bool(from_bytes(b[3]))
        )


def encode_headers(headers: List[BlockHeader]):
    return [rlp_decode(h.encode()) for h in headers]


def decode_headers(body) -> List[BlockHeader]:
    return [BlockHeader.decode(rlp_encode(item)) for item in body]


def encode_bodies(bodies: List[BlockBody]):
    return [rlp_decode(b.encode()) for b in bodies]


def decode_bodies(body) -> List[BlockBody]:
    return [BlockBody.decode(rlp_encode(item)) for item in body]


def encode_transactions(txs: List[SignedTransaction]):
    return [rlp_decode(t.encode()) for t in txs]


def decode_transactions(body) -> List[SignedTransaction]:
    return [SignedTransaction.decode(rlp_encode(item)) for item in body]


def encode_new_block_hashes(pairs: List[Tuple[bytes, int]]):
    """NewBlockHashes (PV62.scala:16): [[hash, number], ...] — the
    lightweight announce sent to peers that don't get the full block."""
    return [[h, to_minimal_bytes(n)] for h, n in pairs]


def decode_new_block_hashes(body) -> List[Tuple[bytes, int]]:
    return [(item[0], from_bytes(item[1])) for item in body]


def encode_new_block(block: Block, td: int):
    return [rlp_decode(block.encode()), to_minimal_bytes(td)]


def decode_new_block(body) -> Tuple[Block, int]:
    return Block.decode(rlp_encode(body[0])), from_bytes(body[1])
