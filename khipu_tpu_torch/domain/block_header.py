"""Block header with the hash identity hash = kec256(rlp(header))
(domain/BlockHeader.scala:17, lazy hash).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes

# keccak256(rlp([])) — ommersHash of an ommerless block.
EMPTY_OMMERS_HASH: bytes = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)


@dataclass(frozen=True)
class BlockHeader:
    parent_hash: bytes
    ommers_hash: bytes
    beneficiary: bytes  # 20-byte miner address
    state_root: bytes
    transactions_root: bytes
    receipts_root: bytes
    logs_bloom: bytes  # 256 bytes
    difficulty: int
    number: int
    gas_limit: int
    gas_used: int
    unix_timestamp: int
    extra_data: bytes = b""
    mix_hash: bytes = b"\x00" * 32
    nonce: bytes = b"\x00" * 8

    def fields(self) -> List[bytes]:
        return [
            self.parent_hash,
            self.ommers_hash,
            self.beneficiary,
            self.state_root,
            self.transactions_root,
            self.receipts_root,
            self.logs_bloom,
            to_minimal_bytes(self.difficulty),
            to_minimal_bytes(self.number),
            to_minimal_bytes(self.gas_limit),
            to_minimal_bytes(self.gas_used),
            to_minimal_bytes(self.unix_timestamp),
            self.extra_data,
            self.mix_hash,
            self.nonce,
        ]

    def encode(self) -> bytes:
        return rlp_encode(self.fields())

    @cached_property
    def hash(self) -> bytes:
        return keccak256(self.encode())

    def encode_without_nonce(self) -> bytes:
        """PoW sealing pre-image (BlockHeader.scala hashWithoutNonce):
        header RLP with mixHash and nonce omitted."""
        return rlp_encode(self.fields()[:13])

    @staticmethod
    def decode(data: bytes) -> "BlockHeader":
        f = rlp_decode(data)
        if len(f) != 15:
            raise ValueError(f"header wants 15 fields, got {len(f)}")
        return BlockHeader(
            parent_hash=f[0],
            ommers_hash=f[1],
            beneficiary=f[2],
            state_root=f[3],
            transactions_root=f[4],
            receipts_root=f[5],
            logs_bloom=f[6],
            difficulty=from_bytes(f[7]),
            number=from_bytes(f[8]),
            gas_limit=from_bytes(f[9]),
            gas_used=from_bytes(f[10]),
            unix_timestamp=from_bytes(f[11]),
            extra_data=f[12],
            mix_hash=f[13],
            nonce=f[14],
        )
