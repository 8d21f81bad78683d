"""Transaction receipts and log entries.

Parity: domain/Receipt.scala:7-22 (post-tx-state root pre-Byzantium vs
one-byte status per EIP-658 after) and domain/TxLogEntry.scala.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes


@dataclass(frozen=True)
class TxLogEntry:
    address: bytes  # 20 bytes
    topics: Tuple[bytes, ...]  # each 32 bytes
    data: bytes

    def fields(self):
        return [self.address, list(self.topics), self.data]


@dataclass(frozen=True)
class Receipt:
    # pre-Byzantium: 32-byte post-tx state root; after: int status (0|1)
    post_tx_state: Union[bytes, int]
    cumulative_gas_used: int
    logs_bloom: bytes  # 256 bytes
    logs: Tuple[TxLogEntry, ...] = ()

    def encode(self) -> bytes:
        if isinstance(self.post_tx_state, int):
            state = to_minimal_bytes(self.post_tx_state)  # EIP-658 status
        else:
            state = self.post_tx_state
        return rlp_encode(
            [
                state,
                to_minimal_bytes(self.cumulative_gas_used),
                self.logs_bloom,
                [log.fields() for log in self.logs],
            ]
        )

    @staticmethod
    def decode(data: bytes) -> "Receipt":
        state, gas, bloom, logs = rlp_decode(data)
        post: Union[bytes, int]
        if len(state) == 32:
            post = state
        else:
            post = from_bytes(state)
        return Receipt(
            post,
            from_bytes(gas),
            bloom,
            tuple(
                TxLogEntry(addr, tuple(topics), ldata)
                for addr, topics, ldata in logs
            ),
        )


def encode_receipts(receipts: List[Receipt]) -> bytes:
    """Storage codec for a block's receipts (ReceiptsStorage.scala RLP
    seq)."""
    return rlp_encode([rlp_decode(r.encode()) for r in receipts])


def decode_receipts(data: bytes) -> List[Receipt]:
    return [Receipt.decode(rlp_encode(item)) for item in rlp_decode(data)]
