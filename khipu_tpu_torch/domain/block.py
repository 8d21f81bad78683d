"""Block = header + body(transactions, ommers) (domain/Block.scala)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.transaction import SignedTransaction


@dataclass(frozen=True)
class BlockBody:
    transactions: Tuple[SignedTransaction, ...] = ()
    ommers: Tuple[BlockHeader, ...] = ()

    def encode(self) -> bytes:
        return rlp_encode(
            [
                [rlp_decode(tx.encode()) for tx in self.transactions],
                [rlp_decode(o.encode()) for o in self.ommers],
            ]
        )

    @staticmethod
    def decode(data: bytes) -> "BlockBody":
        txs, ommers = rlp_decode(data)
        return BlockBody(
            tuple(SignedTransaction.decode(rlp_encode(t)) for t in txs),
            tuple(BlockHeader.decode(rlp_encode(o)) for o in ommers),
        )


@dataclass(frozen=True)
class Block:
    header: BlockHeader
    body: BlockBody = BlockBody()

    @property
    def hash(self) -> bytes:
        return self.header.hash

    @property
    def number(self) -> int:
        return self.header.number

    def encode(self) -> bytes:
        """Wire form: rlp([header, txs, ommers]) (PV62 block codec)."""
        return rlp_encode(
            [
                rlp_decode(self.header.encode()),
                [rlp_decode(tx.encode()) for tx in self.body.transactions],
                [rlp_decode(o.encode()) for o in self.body.ommers],
            ]
        )

    @staticmethod
    def decode(data: bytes) -> "Block":
        header, txs, ommers = rlp_decode(data)
        return Block(
            BlockHeader.decode(rlp_encode(header)),
            BlockBody(
                tuple(SignedTransaction.decode(rlp_encode(t)) for t in txs),
                tuple(BlockHeader.decode(rlp_encode(o)) for o in ommers),
            ),
        )
