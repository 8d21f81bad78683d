"""Fixture-chain construction: execute txs to derive consensus-true
headers, producing a chain the replay driver can verify bit-exactly.

Role of the reference's mining/BlockGenerator.scala:31 (prepareBlock —
execute the txs, take the resulting roots/gas into the new header),
minus PoW sealing. Used by tests and the replay benchmark to provision
chains offline (no network in this environment).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.domain.difficulty import calc_difficulty
from khipu_tpu_torch.ledger.bloom import bloom_union
from khipu_tpu_torch.ledger.ledger import execute_block
from khipu_tpu_torch.validators.roots import (
    ommers_hash,
    receipts_root,
    transactions_root,
)


class ChainBuilder:
    """Appends consensus-valid blocks by executing their transactions
    (BlockGenerator/prepareBlock role)."""

    def __init__(self, blockchain: Blockchain, config: KhipuConfig,
                 genesis: GenesisSpec):
        self.blockchain = blockchain
        self.config = config
        self.genesis = blockchain.load_genesis(genesis)
        self.head = self.genesis

    @classmethod
    def from_head(cls, blockchain: Blockchain,
                  config: KhipuConfig) -> "ChainBuilder":
        """Attach to an already-initialized chain at its current head
        (the miner's entry point — no genesis loading)."""
        b = cls.__new__(cls)
        b.blockchain = blockchain
        b.config = config
        b.genesis = blockchain.get_block_by_number(0)
        b.head = blockchain.get_block_by_number(
            blockchain.best_block_number
        )
        return b

    def add_block(
        self,
        txs: Sequence[SignedTransaction] = (),
        coinbase: Optional[bytes] = None,
        timestamp: Optional[int] = None,
        extra_data: bytes = b"",
        ommers: Sequence[BlockHeader] = (),
    ) -> Block:
        parent = self.head.header
        ts = (
            timestamp
            if timestamp is not None
            else parent.unix_timestamp + 13
        )
        header = BlockHeader(
            parent_hash=parent.hash,
            ommers_hash=ommers_hash(tuple(ommers)),
            beneficiary=coinbase or parent.beneficiary,
            state_root=b"\x00" * 32,  # filled after execution
            transactions_root=transactions_root(txs),
            receipts_root=b"\x00" * 32,
            logs_bloom=b"\x00" * 256,
            # consensus-true difficulty so replay can validate headers
            difficulty=calc_difficulty(
                ts, parent, self.config.blockchain
            ),
            number=parent.number + 1,
            gas_limit=parent.gas_limit,
            gas_used=0,
            unix_timestamp=ts,
            extra_data=extra_data,
        )
        draft = Block(header, BlockBody(tuple(txs), tuple(ommers)))
        result = execute_block(
            draft,
            parent.state_root,
            self.blockchain.get_world_state,
            self.config,
            validate=False,
        )
        sealed = Block(
            BlockHeader(
                parent_hash=header.parent_hash,
                ommers_hash=header.ommers_hash,
                beneficiary=header.beneficiary,
                state_root=result.world.root_hash,
                transactions_root=header.transactions_root,
                receipts_root=receipts_root(result.receipts),
                logs_bloom=bloom_union(
                    r.logs_bloom for r in result.receipts
                ),
                difficulty=header.difficulty,
                number=header.number,
                gas_limit=header.gas_limit,
                gas_used=result.gas_used,
                unix_timestamp=header.unix_timestamp,
                extra_data=header.extra_data,
            ),
            draft.body,
        )
        td = (self.blockchain.get_total_difficulty(parent.number) or 0) + (
            sealed.header.difficulty
        )
        self.blockchain.save_block(
            sealed, result.receipts, td, result.world
        )
        self.head = sealed
        return sealed
