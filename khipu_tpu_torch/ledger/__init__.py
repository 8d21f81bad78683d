"""Ledger: world state, serial block execution, receipts.

Parity: khipu-eth/src/main/scala/khipu/ledger/ (Ledger.scala,
BlockWorldState.scala, TrieAccounts/TrieStorage, BloomFilter.scala,
BlockRewardCalculator.scala). The port's counterpart of
``khipu_tpu.ledger`` without the parallel and scheduled executors and
the window committer (ROADMAP).
"""

from khipu_tpu_torch.ledger.bloom import bloom_of_logs, bloom_union
from khipu_tpu_torch.ledger.ledger import (
    BlockExecutionError,
    BlockResult,
    Stats,
    TxResult,
    TxValidationError,
    ValidationAfterExecError,
    execute_block,
    execute_transaction,
)
from khipu_tpu_torch.ledger.world import BlockWorldState, TrieStorage

__all__ = [
    "BlockExecutionError",
    "BlockResult",
    "BlockWorldState",
    "Stats",
    "TrieStorage",
    "TxResult",
    "TxValidationError",
    "ValidationAfterExecError",
    "bloom_of_logs",
    "bloom_union",
    "execute_block",
    "execute_transaction",
]
