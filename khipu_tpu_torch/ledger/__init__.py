"""Ledger: world state, block execution, parallel merge, receipts.

Parity: khipu-eth/src/main/scala/khipu/ledger/ (Ledger.scala,
BlockWorldState.scala, TrieAccounts/TrieStorage, BloomFilter.scala,
BlockRewardCalculator.scala). The port's counterpart of
``khipu_tpu.ledger``.
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
    shutdown_exec_pool,
)
from khipu_tpu_torch.ledger.schedule import (
    Misprediction,
    plan_block,
    reset_templates,
)
from khipu_tpu_torch.ledger.world import BlockWorldState, TrieStorage

__all__ = [
    "BlockExecutionError",
    "BlockResult",
    "BlockWorldState",
    "Misprediction",
    "Stats",
    "TrieStorage",
    "TxResult",
    "TxValidationError",
    "ValidationAfterExecError",
    "bloom_of_logs",
    "bloom_union",
    "execute_block",
    "execute_transaction",
    "plan_block",
    "reset_templates",
    "shutdown_exec_pool",
]
