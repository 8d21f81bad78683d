"""Consensus validators (khipu-eth/.../validators/)."""

from khipu_tpu_torch.validators.roots import (
    ommers_hash,
    receipts_root,
    transactions_root,
)
from khipu_tpu_torch.validators.validators import (
    BlockValidator,
    HeaderValidationError,
    BlockHeaderValidator,
    ValidationError,
)

__all__ = [
    "BlockHeaderValidator",
    "BlockValidator",
    "HeaderValidationError",
    "ValidationError",
    "ommers_hash",
    "receipts_root",
    "transactions_root",
]
