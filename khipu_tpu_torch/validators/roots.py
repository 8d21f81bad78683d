"""List roots over ephemeral tries (validators/MptListValidator.scala
role, used by BlockValidator.scala:82-142): the i-th item is stored at
key rlp(i), value = item RLP; root must match the header field.

The ephemeral build goes through the level-synchronous bulk path with
the host hasher (the native sponge): at a block's size the card's round
trip would cost more than the hashing.
"""

from __future__ import annotations

from typing import List, Sequence

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.rlp import rlp_encode
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.receipt import Receipt
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.evm.dataword import to_minimal_bytes
from khipu_tpu_torch.trie.bulk import bulk_build, host_hasher


def _list_root(encoded_items: Sequence[bytes]) -> bytes:
    pairs = [
        (rlp_encode(to_minimal_bytes(i)), item)
        for i, item in enumerate(encoded_items)
    ]
    # host-hashed, as in the JAX package: these tries are a few dozen
    # nodes, and the port's bulk_build would otherwise default to the card
    root, _ = bulk_build(pairs, hasher=host_hasher, device="cpu")
    return root


def transactions_root(txs: Sequence[SignedTransaction]) -> bytes:
    """BlockValidator.validateTransactionRoot (:82)."""
    return _list_root([tx.encode() for tx in txs])


def receipts_root(receipts: Sequence[Receipt]) -> bytes:
    """BlockValidator.validateReceipts (:121)."""
    return _list_root([r.encode() for r in receipts])


def ommers_hash(ommers: Sequence[BlockHeader]) -> bytes:
    """kec256(rlp(ommer list)) (BlockValidator :102)."""
    from khipu_tpu_torch.base.rlp import rlp_decode

    return keccak256(
        rlp_encode([rlp_decode(o.encode()) for o in ommers])
    )
