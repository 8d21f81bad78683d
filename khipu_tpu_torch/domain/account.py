"""Account state record (domain/Account.scala:12, RLP serializer :55).

An account is (nonce, balance, stateRoot, codeHash); the state trie maps
kec256(address) -> rlp(account). stateRoot is the root of the account's
own storage trie; codeHash keys the EVM bytecode in the evmcode store.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

from khipu_tpu_torch.base import EMPTY_KECCAK, EMPTY_TRIE_HASH
from khipu_tpu_torch.base.bytes_util import big_endian_to_int, int_to_big_endian
from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode

EMPTY_STORAGE_ROOT: bytes = EMPTY_TRIE_HASH
EMPTY_CODE_HASH: bytes = EMPTY_KECCAK


def to_minimal_bytes(x: int) -> bytes:
    """Shortest big-endian form; 0 -> b'' (RLP int convention)."""
    return int_to_big_endian(x)


@dataclass(frozen=True)
class Account:
    nonce: int = 0
    balance: int = 0
    storage_root: bytes = EMPTY_STORAGE_ROOT
    code_hash: bytes = EMPTY_CODE_HASH

    def encode(self) -> bytes:
        return rlp_encode(
            [
                to_minimal_bytes(self.nonce),
                to_minimal_bytes(self.balance),
                self.storage_root,
                self.code_hash,
            ]
        )

    @staticmethod
    def decode(data: bytes) -> "Account":
        nonce, balance, root, code_hash = rlp_decode(data)
        return Account(
            big_endian_to_int(nonce), big_endian_to_int(balance), root, code_hash
        )

    def with_nonce(self, nonce: int) -> "Account":
        return replace(self, nonce=nonce)

    def increase_nonce(self, by: int = 1) -> "Account":
        return replace(self, nonce=self.nonce + by)

    def increase_balance(self, by: int) -> "Account":
        return replace(self, balance=self.balance + by)

    @property
    def is_empty(self) -> bool:
        """EIP-161 empty: no code, zero nonce, zero balance. Empty
        accounts touched during execution are deleted post-tx
        (Account.scala isEmpty semantics; note storage_root is NOT part
        of the emptiness test)."""
        return (
            self.nonce == 0
            and self.balance == 0
            and self.code_hash == EMPTY_CODE_HASH
        )

    @property
    def has_code(self) -> bool:
        return self.code_hash != EMPTY_CODE_HASH


@lru_cache(maxsize=1 << 16)
def address_key(address: bytes) -> bytes:
    """State-trie key for an address: keccak256(address). One address at
    a time on the host; a whole state's keys go through
    ``khipu_tpu_torch.ops.keccak.keccak256_fixed`` in one batch."""
    return keccak256(address)
