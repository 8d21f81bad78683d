"""Block-keyed storages + hash<->number mapping.

Parity: khipu-eth/.../storage/ BlockHeaderStorage / BlockBodyStorage /
ReceiptsStorage / TotalDifficultyStorage / BlockNumberStorage /
TransactionStorage (TxLocation) and BlockNumbers.scala:9 (two-way
number<->hash cache with unconfirmed ring).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode


class BlockBytesStorage:
    """number -> bytes over a BlockDataSource."""

    def __init__(self, source):
        self.source = source

    def get(self, number: int) -> Optional[bytes]:
        return self.source.get(number)

    def put(self, number: int, value: bytes) -> None:
        self.source.put(number, value)

    def update(self, to_remove, to_upsert) -> None:
        self.source.update(to_remove, to_upsert)

    @property
    def best_block_number(self) -> int:
        return self.source.best_block_number


class BlockNumberStorage:
    """block-hash -> block-number (BlockNumberStorage.scala)."""

    def __init__(self, source):
        self.source = source

    def get(self, block_hash: bytes) -> Optional[int]:
        v = self.source.get(block_hash)
        return int.from_bytes(v, "big") if v is not None else None

    def put(self, block_hash: bytes, number: int) -> None:
        self.source.put(block_hash, int(number).to_bytes(8, "big"))

    def remove(self, block_hash: bytes) -> None:
        self.source.remove(block_hash)


class TotalDifficultyStorage(BlockBytesStorage):
    def get_td(self, number: int) -> Optional[int]:
        v = self.get(number)
        return int.from_bytes(v, "big") if v is not None else None

    def put_td(self, number: int, td: int) -> None:
        self.put(number, int(td).to_bytes((td.bit_length() + 7) // 8 or 1, "big"))


class TransactionStorage:
    """tx-hash -> TxLocation(blockNumber, index)
    (TransactionStorage.scala)."""

    def __init__(self, source):
        self.source = source

    def get(self, tx_hash: bytes) -> Optional[Tuple[int, int]]:
        v = self.source.get(tx_hash)
        if v is None:
            return None
        number, index = rlp_decode(v)
        return (
            int.from_bytes(number, "big"),
            int.from_bytes(index, "big"),
        )

    def put(self, tx_hash: bytes, block_number: int, index: int) -> None:
        enc = rlp_encode(
            [
                int(block_number).to_bytes(8, "big").lstrip(b"\x00") or b"",
                int(index).to_bytes(4, "big").lstrip(b"\x00") or b"",
            ]
        )
        self.source.put(tx_hash, enc)


class BlockNumbers:
    """RW-locked bidirectional number<->hash maps (BlockNumbers.scala:9)."""

    def __init__(
        self,
        block_number_storage: BlockNumberStorage,
        block_header_storage: Optional[BlockBytesStorage] = None,
    ):
        self._storage = block_number_storage
        self._headers = block_header_storage
        self._num_to_hash: Dict[int, bytes] = {}
        self._hash_to_num: Dict[bytes, int] = {}
        self._lock = threading.RLock()

    def number_of(self, block_hash: bytes) -> Optional[int]:
        # One critical section: the storage read and the map insert must
        # not interleave with remove(), or a reorg-orphaned mapping
        # would be resurrected.
        with self._lock:
            n = self._hash_to_num.get(block_hash)
            if n is not None:
                return n
            n = self._storage.get(block_hash)
            if n is not None:
                self._hash_to_num[block_hash] = n
                self._num_to_hash[n] = block_hash
        return n

    def hash_of(self, number: int) -> Optional[bytes]:
        with self._lock:
            h = self._num_to_hash.get(number)
        if h is not None:
            return h
        # Storage fallback (getHashByBlockNumber, BlockNumbers.scala):
        # after a restart the in-memory maps are empty; derive the hash
        # from the persisted header (hash == keccak256(header rlp)).
        if self._headers is None:
            return None
        header = self._headers.get(number)
        if header is None:
            return None
        from khipu_tpu_torch.base.keccak import keccak256

        h = keccak256(header)
        # Trust the derived hash only while the hash->number record still
        # exists: after remove() (reorg orphaning) the stale header must
        # not resurrect the mapping. The storage re-check happens under
        # the lock so a concurrent remove() cannot interleave between the
        # verification and the map insert.
        with self._lock:
            if self._storage.get(h) != number:
                return None
            self._num_to_hash[number] = h
            self._hash_to_num[h] = number
        return h

    def put(self, block_hash: bytes, number: int) -> None:
        self._storage.put(block_hash, number)
        with self._lock:
            self._hash_to_num[block_hash] = number
            self._num_to_hash[number] = block_hash

    def remove(self, block_hash: bytes) -> None:
        self._storage.remove(block_hash)
        with self._lock:
            n = self._hash_to_num.pop(block_hash, None)
            if n is not None:
                self._num_to_hash.pop(n, None)
