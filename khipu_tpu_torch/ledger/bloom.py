"""2048-bit log bloom filter (YP 4.4.1; ledger/BloomFilter.scala:9).

Three bits per item: from kec256(item), take byte pairs (0,1), (2,3),
(4,5), each mod 2048, set those bits in a 256-byte array (bit 0 = the
lowest-order bit of the LAST byte, i.e. big-endian bit numbering).
"""

from __future__ import annotations

from typing import Iterable

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.domain.receipt import TxLogEntry

BLOOM_BYTES = 256
EMPTY_BLOOM = b"\x00" * BLOOM_BYTES


def _bits(item: bytes):
    h = keccak256(item)
    for i in (0, 2, 4):
        yield ((h[i] << 8) | h[i + 1]) & 2047


def bloom_of_item(item: bytes) -> int:
    out = 0
    for bit in _bits(item):
        out |= 1 << bit
    return out


def bloom_of_logs(logs: Iterable[TxLogEntry]) -> bytes:
    """Bloom over each log's address and every topic."""
    acc = 0
    for log in logs:
        acc |= bloom_of_item(log.address)
        for topic in log.topics:
            acc |= bloom_of_item(topic)
    return acc.to_bytes(BLOOM_BYTES, "big")


def bloom_union(blooms: Iterable[bytes]) -> bytes:
    acc = 0
    for b in blooms:
        acc |= int.from_bytes(b, "big")
    return acc.to_bytes(BLOOM_BYTES, "big")


def bloom_contains(bloom: bytes, item: bytes) -> bool:
    """May-contain check (false positives possible, negatives exact)."""
    b = int.from_bytes(bloom, "big")
    return all(b & (1 << bit) for bit in _bits(item))
