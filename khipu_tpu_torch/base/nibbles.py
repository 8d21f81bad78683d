"""Hex-prefix (compact) nibble encoding for Merkle Patricia Tries.

Parity with the reference (khipu-base/src/main/scala/khipu/trie/
HexPrefix.scala: encode:11, bytesToNibbles:47). A nibble path is
represented as ``bytes`` whose elements are 0-15.

Compact encoding packs the leaf/extension flag and odd-length bit into
the first nibble:  flags = 2*is_leaf + is_odd.
"""

from __future__ import annotations

from typing import Tuple


# byte -> (hi, lo) nibble pair, precomputed: this runs per trie node on
# every replay/commit hot path (2x the loop formulation)
_EXPAND = [bytes((b >> 4, b & 0x0F)) for b in range(256)]


def bytes_to_nibbles(data: bytes) -> bytes:
    """Expand each byte into (hi, lo) nibbles."""
    return b"".join(map(_EXPAND.__getitem__, data))


def nibbles_to_bytes(nibbles: bytes) -> bytes:
    if len(nibbles) % 2:
        raise ValueError("odd nibble count cannot pack to bytes")
    it = iter(nibbles)
    return bytes(a << 4 | b for a, b in zip(it, it))


def hp_encode(nibbles: bytes, is_leaf: bool) -> bytes:
    """Hex-prefix encode a nibble path (HexPrefix.encode:11)."""
    odd = len(nibbles) % 2
    flag = (2 if is_leaf else 0) + odd
    if odd:
        prefixed = bytes([flag]) + nibbles
    else:
        prefixed = bytes([flag, 0]) + nibbles
    return nibbles_to_bytes(prefixed)


def hp_decode(data: bytes) -> Tuple[bytes, bool]:
    """Inverse of hp_encode → (nibbles, is_leaf)."""
    if not data:
        raise ValueError("empty hex-prefix encoding")
    nibbles = bytes_to_nibbles(data)
    flag = nibbles[0]
    is_leaf = bool(flag & 2)
    if flag & 1:  # odd
        return nibbles[1:], is_leaf
    return nibbles[2:], is_leaf
