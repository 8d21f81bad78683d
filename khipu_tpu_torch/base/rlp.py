"""Recursive Length Prefix (RLP) codec.

Behavioral parity with the reference codec
(khipu-base/src/main/scala/khipu/rlp/RLP.scala:35 — encode/decode of the
RLPValue/RLPList ADT). Items are ``bytes`` or (nested) lists of items;
``RLPList`` is an alias kept for call-site readability.

Encoding rules (Yellow Paper app. B):
  * single byte < 0x80 encodes as itself
  * 0-55 byte string: 0x80+len prefix
  * longer string: 0xb7+len(len) prefix then big-endian length
  * 0-55 byte list payload: 0xc0+len prefix
  * longer list payload: 0xf7+len(len) prefix then big-endian length

This is the pure-Python codec only: the port carries no native
extension, so every caller runs the same code on every host.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union

from khipu_tpu_torch.base.bytes_util import big_endian_to_int, int_to_big_endian

RLPItem = Union[bytes, bytearray, Sequence[Any]]
RLPList = list  # decoded lists are plain Python lists


class RLPError(Exception):
    pass


# Real chain objects nest a handful of levels (block = list of lists of
# tx fields; MPT nodes encode one node at a time). A cap well below
# Python's recursion limit turns adversarial deeply-nested peer input
# into a clean RLPError instead of an uncatchable RecursionError.
MAX_DEPTH = 64


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    length_bytes = int_to_big_endian(length)
    return bytes([offset + 55 + len(length_bytes)]) + length_bytes


# single-byte string headers, precomputed (hot: every trie node field)
_STR_HDR = [bytes([0x80 + n]) for n in range(56)]


def _py_rlp_encode(item: RLPItem, _depth: int = 0) -> bytes:
    """Encode bytes / nested lists of bytes (pure-Python reference)."""
    if type(item) is bytes:  # fast path: the overwhelmingly common case
        n = len(item)
        if n == 1 and item[0] < 0x80:
            return item
        if n < 56:
            return _STR_HDR[n] + item
        return _encode_length(n, 0x80) + item
    if isinstance(item, bytearray):
        return _py_rlp_encode(bytes(item), _depth)
    if isinstance(item, (list, tuple)):
        if _depth >= MAX_DEPTH:
            raise RLPError("RLP nesting exceeds MAX_DEPTH")
        payload = b"".join(
            [_py_rlp_encode(sub, _depth + 1) for sub in item]
        )
        return _encode_length(len(payload), 0xC0) + payload
    raise RLPError(f"cannot RLP-encode {type(item)!r}")


rlp_encode = _py_rlp_encode


def _decode_at(data: bytes, pos: int, _depth: int = 0) -> Tuple[Any, int]:
    if pos >= len(data):
        raise RLPError("truncated RLP input")
    b0 = data[pos]
    if b0 < 0x80:
        return bytes([b0]), pos + 1
    if b0 <= 0xB7:  # short string
        length = b0 - 0x80
        end = pos + 1 + length
        if end > len(data):
            raise RLPError("truncated string")
        s = data[pos + 1 : end]
        if length == 1 and s[0] < 0x80:
            raise RLPError("non-canonical single byte")
        return s, end
    if b0 <= 0xBF:  # long string
        ll = b0 - 0xB7
        if pos + 1 + ll > len(data):
            raise RLPError("truncated length")
        length = int.from_bytes(data[pos + 1 : pos + 1 + ll], "big")
        if length < 56 or (ll > 1 and data[pos + 1] == 0):
            raise RLPError("non-canonical length")
        start = pos + 1 + ll
        end = start + length
        if end > len(data):
            raise RLPError("truncated string")
        return data[start:end], end
    if b0 <= 0xF7:  # short list
        length = b0 - 0xC0
        end = pos + 1 + length
        if end > len(data):
            raise RLPError("truncated list")
        return _decode_list(data, pos + 1, end, _depth), end
    # long list
    ll = b0 - 0xF7
    if pos + 1 + ll > len(data):
        raise RLPError("truncated length")
    length = int.from_bytes(data[pos + 1 : pos + 1 + ll], "big")
    if length < 56 or (ll > 1 and data[pos + 1] == 0):
        raise RLPError("non-canonical length")
    start = pos + 1 + ll
    end = start + length
    if end > len(data):
        raise RLPError("truncated list")
    return _decode_list(data, start, end, _depth), end


def _decode_list(data: bytes, start: int, end: int, _depth: int = 0) -> List[Any]:
    if _depth >= MAX_DEPTH:
        raise RLPError("RLP nesting exceeds MAX_DEPTH")
    items: List[Any] = []
    pos = start
    while pos < end:
        item, pos = _decode_at(data, pos, _depth + 1)
        if pos > end:
            raise RLPError("list element overruns list payload")
        items.append(item)
    return items


def _py_rlp_decode(data: bytes) -> Any:
    """Decode a single RLP item; raises on trailing bytes."""
    item, pos = _decode_at(bytes(data), 0)
    if pos != len(data):
        raise RLPError(f"trailing bytes after RLP item ({len(data) - pos})")
    return item


rlp_decode = _py_rlp_decode


def rlp_decode_first(data: bytes):
    """Decode the first RLP item, tolerating trailing bytes — EIP-8
    handshake bodies append random padding after the list. Returns
    (item, bytes_consumed)."""
    return _decode_at(data, 0)


def rlp_encode_int(value: int) -> bytes:
    """Encode a non-negative scalar (minimal big-endian, 0 -> empty string)."""
    if value < 0:
        raise RLPError("RLP scalars are non-negative")
    return rlp_encode(int_to_big_endian(value))


def decode_int(data: bytes) -> int:
    """Interpret a decoded RLP string as a scalar."""
    if len(data) > 0 and data[0] == 0:
        raise RLPError("leading zero in RLP scalar")
    return big_endian_to_int(data)
