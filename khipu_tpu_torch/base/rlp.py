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

``rlp_encode`` / ``rlp_decode`` run the C codec
(``native/csrc_ext/rlp_ext.c``), built by ``native/build.py`` at the
first call; ``_py_rlp_encode`` / ``_py_rlp_decode`` are the pure-Python
oracles the tests hold it against.
"""

from __future__ import annotations

import sys
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


# The C codec: the hottest host loop of trie commits (every node encode,
# the seal stage's scan of the staged nodes, fast sync's child walk).
# The names start as one-hop forwarders through ``_impl``. The first
# call builds and loads the extension synchronously (a failed build
# raises: there is no pure-Python fallback), points ``_impl`` at its
# functions and rebinds ``rlp_encode`` / ``rlp_decode`` here and in every
# loaded port module that imported the forwarders by value; a module
# imported later takes the C functions from here.
def _bind_rlp_ext() -> None:
    global rlp_encode, rlp_decode
    from khipu_tpu_torch.native.build import load_rlp_ext

    ext = load_rlp_ext()
    ext._set_error(RLPError)
    _impl[0], _impl[1] = ext.encode, ext.decode
    swaps = ((_forward_encode, ext.encode), (_forward_decode, ext.decode))
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("khipu_tpu_torch."):
            continue
        for attr, (forwarder, fn) in zip(("rlp_encode", "rlp_decode"),
                                         swaps):
            if getattr(mod, attr, None) is forwarder:
                setattr(mod, attr, fn)


def _first_encode(item):
    _bind_rlp_ext()
    return _impl[0](item)


def _first_decode(data):
    _bind_rlp_ext()
    return _impl[1](data)


_impl = [_first_encode, _first_decode]


def rlp_encode(item: RLPItem) -> bytes:
    """Encode bytes / nested lists of bytes (the C codec)."""
    return _impl[0](item)


def rlp_decode(data: bytes) -> Any:
    """Decode a single RLP item; raises on trailing bytes (the C codec)."""
    return _impl[1](data)


_forward_encode, _forward_decode = rlp_encode, rlp_decode


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
