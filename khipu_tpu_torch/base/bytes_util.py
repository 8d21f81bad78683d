"""Byte-level helpers.

Role of the reference's ``khipu-base`` BytesUtil/DataWord byte plumbing
(khipu-base/src/main/scala/khipu/util/BytesUtil.scala,
khipu-base/src/main/scala/khipu/DataWord.scala) in plain Python.
"""

from __future__ import annotations


def int_to_big_endian(value: int) -> bytes:
    """Minimal big-endian encoding; 0 encodes to b'' (RLP scalar rule)."""
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def big_endian_to_int(data: bytes) -> int:
    return int.from_bytes(data, "big")


def int_to_fixed_bytes(value: int, length: int) -> bytes:
    """Big-endian, left-zero-padded to exactly ``length`` bytes."""
    return value.to_bytes(length, "big")


def xor_bytes(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b, strict=True))


def hex_to_bytes(s: str) -> bytes:
    if s.startswith(("0x", "0X")):
        s = s[2:]
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def bytes_to_hex(b: bytes, prefix: bool = True) -> str:
    return ("0x" if prefix else "") + b.hex()
