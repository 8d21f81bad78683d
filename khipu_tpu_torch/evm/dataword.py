"""256-bit EVM word arithmetic over native Python ints.

Role of the reference's DataWord (khipu-base/.../DataWord.scala:9,
boundBigInt :64-81): modular-bound 256-bit arithmetic. The reference
wraps java.math.BigInteger in an object per word to dodge JVM alloc
churn; in CPython the idiomatic (and fastest) representation is the
plain int — every helper here is a function, not a class, so the VM's
hot loop pays zero wrapper allocations and the device path never sees
these values at all (device work is hashing, not EVM arithmetic).
"""

from __future__ import annotations

from khipu_tpu_torch.base.bytes_util import int_to_big_endian

SIZE = 32  # bytes per word (DataWord.SIZE)
MOD = 1 << 256
MASK = MOD - 1
SIGN_BIT = 1 << 255
MAX_SIGNED = SIGN_BIT - 1


def u256(x: int) -> int:
    """Bound into [0, 2^256) (boundBigInt, DataWord.scala:64-81)."""
    return x & MASK


def to_signed(x: int) -> int:
    """Two's-complement read of an unsigned word."""
    return x - MOD if x & SIGN_BIT else x


def from_signed(x: int) -> int:
    return x & MASK


def to_bytes32(x: int) -> bytes:
    return (x & MASK).to_bytes(32, "big")


def from_bytes(b: bytes) -> int:
    """Big-endian bytes (any length <= 32) -> word."""
    return int.from_bytes(b[-32:] if len(b) > 32 else b, "big")


def to_minimal_bytes(x: int) -> bytes:
    """Shortest big-endian form; 0 -> b'' (RLP int convention).
    Alias of base.bytes_util.int_to_big_endian — one encoder, one rule."""
    return int_to_big_endian(x)


def sdiv(a: int, b: int) -> int:
    """Signed division truncating toward zero (EVM SDIV)."""
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return from_signed(q)


def smod(a: int, b: int) -> int:
    """Signed modulo; result takes the dividend's sign (EVM SMOD)."""
    if b == 0:
        return 0
    sa, sb = to_signed(a), to_signed(b)
    r = abs(sa) % abs(sb)
    return from_signed(-r if sa < 0 else r)


def signextend(k: int, x: int) -> int:
    """Extend the sign bit of byte k (0 = lowest) through bit 255."""
    if k >= 31:
        return x
    bit = 8 * (k + 1) - 1
    if x & (1 << bit):
        return x | (MASK ^ ((1 << (bit + 1)) - 1))
    return x & ((1 << (bit + 1)) - 1)


def byte_at(i: int, x: int) -> int:
    """i-th byte of the word, 0 = most significant (EVM BYTE)."""
    if i >= 32:
        return 0
    return (x >> (8 * (31 - i))) & 0xFF


def sar(shift: int, x: int) -> int:
    """Arithmetic right shift (EIP-145 SAR)."""
    s = to_signed(x)
    if shift >= 256:
        return MASK if s < 0 else 0
    return from_signed(s >> shift)
