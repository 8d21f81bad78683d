"""Keccak-256 (original Keccak padding 0x01, NOT NIST SHA-3 0x06).

``keccak256`` hashes one message on the host through the native C++
sponge (``khipu_tpu_torch/native/csrc/keccak.cc``, built with g++ at the
first hash; a failed build raises), and ``keccak512`` (rate 72, Ethash's
cache and dataset items) through the same sponge. ``keccak256_py`` and
``keccak512_py`` are the pure-Python sponge, about half a millisecond a
hash on one CPU core: the oracles the native and batched paths are
tested against. Batches go through
``khipu_tpu_torch.ops.keccak`` — the plain PyTorch sponge on the CPU,
the hand-written CUDA kernel on the card.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1

# Round constants for Keccak-f[1600].
ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rho rotation offsets, indexed [x][y] with lane index = x + 5*y.
ROTATION = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(value: int, shift: int) -> int:
    return ((value << shift) | (value >> (64 - shift))) & MASK64


def keccak_f1600(state: list) -> None:
    """In-place Keccak-f[1600] permutation over 25 int lanes."""
    for rc in ROUND_CONSTANTS:
        # theta
        c = [
            state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    state[x + 5 * y], ROTATION[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & MASK64
                )
        # iota
        state[0] ^= rc


def keccak_pad(data: bytes, rate: int, domain: int = 0x01) -> bytes:
    """Multi-rate pad10*1. domain=0x01 is original Keccak (Ethereum)."""
    pad_len = rate - (len(data) % rate)
    padding = bytearray(pad_len)
    padding[0] = domain
    padding[-1] |= 0x80
    return data + bytes(padding)


def _keccak(data: bytes, rate: int, out_len: int, domain: int = 0x01) -> bytes:
    state = [0] * 25
    padded = keccak_pad(data, rate, domain)
    lanes = rate // 8
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(lanes):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        keccak_f1600(state)
    out = bytearray()
    while len(out) < out_len:
        for i in range(lanes):
            out += state[i].to_bytes(8, "little")
            if len(out) >= out_len:
                break
        if len(out) < out_len:
            keccak_f1600(state)
    return bytes(out[:out_len])


def keccak256_py(data: bytes) -> bytes:
    """Pure-Python keccak-256 (rate 136)."""
    return _keccak(bytes(data), 136, 32)


def keccak512_py(data: bytes) -> bytes:
    """Pure-Python keccak-512 (rate 72)."""
    return _keccak(bytes(data), 72, 64)


_native_keccak256 = None
_native_keccak512 = None


def keccak256(data: bytes) -> bytes:
    """keccak-256 (rate 136) of one message, through the native sponge."""
    global _native_keccak256
    if _native_keccak256 is None:
        from khipu_tpu_torch.native.keccak import keccak256 as native

        _native_keccak256 = native
    return _native_keccak256(data)


def keccak512(data: bytes) -> bytes:
    """keccak-512 (rate 72) of one message, through the native sponge;
    Ethash's cache and dataset items use it."""
    global _native_keccak512
    if _native_keccak512 is None:
        from khipu_tpu_torch.native.keccak import keccak512 as native

        _native_keccak512 = native
    return _native_keccak512(data)
