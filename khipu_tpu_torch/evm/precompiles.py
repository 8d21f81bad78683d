"""Precompiled contracts 0x1-0x9 (vm/PrecompiledContracts.scala:18;
ECRecovery :87, SHA256 :113, RIPEMD160 :128, Identity :143, ModExp :156,
BN128 add/mul/pairing :262-420, BLAKE2BF :421).

Each precompile is ``(gas_fn(input, config), run(input) -> bytes|None)``;
``None`` means precompile-level failure (consumes all gas — only the
post-Byzantium precompiles can fail). ECRECOVER oddity preserved: bad
signatures return *empty output with success*.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Callable, Dict, Optional, Tuple

from khipu_tpu_torch.base.secp256k1 import (
    N as _SECP_N,
    SignatureError,
    ecdsa_recover,
    pubkey_to_address,
)
from khipu_tpu_torch.evm.ripemd160 import ripemd160


def _words(n: int) -> int:
    return (n + 31) // 32


# ------------------------------------------------------------ 0x1-0x4


def _ecrecover_gas(data: bytes, config) -> int:
    return 3000


def _ecrecover(data: bytes) -> bytes:
    data = data[:128].ljust(128, b"\x00")
    h, v_b, r_b, s_b = data[:32], data[32:64], data[64:96], data[96:128]
    v = int.from_bytes(v_b, "big")
    r = int.from_bytes(r_b, "big")
    s = int.from_bytes(s_b, "big")
    if v not in (27, 28) or not (0 < r < _SECP_N and 0 < s < _SECP_N):
        return b""
    try:
        pub = ecdsa_recover(h, v - 27, r, s)
    except SignatureError:
        return b""
    return pubkey_to_address(pub).rjust(32, b"\x00")


def _sha256_gas(data: bytes, config) -> int:
    return 60 + 12 * _words(len(data))


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _ripemd_gas(data: bytes, config) -> int:
    return 600 + 120 * _words(len(data))


def _ripemd(data: bytes) -> bytes:
    return ripemd160(data).rjust(32, b"\x00")


def _identity_gas(data: bytes, config) -> int:
    return 15 + 3 * _words(len(data))


def _identity(data: bytes) -> bytes:
    return data


# ------------------------------------------------------- 0x5 MODEXP


def _modexp_parts(data: bytes) -> Tuple[int, int, int, bytes, bytes, bytes]:
    def word(i):
        return int.from_bytes(data[i : i + 32].ljust(32, b"\x00"), "big")

    base_len, exp_len, mod_len = word(0), word(32), word(64)
    body = data[96:]

    def chunk(offset, size):
        return body[offset : offset + size].ljust(size, b"\x00")

    return (
        base_len,
        exp_len,
        mod_len,
        chunk(0, base_len),
        chunk(base_len, exp_len),
        chunk(base_len + exp_len, mod_len),
    )


def _modexp_gas(data: bytes, config) -> int:
    """EIP-198 gas: floor(mult_complexity(max(b,m)) * max(adj_exp, 1) / 20)."""
    base_len, exp_len, mod_len, _, exp_b, _ = _modexp_parts(data)
    max_len = max(base_len, mod_len)
    if max_len <= 64:
        mult = max_len * max_len
    elif max_len <= 1024:
        mult = max_len * max_len // 4 + 96 * max_len - 3072
    else:
        mult = max_len * max_len // 16 + 480 * max_len - 199_680
    # adjusted exponent length over the first 32 exponent bytes
    head = int.from_bytes(exp_b[:32], "big")
    if exp_len <= 32:
        adj = head.bit_length() - 1 if head else 0
    else:
        adj = 8 * (exp_len - 32) + (head.bit_length() - 1 if head else 0)
    return mult * max(adj, 1) // 20


def _modexp(data: bytes) -> bytes:
    _, _, mod_len, base_b, exp_b, mod_b = _modexp_parts(data)
    if mod_len == 0:
        return b""
    base = int.from_bytes(base_b, "big")
    exp = int.from_bytes(exp_b, "big")
    mod = int.from_bytes(mod_b, "big")
    out = 0 if mod == 0 else pow(base, exp, mod)
    return out.to_bytes(mod_len, "big")


# ------------------------------------------------- 0x6-0x8 BN128


def _bn_add_gas(data: bytes, config) -> int:
    return 150 if config.istanbul else 500  # EIP-1108


def _bn_mul_gas(data: bytes, config) -> int:
    return 6_000 if config.istanbul else 40_000


def _bn_pairing_gas(data: bytes, config) -> int:
    k = len(data) // 192
    if config.istanbul:
        return 45_000 + 34_000 * k
    return 100_000 + 80_000 * k


def _bn_add(data: bytes) -> Optional[bytes]:
    from khipu_tpu_torch.evm import bn128

    return bn128.add_points(data)


def _bn_mul(data: bytes) -> Optional[bytes]:
    from khipu_tpu_torch.evm import bn128

    return bn128.mul_point(data)


def _bn_pairing(data: bytes) -> Optional[bytes]:
    from khipu_tpu_torch.evm import bn128

    return bn128.pairing_check(data)


# --------------------------------------------------- 0x9 BLAKE2F


_BLAKE2B_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
_BLAKE2B_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_M64 = (1 << 64) - 1


def _blake2f_gas(data: bytes, config) -> int:
    if len(data) != 213:
        return 0
    return int.from_bytes(data[:4], "big")


def _blake2_g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M64
    v[d] = _ror64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & _M64
    v[d] = _ror64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 63)


def _ror64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


def _blake2f(data: bytes) -> Optional[bytes]:
    """EIP-152 compression function F (crypto/hash/Blake2bf.scala:6)."""
    if len(data) != 213:
        return None
    rounds = int.from_bytes(data[:4], "big")
    h = list(struct.unpack("<8Q", data[4:68]))
    m = list(struct.unpack("<16Q", data[68:196]))
    t0, t1 = struct.unpack("<2Q", data[196:212])
    final = data[212]
    if final not in (0, 1):
        return None
    v = h[:8] + list(_BLAKE2B_IV)
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64
    for r in range(rounds):
        s = _BLAKE2B_SIGMA[r % 10]
        _blake2_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _blake2_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _blake2_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _blake2_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _blake2_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _blake2_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _blake2_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _blake2_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    out = [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]
    return struct.pack("<8Q", *out)


# --------------------------------------------------------- dispatch

GasFn = Callable[[bytes, object], int]
RunFn = Callable[[bytes], Optional[bytes]]

_FRONTIER: Dict[bytes, Tuple[GasFn, RunFn]] = {
    b"\x00" * 19 + b"\x01": (_ecrecover_gas, _ecrecover),
    b"\x00" * 19 + b"\x02": (_sha256_gas, _sha256),
    b"\x00" * 19 + b"\x03": (_ripemd_gas, _ripemd),
    b"\x00" * 19 + b"\x04": (_identity_gas, _identity),
}
_BYZANTIUM: Dict[bytes, Tuple[GasFn, RunFn]] = {
    b"\x00" * 19 + b"\x05": (_modexp_gas, _modexp),
    b"\x00" * 19 + b"\x06": (_bn_add_gas, _bn_add),
    b"\x00" * 19 + b"\x07": (_bn_mul_gas, _bn_mul),
    b"\x00" * 19 + b"\x08": (_bn_pairing_gas, _bn_pairing),
}
_ISTANBUL: Dict[bytes, Tuple[GasFn, RunFn]] = {
    b"\x00" * 19 + b"\x09": (_blake2f_gas, _blake2f),
}


def get_precompile(address: bytes, config) -> Optional[Tuple[GasFn, RunFn]]:
    p = _FRONTIER.get(address)
    if p is None and config.byzantium:
        p = _BYZANTIUM.get(address)
    if p is None and config.istanbul:
        p = _ISTANBUL.get(address)
    return p
