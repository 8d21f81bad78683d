"""secp256k1 ECDSA: sign (RFC 6979 deterministic) + public-key recovery.

Role of the reference's ECDSASignature (khipu-eth/.../crypto/
ECDSASignature.scala:115 recover, :480 sign via spongycastle): tx-sender
recovery with EIP-155 replay protection and low-s (EIP-2) enforcement.
The curve's double-scalar multiplication — the hot loop of
recover/verify/ECDH/keygen — runs in C++ (native/csrc/secp256k1.cc,
differential-tested against the pure-Python Jacobian ladder kept here
as the oracle); protocol math (RFC 6979, mod-n algebra,
recid bookkeeping) stays in Python.

Tested against the EIP-155 example transaction (signing hash, v/r/s,
sender round-trip) and cross-validated against the OpenSSL-backed
``cryptography`` package where available.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
from typing import Optional, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.native.build import load_library

# Curve: y^2 = x^3 + 7 over F_P
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
HALF_N = N // 2

# Affine point = (x, y) ints, or None for infinity.
Point = Optional[Tuple[int, int]]

# ---------------------------------------------------------- native path
# C++ double-scalar multiplication (native/csrc/secp256k1.cc) — the hot
# ~4k field mults of recover/verify/ECDH/keygen. Protocol math (RFC
# 6979, mod-n algebra, recid bookkeeping) stays in Python. The host
# library is built at first use and a failed build raises; the pure-
# Python Jacobian ladder below stays as the oracle (``native=False``).


def _mul_add(p1: Point, k1: int, p2: Point, k2: int,
             use_g1: bool = False, use_g2: bool = False,
             native: bool = True) -> Point:
    """k1*P1 + k2*P2 (use_gN selects the generator for that base)."""
    if native:
        lib = load_library()

        def enc(p, use_g):
            if use_g:
                return None, None
            return (p[0].to_bytes(32, "big"), p[1].to_bytes(32, "big"))

        outx = ctypes.create_string_buffer(32)
        outy = ctypes.create_string_buffer(32)
        a = enc(p1, use_g1) if k1 else (None, None)
        b = enc(p2, use_g2) if k2 else (None, None)
        rc = lib.khipu_ec_mul_add(
            a[0], a[1], k1.to_bytes(32, "big") if k1 else None,
            b[0], b[1], k2.to_bytes(32, "big") if k2 else None,
            outx, outy,
        )
        if rc == 1:
            return None
        return (
            int.from_bytes(outx.raw, "big"),
            int.from_bytes(outy.raw, "big"),
        )
    acc: _JPoint = _J_INF
    if k1:
        base1 = (GX, GY) if use_g1 else p1
        acc = _j_mul(_to_jacobian(base1), k1)
    if k2:
        base2 = (GX, GY) if use_g2 else p2
        acc = _j_add(acc, _j_mul(_to_jacobian(base2), k2))
    return _from_jacobian(acc)


class SignatureError(Exception):
    pass


# ---------------------------------------------------------------- group ops
# Jacobian coordinates (X, Y, Z): x = X/Z^2, y = Y/Z^3. Avoids a modular
# inverse per addition; one inverse at the end of a scalar multiply.

_JPoint = Tuple[int, int, int]  # Z == 0 encodes infinity
_J_INF: _JPoint = (1, 1, 0)


def _j_double(p: _JPoint) -> _JPoint:
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return _J_INF
    S = (4 * X * Y * Y) % P
    M = (3 * X * X) % P  # a == 0
    X2 = (M * M - 2 * S) % P
    Y2 = (M * (S - X2) - 8 * Y * Y * Y * Y) % P
    Z2 = (2 * Y * Z) % P
    return (X2, Y2, Z2)


def _j_add(p: _JPoint, q: _JPoint) -> _JPoint:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = (Z1 * Z1) % P
    Z2Z2 = (Z2 * Z2) % P
    U1 = (X1 * Z2Z2) % P
    U2 = (X2 * Z1Z1) % P
    S1 = (Y1 * Z2 * Z2Z2) % P
    S2 = (Y2 * Z1 * Z1Z1) % P
    if U1 == U2:
        if S1 != S2:
            return _J_INF
        return _j_double(p)
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    HH = (H * H) % P
    HHH = (H * HH) % P
    V = (U1 * HH) % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    Z3 = (H * Z1 * Z2) % P
    return (X3, Y3, Z3)


def _to_jacobian(p: Point) -> _JPoint:
    if p is None:
        return _J_INF
    return (p[0], p[1], 1)


def _from_jacobian(p: _JPoint) -> Point:
    X, Y, Z = p
    if Z == 0:
        return None
    zinv = pow(Z, -1, P)
    zinv2 = (zinv * zinv) % P
    return ((X * zinv2) % P, (Y * zinv2 * zinv) % P)


def _j_mul(p: _JPoint, k: int) -> _JPoint:
    k %= N
    acc = _J_INF
    while k:
        if k & 1:
            acc = _j_add(acc, p)
        p = _j_double(p)
        k >>= 1
    return acc


def point_mul(p: Point, k: int) -> Point:
    if p is None or k % N == 0:
        return None
    return _mul_add(p, k % N, None, 0)


def point_add(p: Point, q: Point) -> Point:
    return _from_jacobian(_j_add(_to_jacobian(p), _to_jacobian(q)))


_G: _JPoint = (GX, GY, 1)


def is_on_curve(p: Point) -> bool:
    if p is None:
        return False
    x, y = p
    return (y * y - x * x * x - 7) % P == 0


# ---------------------------------------------------------------- key ops


def privkey_to_pubkey(priv: bytes) -> bytes:
    """32-byte private key -> 64-byte uncompressed pubkey (x || y)."""
    d = int.from_bytes(priv, "big")
    if not 0 < d < N:
        raise SignatureError("private key out of range")
    pub = _mul_add(None, d, None, 0, use_g1=True)
    return pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def pubkey_to_address(pubkey_xy: bytes) -> bytes:
    """64-byte pubkey -> 20-byte address (keccak256(pub)[12:],
    SignedTransaction.scala:143 semantics)."""
    if len(pubkey_xy) != 64:
        raise SignatureError("expected 64-byte uncompressed pubkey")
    return keccak256(pubkey_xy)[12:]


# ------------------------------------------------------------------- sign


def _rfc6979_gen(msg_hash: bytes, priv: bytes):
    """Deterministic nonce stream (RFC 6979 §3.2, HMAC-SHA256) — what
    geth/parity use, so fixture signatures are reproducible across runs.
    Yields candidate k values; the caller advances the generator (the
    §3.2.h K/V update) when a candidate produces r == 0 or s == 0.
    Per §2.3.4/§3.2, h1 enters the HMAC as bits2octets = int(h1) mod N."""
    holen = 32
    V = b"\x01" * holen
    K = b"\x00" * holen
    x = priv.rjust(32, b"\x00")
    h1 = (int.from_bytes(msg_hash, "big") % N).to_bytes(32, "big")
    K = hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 0 < k < N:
            yield k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def ecdsa_sign(msg_hash: bytes, priv: bytes) -> Tuple[int, int, int]:
    """Sign a 32-byte hash; returns (recovery_id, r, s) with low s
    (EIP-2: s <= N/2, flipping the recovery bit when normalizing)."""
    if len(msg_hash) != 32:
        raise SignatureError("message hash must be 32 bytes")
    d = int.from_bytes(priv, "big")
    if not 0 < d < N:
        raise SignatureError("private key out of range")
    z = int.from_bytes(msg_hash, "big")
    for k in _rfc6979_gen(msg_hash, priv):
        R = _mul_add(None, k, None, 0, use_g1=True)
        r = R[0] % N
        if r == 0:
            continue  # next k from the RFC 6979 K/V update loop
        s = (pow(k, -1, N) * (z + r * d)) % N
        if s == 0:
            continue
        recid = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > HALF_N:
            s = N - s
            recid ^= 1
        return recid, r, s


# ---------------------------------------------------------------- recover


def ecdsa_recover(msg_hash: bytes, recid: int, r: int, s: int,
                  native: bool = True) -> bytes:
    """Recover the 64-byte public key from a signature.

    recid in 0..3 (bit 0: parity of R.y, bit 1: r overflowed N).
    Raises SignatureError for invalid signatures. ``native=False`` runs
    the pure-Python ladder (the oracle).
    """
    if not 0 <= recid <= 3:
        raise SignatureError(f"recovery id {recid} out of range")
    if not (0 < r < N and 0 < s < N):
        raise SignatureError("r/s out of range")
    x = r + (N if recid & 2 else 0)
    if x >= P:
        raise SignatureError("r + N >= P")
    # lift x: y^2 = x^3 + 7; sqrt via exponent (P+1)/4 (P % 4 == 3)
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if (y * y) % P != y_sq:
        raise SignatureError("r is not an x-coordinate on the curve")
    if (y & 1) != (recid & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    rinv = pow(r, -1, N)
    # Q = r^-1 * (s*R - z*G)
    u1 = (-z * rinv) % N
    u2 = (s * rinv) % N
    Q = _mul_add(None, u1, (x, y), u2, use_g1=True, native=native)
    if Q is None:
        raise SignatureError("recovered point at infinity")
    return Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big")


def ecdsa_recover_batch(items) -> list:
    """Recover many signatures in ONE native call (the tx-sender hot
    loop: one ctypes crossing per block, Strauss-Shamir wNAF ladders,
    one Montgomery batch inversion across the whole batch). ``items``
    is a list of (msg_hash, recid, r, s); returns a list of 64-byte
    public keys, None where the signature is invalid.
    ``ecdsa_recover_batch_py`` gives the same verdicts in pure Python."""
    lib = load_library()
    n = len(items)
    if n == 0:
        return []
    msg = bytearray(32 * n)
    rec = bytearray(n)
    rs = bytearray(64 * n)
    for i, (msg_hash, recid, r, s) in enumerate(items):
        if len(msg_hash) != 32 or not (
            0 <= recid <= 3 and 0 < r < N and 0 < s < N
        ):
            # a non-32-byte hash slice-assigned below would RESIZE the
            # packed buffer, misaligning every later entry — mark the
            # entry invalid instead, like the r/s range check
            rec[i] = 255  # native rejects recid 255 -> None
            continue
        msg[32 * i : 32 * i + 32] = msg_hash
        rec[i] = recid
        rs[64 * i : 64 * i + 32] = r.to_bytes(32, "big")
        rs[64 * i + 32 : 64 * i + 64] = s.to_bytes(32, "big")
    out_buf = ctypes.create_string_buffer(64 * n)
    ok_buf = ctypes.create_string_buffer(n)
    lib.khipu_ecdsa_recover_batch(
        ctypes.c_int(n),
        bytes(msg),
        bytes(rec),
        bytes(rs),
        out_buf,
        ok_buf,
    )
    results = []
    raw = out_buf.raw
    oks = ok_buf.raw
    for i in range(n):
        results.append(raw[64 * i : 64 * i + 64] if oks[i] else None)
    return results


def ecdsa_recover_batch_py(items) -> list:
    """``ecdsa_recover_batch`` through the pure-Python ladder: the
    oracle the native batch is tested against."""
    out = []
    for msg_hash, recid, r, s in items:
        if len(msg_hash) != 32:  # same verdict as the native path
            out.append(None)
            continue
        try:
            out.append(ecdsa_recover(msg_hash, recid, r, s, native=False))
        except SignatureError:
            out.append(None)
    return out


def ecdsa_verify(msg_hash: bytes, pubkey_xy: bytes, r: int, s: int) -> bool:
    if not (0 < r < N and 0 < s < N):
        return False
    x = int.from_bytes(pubkey_xy[:32], "big")
    y = int.from_bytes(pubkey_xy[32:], "big")
    if not is_on_curve((x, y)):
        return False
    z = int.from_bytes(msg_hash, "big")
    sinv = pow(s, -1, N)
    u1 = (z * sinv) % N
    u2 = (r * sinv) % N
    p = _mul_add(None, u1, (x, y), u2, use_g1=True)
    if p is None:
        return False
    return p[0] % N == r
