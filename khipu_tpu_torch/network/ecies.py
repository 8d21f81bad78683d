"""ECIES encryption for the RLPx auth handshake.

Parity: khipu-eth/.../crypto/ECIESCoder.scala + EthereumIESEngine
(SURVEY §2.5 ECIES): secp256k1 ECDH, NIST SP 800-56 concatenation KDF
over SHA-256, AES-128-CTR, HMAC-SHA256 tag. Wire form:
``0x04 || ephemeral-pubkey(64) || iv(16) || ciphertext || tag(32)``;
``shared_mac_data`` carries the EIP-8 size prefix into the tag.
The port's copy of ``khipu_tpu.network.ecies``; the AES is the host
library's (``native/aes.py``).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets

from khipu_tpu_torch.base.secp256k1 import (
    SignatureError,
    point_mul,
    privkey_to_pubkey,
)
from khipu_tpu_torch.native.aes import ctr_crypt

ECIES_OVERHEAD = 65 + 16 + 32  # pubkey + iv + tag


class EciesError(Exception):
    pass


def ecdh_raw(priv: bytes, pub_xy: bytes) -> bytes:
    """Shared secret = x-coordinate of priv * Pub (32 bytes)."""
    x = int.from_bytes(pub_xy[:32], "big")
    y = int.from_bytes(pub_xy[32:], "big")
    d = int.from_bytes(priv, "big")
    p = point_mul((x, y), d)
    if p is None:
        raise EciesError("ECDH at infinity")
    return p[0].to_bytes(32, "big")


def concat_kdf(z: bytes, length: int) -> bytes:
    """NIST SP 800-56 concatenation KDF (SHA-256, empty otherInfo)."""
    out = b""
    counter = 1
    while len(out) < length:
        out += hashlib.sha256(counter.to_bytes(4, "big") + z).digest()
        counter += 1
    return out[:length]


def _keys(z: bytes):
    derived = concat_kdf(z, 32)
    enc_key = derived[:16]
    mac_key = hashlib.sha256(derived[16:32]).digest()
    return enc_key, mac_key


def encrypt(pub_xy: bytes, plaintext: bytes,
            shared_mac_data: bytes = b"") -> bytes:
    eph_priv = secrets.token_bytes(32)
    try:
        eph_pub = privkey_to_pubkey(eph_priv)
    except SignatureError:  # astronomically unlikely out-of-range key
        return encrypt(pub_xy, plaintext, shared_mac_data)
    z = ecdh_raw(eph_priv, pub_xy)
    enc_key, mac_key = _keys(z)
    iv = secrets.token_bytes(16)
    ct = ctr_crypt(enc_key, iv, plaintext)
    tag = hmac.new(mac_key, iv + ct + shared_mac_data, hashlib.sha256).digest()
    return b"\x04" + eph_pub + iv + ct + tag


def decrypt(priv: bytes, message: bytes,
            shared_mac_data: bytes = b"") -> bytes:
    if len(message) < 1 + 64 + 16 + 32 or message[0] != 0x04:
        raise EciesError("malformed ECIES message")
    eph_pub = message[1:65]
    iv = message[65:81]
    ct = message[81:-32]
    tag = message[-32:]
    z = ecdh_raw(priv, eph_pub)
    enc_key, mac_key = _keys(z)
    expect = hmac.new(
        mac_key, iv + ct + shared_mac_data, hashlib.sha256
    ).digest()
    if not hmac.compare_digest(tag, expect):
        raise EciesError("MAC mismatch")
    return ctr_crypt(enc_key, iv, ct)
