"""Encrypted key files — Web3 secret storage v3 (scrypt + AES-128-CTR).

Parity: keystore/KeyStore.scala:31 (EncryptedKeyJsonCodec, Wallet):
scrypt KDF, AES-128-CTR cipher, keccak256 MAC over
(derived_key[16:32] ++ ciphertext), geth-compatible JSON layout.
The port's copy of ``khipu_tpu.keystore``; the AES is the host
library's (``native/aes.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
from dataclasses import dataclass
from typing import Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    privkey_to_pubkey,
    pubkey_to_address,
)
from khipu_tpu_torch.native.aes import ctr_crypt


class KeyStoreError(Exception):
    pass


@dataclass
class Wallet:
    address: bytes
    private_key: bytes


def encrypt_key(
    priv: bytes,
    passphrase: str,
    scrypt_n: int = 1 << 14,  # interactive-grade default; geth uses 2^18
    scrypt_r: int = 8,
    scrypt_p: int = 1,
) -> dict:
    """Private key -> V3 keyfile dict."""
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    dk = hashlib.scrypt(
        passphrase.encode(), salt=salt, n=scrypt_n, r=scrypt_r,
        p=scrypt_p, dklen=32, maxmem=1 << 30,
    )
    ciphertext = ctr_crypt(dk[:16], iv, priv)
    mac = keccak256(dk[16:32] + ciphertext)
    address = pubkey_to_address(privkey_to_pubkey(priv))
    return {
        "version": 3,
        "id": secrets.token_hex(16),
        "address": address.hex(),
        "crypto": {
            "cipher": "aes-128-ctr",
            "ciphertext": ciphertext.hex(),
            "cipherparams": {"iv": iv.hex()},
            "kdf": "scrypt",
            "kdfparams": {
                "dklen": 32,
                "n": scrypt_n,
                "r": scrypt_r,
                "p": scrypt_p,
                "salt": salt.hex(),
            },
            "mac": mac.hex(),
        },
    }


def decrypt_key(keyfile: dict, passphrase: str) -> Wallet:
    crypto = keyfile["crypto"]
    if crypto.get("cipher") != "aes-128-ctr":
        raise KeyStoreError(f"unsupported cipher {crypto.get('cipher')}")
    kdf = crypto.get("kdf")
    params = crypto["kdfparams"]
    salt = bytes.fromhex(
        params["salt"][2:] if params["salt"].startswith("0x")
        else params["salt"]
    )
    if kdf == "scrypt":
        dk = hashlib.scrypt(
            passphrase.encode(), salt=salt, n=params["n"], r=params["r"],
            p=params["p"], dklen=params["dklen"], maxmem=1 << 30,
        )
    elif kdf == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeyStoreError("unsupported prf")
        dk = hashlib.pbkdf2_hmac(
            "sha256", passphrase.encode(), salt, params["c"],
            dklen=params["dklen"],
        )
    else:
        raise KeyStoreError(f"unsupported kdf {kdf}")
    def unhex(v: str) -> bytes:
        return bytes.fromhex(v[2:] if v.startswith("0x") else v)

    ciphertext = unhex(crypto["ciphertext"])
    mac = keccak256(dk[16:32] + ciphertext)
    # byte comparison: tools write the MAC upper/lower/0x-prefixed
    if mac != unhex(crypto["mac"]):
        raise KeyStoreError("wrong passphrase (MAC mismatch)")
    iv = unhex(crypto["cipherparams"]["iv"])
    priv = ctr_crypt(dk[:16], iv, ciphertext)
    return Wallet(
        address=pubkey_to_address(privkey_to_pubkey(priv)),
        private_key=priv,
    )


class KeyStore:
    """Directory of V3 keyfiles (KeyStore.scala roles: newAccount,
    listAccounts, unlock)."""

    def __init__(self, key_dir: str):
        self.key_dir = key_dir
        os.makedirs(key_dir, exist_ok=True)

    def _path(self, address: bytes) -> str:
        return os.path.join(self.key_dir, f"key-{address.hex()}.json")

    def new_account(self, passphrase: str) -> bytes:
        priv = secrets.token_bytes(32)
        return self.import_key(priv, passphrase)

    def import_key(self, priv: bytes, passphrase: str) -> bytes:
        keyfile = encrypt_key(priv, passphrase)
        address = bytes.fromhex(keyfile["address"])
        path = self._path(address)
        # 0600 like geth/the reference: the scrypt-encrypted key must
        # not be readable by other local users
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(keyfile, f)
        return address

    def list_accounts(self) -> list:
        out = []
        for name in sorted(os.listdir(self.key_dir)):
            if name.startswith("key-") and name.endswith(".json"):
                out.append(bytes.fromhex(name[4:-5]))
        return out

    def unlock(self, address: bytes, passphrase: str) -> Wallet:
        path = self._path(address)
        if not os.path.exists(path):
            raise KeyStoreError(f"no key for {address.hex()}")
        with open(path) as f:
            keyfile = json.load(f)
        wallet = decrypt_key(keyfile, passphrase)
        if wallet.address != address:
            raise KeyStoreError("keyfile address mismatch")
        return wallet
