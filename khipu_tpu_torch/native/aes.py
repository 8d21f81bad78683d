"""ctypes bindings for the host AES (csrc/aes.cc) of the RLPx transport
and the keyfiles.

The one AES path of the port: the ECIES handshake and the V3 keyfiles
(AES-128-CTR), the RLPx frames (AES-256-CTR) and the frame MAC's
whitening block (AES-256-ECB). ``CtrCipher`` has the ``update`` /
``finalize`` surface of a streaming encryptor. The pure-Python
``base/aes.py`` is the oracle the tests hold these against; nothing
falls back to it. Every call releases the GIL (ctypes), so frame crypto
on a peer's reader thread does not hold up the other threads.
"""

from __future__ import annotations

import ctypes

from khipu_tpu_torch.native.build import load_library


class CtrCipher:
    """AES-CTR keystream over a big-endian 128-bit counter that starts at
    ``iv``; ``update`` takes chunks of any size across calls."""

    __slots__ = ("_lib", "_ctx")

    def __init__(self, key: bytes, iv: bytes = b"\x00" * 16):
        if len(iv) != 16:
            raise ValueError("CTR iv must be 16 bytes")
        lib = load_library()
        self._lib = lib
        self._ctx = ctypes.create_string_buffer(int(lib.khipu_aes_ctx_size()))
        if lib.khipu_aes_init(self._ctx, bytes(key), len(key), bytes(iv)):
            raise ValueError(f"bad AES key length {len(key)}")

    def update(self, data: bytes) -> bytes:
        n = len(data)
        if not n:
            return b""
        out = ctypes.create_string_buffer(n)
        self._lib.khipu_aes_ctr(self._ctx, bytes(data), n, out)
        return out.raw

    def finalize(self) -> bytes:
        return b""


class EcbCipher:
    """One key schedule, forward single blocks (the frame-MAC seed)."""

    __slots__ = ("_lib", "_ctx")

    def __init__(self, key: bytes):
        lib = load_library()
        self._lib = lib
        self._ctx = ctypes.create_string_buffer(int(lib.khipu_aes_ctx_size()))
        if lib.khipu_aes_init(self._ctx, bytes(key), len(key), b"\x00" * 16):
            raise ValueError(f"bad AES key length {len(key)}")

    def encrypt_block(self, block16: bytes) -> bytes:
        if len(block16) != 16:
            raise ValueError("AES block must be 16 bytes")
        out = ctypes.create_string_buffer(16)
        self._lib.khipu_aes_ecb(self._ctx, bytes(block16), out)
        return out.raw


def ctr_crypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    """One-shot AES-CTR (encrypt == decrypt)."""
    return CtrCipher(key, iv).update(data)

