"""Pure-Python AES (forward cipher only) — CTR and single-block ECB.

The port's copy of ``khipu_tpu.base.crypto.aes``. In the port it is the
ORACLE: RLPx handshakes/frames (network/ecies.py, network/rlpx.py) and
V3 keyfiles (keystore.py) run the host library's AES
(``native/aes.py``), and the tests hold that against this module. Only
the ENCRYPT direction exists (CTR decrypts with the forward cipher; the
RLPx frame-MAC uses one ECB block), so the inverse cipher is
deliberately omitted.

Table-based (four 32-bit T-tables, computed at import from GF(2^8)
log/antilog tables rather than transcribed constants); throughput is
plenty for handshake- and keyfile-sized payloads. Not constant-time —
acceptable for the transport layer this backs (the reference client's
JCE provider isn't the trust boundary either), not for signing keys
handled by adversarial-timing-exposed services.
"""

from __future__ import annotations

from typing import List


def _gmul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _build_tables():
    # log/antilog over generator 3 -> multiplicative inverses -> S-box
    alog = [0] * 255
    log = [0] * 256
    x = 1
    for i in range(255):
        alog[i] = x
        log[x] = i
        x = _gmul(x, 3)
    sbox = [0] * 256
    sbox[0] = 0x63
    for a in range(1, 256):
        b = alog[(255 - log[a]) % 255]  # a^-1
        s = b
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            s ^= b
        sbox[a] = s ^ 0x63
    te0 = [0] * 256
    for a in range(256):
        s = sbox[a]
        s2 = _gmul(s, 2)
        s3 = s2 ^ s
        te0[a] = (s2 << 24) | (s << 16) | (s << 8) | s3
    te1 = [((t >> 8) | ((t & 0xFF) << 24)) & 0xFFFFFFFF for t in te0]
    te2 = [((t >> 8) | ((t & 0xFF) << 24)) & 0xFFFFFFFF for t in te1]
    te3 = [((t >> 8) | ((t & 0xFF) << 24)) & 0xFFFFFFFF for t in te2]
    return sbox, te0, te1, te2, te3


_SBOX, _TE0, _TE1, _TE2, _TE3 = _build_tables()
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D]


class AES:
    """Forward AES-128/192/256 over 16-byte blocks."""

    __slots__ = ("_rk", "_rounds")

    def __init__(self, key: bytes):
        nk = len(key) // 4
        if len(key) not in (16, 24, 32):
            raise ValueError(f"bad AES key length {len(key)}")
        self._rounds = nk + 6
        w: List[int] = [
            int.from_bytes(key[4 * i : 4 * i + 4], "big")
            for i in range(nk)
        ]
        sbox = _SBOX
        for i in range(nk, 4 * (self._rounds + 1)):
            t = w[i - 1]
            if i % nk == 0:
                t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF  # RotWord
                t = (
                    (sbox[(t >> 24) & 0xFF] << 24)
                    | (sbox[(t >> 16) & 0xFF] << 16)
                    | (sbox[(t >> 8) & 0xFF] << 8)
                    | sbox[t & 0xFF]
                )
                t ^= _RCON[i // nk - 1] << 24
            elif nk > 6 and i % nk == 4:
                t = (
                    (sbox[(t >> 24) & 0xFF] << 24)
                    | (sbox[(t >> 16) & 0xFF] << 16)
                    | (sbox[(t >> 8) & 0xFF] << 8)
                    | sbox[t & 0xFF]
                )
            w.append(w[i - nk] ^ t)
        self._rk = w

    def encrypt_block(self, block: bytes) -> bytes:
        if len(block) != 16:
            raise ValueError("AES block must be 16 bytes")
        rk = self._rk
        te0, te1, te2, te3 = _TE0, _TE1, _TE2, _TE3
        s0 = int.from_bytes(block[0:4], "big") ^ rk[0]
        s1 = int.from_bytes(block[4:8], "big") ^ rk[1]
        s2 = int.from_bytes(block[8:12], "big") ^ rk[2]
        s3 = int.from_bytes(block[12:16], "big") ^ rk[3]
        k = 4
        for _ in range(self._rounds - 1):
            t0 = (
                te0[(s0 >> 24) & 0xFF] ^ te1[(s1 >> 16) & 0xFF]
                ^ te2[(s2 >> 8) & 0xFF] ^ te3[s3 & 0xFF] ^ rk[k]
            )
            t1 = (
                te0[(s1 >> 24) & 0xFF] ^ te1[(s2 >> 16) & 0xFF]
                ^ te2[(s3 >> 8) & 0xFF] ^ te3[s0 & 0xFF] ^ rk[k + 1]
            )
            t2 = (
                te0[(s2 >> 24) & 0xFF] ^ te1[(s3 >> 16) & 0xFF]
                ^ te2[(s0 >> 8) & 0xFF] ^ te3[s1 & 0xFF] ^ rk[k + 2]
            )
            t3 = (
                te0[(s3 >> 24) & 0xFF] ^ te1[(s0 >> 16) & 0xFF]
                ^ te2[(s1 >> 8) & 0xFF] ^ te3[s2 & 0xFF] ^ rk[k + 3]
            )
            s0, s1, s2, s3 = t0, t1, t2, t3
            k += 4
        sbox = _SBOX
        out = bytearray(16)
        for col, (a, b, c, d) in enumerate(
            ((s0, s1, s2, s3), (s1, s2, s3, s0),
             (s2, s3, s0, s1), (s3, s0, s1, s2))
        ):
            v = (
                (sbox[(a >> 24) & 0xFF] << 24)
                | (sbox[(b >> 16) & 0xFF] << 16)
                | (sbox[(c >> 8) & 0xFF] << 8)
                | sbox[d & 0xFF]
            ) ^ rk[k + col]
            out[4 * col : 4 * col + 4] = v.to_bytes(4, "big")
        return bytes(out)


class CtrCipher:
    """Incremental AES-CTR keystream (big-endian 128-bit counter over
    the whole IV, as both RLPx and V3 keyfiles use). Mirrors the
    ``cryptography`` encryptor surface: ``update`` accepts arbitrary
    chunk sizes across calls, ``finalize`` returns nothing."""

    __slots__ = ("_aes", "_counter", "_leftover")

    def __init__(self, key: bytes, iv: bytes = b"\x00" * 16):
        if len(iv) != 16:
            raise ValueError("CTR iv must be 16 bytes")
        self._aes = AES(key)
        self._counter = int.from_bytes(iv, "big")
        self._leftover = b""

    def update(self, data: bytes) -> bytes:
        n = len(data)
        stream = [self._leftover]
        have = len(self._leftover)
        enc = self._aes.encrypt_block
        while have < n:
            stream.append(
                enc(self._counter.to_bytes(16, "big"))
            )
            self._counter = (self._counter + 1) % (1 << 128)
            have += 16
        ks = b"".join(stream)
        self._leftover = ks[n:]
        return (
            int.from_bytes(data, "big") ^ int.from_bytes(ks[:n], "big")
        ).to_bytes(n, "big") if n else b""

    def finalize(self) -> bytes:
        return b""


def ctr_crypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    """One-shot AES-CTR (encrypt == decrypt)."""
    return CtrCipher(key, iv).update(data)


def ecb_encrypt_block(key: bytes, block16: bytes) -> bytes:
    """One forward AES block (the RLPx frame-MAC update primitive)."""
    return AES(key).encrypt_block(block16)
