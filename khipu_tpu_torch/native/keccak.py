"""ctypes bindings for the host Keccak sponge (csrc/keccak.cc), with the
streaming form the RLPx frame MAC runs."""

from __future__ import annotations

import ctypes
from typing import List, Sequence

from khipu_tpu_torch.native.build import load_library

_RATE_256 = 136
_RATE_512 = 72


def keccak256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    load_library().khipu_keccak(_RATE_256, bytes(data), len(data), out, 32)
    return out.raw


def keccak512(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(64)
    load_library().khipu_keccak(_RATE_512, bytes(data), len(data), out, 64)
    return out.raw


def keccak256_batch(messages: Sequence[bytes]) -> List[bytes]:
    """Keccak-256 of every message in one native call
    (``khipu_keccak_batch``): the messages are concatenated and the
    library walks ``n + 1`` cumulative offsets."""
    n = len(messages)
    if n == 0:
        return []
    blob = b"".join(messages)
    offsets = (ctypes.c_uint64 * (n + 1))()
    pos = 0
    for i, m in enumerate(messages):
        offsets[i] = pos
        pos += len(m)
    offsets[n] = pos
    out = ctypes.create_string_buffer(32 * n)
    load_library().khipu_keccak_batch(_RATE_256, blob, offsets, n, out, 32)
    raw = out.raw
    return [raw[i * 32:(i + 1) * 32] for i in range(n)]


class IncrementalKeccak:
    """Streaming Keccak-256: ``update`` absorbs, ``digest`` pads a copy
    of the state so the stream goes on (the RLPx MAC contract)."""

    __slots__ = ("_lib", "state", "buffer")

    def __init__(self):
        self._lib = load_library()
        self.state = (ctypes.c_uint64 * 25)()
        self.buffer = b""

    def update(self, data: bytes) -> None:
        buf = self.buffer + bytes(data)
        whole = len(buf) - len(buf) % _RATE_256
        if whole:
            self._lib.khipu_keccak_absorb(self.state, buf[:whole],
                                          whole // _RATE_256)
        self.buffer = buf[whole:]

    def digest(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.khipu_keccak_peek(self.state, self.buffer,
                                    len(self.buffer), out)
        return out.raw
