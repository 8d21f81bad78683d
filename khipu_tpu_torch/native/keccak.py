"""ctypes bindings for the host Keccak sponge (csrc/keccak.cc)."""

from __future__ import annotations

import ctypes

from khipu_tpu_torch.native.build import load_library

_RATE_256 = 136


def keccak256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    load_library().khipu_keccak(_RATE_256, bytes(data), len(data), out, 32)
    return out.raw

