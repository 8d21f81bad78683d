"""Build the host library (``csrc/*.cc``) with g++ at first use.

The library holds the host's scalar Keccak sponge (``keccak.cc``) and
the secp256k1 double-scalar multiplication (``secp256k1.cc``). It goes
into ``khipu_tpu_torch/_build/`` under a name keyed by a hash of the
flags and the sources, so a second process reuses it and an edit
rebuilds it. No ``-march=native``: the build directory may travel to a
host with another CPU. A failed build raises; nothing falls back to the
pure-Python paths, which stay as the oracles the tests compare against.
Importing this module runs nothing: ``load_library()`` builds on the
first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List

from khipu_tpu_torch.observability import compile_log

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOCK = threading.Lock()


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cc"))


def _key(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u64 = ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64
    lib.khipu_keccak.argtypes = [i, p, u64, p, i]
    lib.khipu_keccak.restype = None
    lib.khipu_keccak_batch.argtypes = [
        i, p, ctypes.POINTER(ctypes.c_uint64), u64, p, i,
    ]
    lib.khipu_keccak_batch.restype = None
    lib.khipu_ec_mul_add.argtypes = [p] * 8
    lib.khipu_ec_mul_add.restype = i
    lib.khipu_ecdsa_recover_batch.argtypes = [i] + [p] * 5
    lib.khipu_ecdsa_recover_batch.restype = i


def load_library() -> ctypes.CDLL:
    """The host library, compiled from the package sources if needed.
    Raises ``RuntimeError`` when g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        so = BUILD_DIR / f"libkhipu_host_{_key(srcs)}.so"
        label = f"{so.name} ({', '.join(s.name for s in srcs)})"
        if so.exists():
            compile_log.record("hit", label)
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a process-unique temporary name, moved into place: parallel
            # test workers must never open a half-written library
            tmp = so.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
            t0 = time.perf_counter()
            try:
                run = subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, srcs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, timeout=300,
                )
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise RuntimeError(f"g++ could not build {so.name}: {exc}")
            if run.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("g++ failed:\n" + run.stdout)
            os.replace(tmp, so)
            compile_log.record("miss", label, time.perf_counter() - t0)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _LIB = lib
        return lib
