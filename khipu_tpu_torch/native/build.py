"""Build the host library (``csrc/*.cc``) with g++ and the RLP extension
(``csrc_ext/rlp_ext.c``) with gcc, at first use.

The library holds the host's scalar Keccak sponge (``keccak.cc``, with
the streaming form the RLPx frame MAC runs), the secp256k1
double-scalar multiplication (``secp256k1.cc``), the EVM interpreter
core (``evm.cc``), the append-log store (``store.cc``) and the forward
AES of the RLPx transport and the keyfiles (``aes.cc``).
The extension is the CPython RLP codec. Both go into
``khipu_tpu_torch/_build/`` under names keyed by a hash of the flags and
the sources (the extension's also by the interpreter's ``EXT_SUFFIX``,
since the directory may travel to a host with another CPython), so a
second process reuses them and an edit rebuilds them. A file lock in
``_build/`` for each output lets one process compile it while parallel
ones wait and reuse it. No ``-march=native``: the build directory may
travel to a host with another CPU. A failed build raises; nothing falls back to the
pure-Python paths, which stay as the oracles the tests compare against.
Importing this module runs nothing: ``load_library()`` and
``load_rlp_ext()`` build on their first call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import List

from khipu_tpu_torch.observability.recorder import compile_log

CSRC = Path(__file__).resolve().parent / "csrc"
CSRC_EXT = Path(__file__).resolve().parent / "csrc_ext"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_EXT = None
_LIB_LOCK = threading.Lock()
_EXT_LOCK = threading.Lock()


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cc"))


def _key(flags: List[str], srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


@contextmanager
def _build_lock(out: Path):
    """One compiler of ``out`` at a time across processes: parallel test
    workers wait for the first one's build and then find its output.
    Different outputs build at once."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f".{out.name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(tool: str, flags: List[str], srcs: List[Path], out: Path) -> None:
    """``out`` built from ``srcs`` unless it exists; compile-log events
    record a hit or a miss with its seconds. Raises on a failed build."""
    label = f"{out.name} ({', '.join(s.name for s in srcs)})"
    if out.exists():
        compile_log.record("hit", label)
        return
    with _build_lock(out):
        if out.exists():  # another process built it while we waited
            compile_log.record("hit", label)
            return
        # a process-unique temporary name, moved into place: a reader
        # must never open a half-written library
        tmp = out.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        try:
            run = subprocess.run(
                [tool, *flags, "-o", str(tmp), *map(str, srcs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as exc:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{tool} could not build {out.name}: {exc}")
        if run.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{tool} failed:\n" + run.stdout)
        os.replace(tmp, out)
        compile_log.record("miss", label, time.perf_counter() - t0)


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of the Keccak, AES, secp256k1 and store entry points;
    the EVM's are bound by ``evm/native_vm.py`` beside its result
    struct."""
    p, i, u32, u64 = (ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_uint64)
    vp = ctypes.c_void_p
    lib.khipu_keccak.argtypes = [i, p, u64, p, i]
    lib.khipu_keccak.restype = None
    lib.khipu_keccak_batch.argtypes = [
        i, p, ctypes.POINTER(ctypes.c_uint64), u64, p, i,
    ]
    lib.khipu_keccak_batch.restype = None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.khipu_keccak_absorb.argtypes = [u64p, p, u64]
    lib.khipu_keccak_absorb.restype = None
    lib.khipu_keccak_peek.argtypes = [u64p, p, u64, p]
    lib.khipu_keccak_peek.restype = None
    lib.khipu_aes_ctx_size.argtypes = []
    lib.khipu_aes_ctx_size.restype = u64
    lib.khipu_aes_init.argtypes = [p, p, i, p]
    lib.khipu_aes_init.restype = i
    lib.khipu_aes_ctr.argtypes = [p, p, u64, p]
    lib.khipu_aes_ctr.restype = None
    lib.khipu_aes_ecb.argtypes = [p, p, p]
    lib.khipu_aes_ecb.restype = None
    lib.khipu_ec_mul_add.argtypes = [p] * 8
    lib.khipu_ec_mul_add.restype = i
    lib.khipu_ecdsa_recover_batch.argtypes = [i] + [p] * 5
    lib.khipu_ecdsa_recover_batch.restype = i
    lib.kstore_open.argtypes = [p, i]
    lib.kstore_open.restype = vp
    lib.kstore_get.argtypes = [vp, p, u32, p, u32]
    lib.kstore_get.restype = ctypes.c_int64
    lib.kstore_put.argtypes = [vp, p, u32, p, u32]
    lib.kstore_put.restype = i
    lib.kstore_flush.argtypes = [vp]
    lib.kstore_flush.restype = None
    lib.kstore_count.argtypes = [vp]
    lib.kstore_count.restype = u64
    lib.kstore_max_key8.argtypes = [vp]
    lib.kstore_max_key8.restype = ctypes.c_int64
    lib.kstore_close.argtypes = [vp]
    lib.kstore_close.restype = None


def load_library() -> ctypes.CDLL:
    """The host library, compiled from the package sources if needed.
    Raises ``RuntimeError`` when g++ fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        so = BUILD_DIR / f"libkhipu_host_{_key(GXX_FLAGS, srcs)}.so"
        _compile("g++", GXX_FLAGS, srcs, so)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _LIB = lib
        return lib


def load_rlp_ext():
    """The CPython RLP extension module (``csrc_ext/rlp_ext.c``),
    compiled against this interpreter's headers if needed. Raises
    ``RuntimeError`` when gcc fails or the module does not import."""
    global _EXT
    if _EXT is not None:
        return _EXT
    with _EXT_LOCK:
        if _EXT is not None:
            return _EXT
        flags = ["-O3", "-shared", "-fPIC",
                 f"-I{sysconfig.get_paths()['include']}"]
        suffix = sysconfig.get_config_var("EXT_SUFFIX")
        src = CSRC_EXT / "rlp_ext.c"
        so = BUILD_DIR / f"khipu_rlp_ext_{_key(flags + [suffix], [src])}{suffix}"
        _compile("gcc", flags, [src], so)
        # the init function is PyInit_khipu_rlp_ext, whatever the file
        spec = importlib.util.spec_from_file_location("khipu_rlp_ext", so)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as exc:
            raise RuntimeError(f"{so.name} does not import: {exc}")
        _EXT = mod
        return mod
