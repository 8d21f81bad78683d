"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` of the package is compiled by ``nvcc`` for sm_90a,
one process per source, all started together, then linked into one
shared library with a plain C interface. The library goes into
``khipu_tpu_torch/_build/`` under a name keyed by a hash of the flags,
the sources and the headers they share (``csrc/*.cuh``), so a second
process reuses it and an edit to a header rebuilds it. Nothing is downloaded; only
the package's own sources are compiled. Importing this module runs
nothing: ``load()`` builds on the first kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List

from khipu_tpu_torch.observability.recorder import compile_log

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# what the last build printed (ptxas register and spill report)
BUILD_LOG: List[str] = []


def count_launch(module: str, counter: str) -> None:
    """One more launch on the counter ``counter`` of the wrapper module
    named ``module``. Every wrapper counts here, under one lock: kernels
    launch from several threads at once (the replay driver and its
    sender-prefetch thread, two bridges' batches)."""
    mod = sys.modules[module]
    with _COUNT_LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)


def sources() -> List[Path]:
    return sorted(PKG.glob("*/csrc/*.cu"))


def headers() -> List[Path]:
    return sorted(PKG.glob("*/csrc/*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _key(srcs: List[Path]) -> str:
    """Hash of the flags, ``srcs`` and every shared header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
        h.update(str(s.relative_to(PKG)).encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: List[Path], so: Path) -> None:
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(srcs, objs)
    ]
    BUILD_LOG.clear()
    failed = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        BUILD_LOG.append(f"{s.name}: {out.strip()}")
        if p.returncode:
            failed.append(f"{s.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.khipu_keccak256_fixed.argtypes = [p, p, ll, i, i, i, p]
    lib.khipu_keccak256_fixed.restype = i
    lib.khipu_keccak256_ragged.argtypes = [p, p, p, i, i, i, p]
    lib.khipu_keccak256_ragged.restype = i
    lib.khipu_mirror_hash.argtypes = [p, ll, ll, i, i, p, ll, i, p]
    lib.khipu_mirror_hash.restype = i
    lib.khipu_mirror_verify_maps.argtypes = [p, ll, i, i, p, ll, p]
    lib.khipu_mirror_verify_maps.restype = i
    lib.khipu_mirror_verify_cap.argtypes = [i, p]
    lib.khipu_mirror_verify_cap.restype = i
    lib.khipu_mirror_verify.argtypes = [p, i, i, i, i, p, i, p]
    lib.khipu_mirror_verify.restype = i
    lib.khipu_fixpoint_levels.argtypes = [p, i, p, p, i, p, p, p, p, p, ll,
                                          ll, i, p]
    lib.khipu_fixpoint_levels.restype = i
    lib.khipu_fixpoint_levels_occupancy.argtypes = [i, p, p]
    lib.khipu_fixpoint_levels_occupancy.restype = i
    lib.khipu_exec_validate.argtypes = [p, ll, p, i, p]
    lib.khipu_exec_validate.restype = i


def launch_args(t) -> tuple:
    """(device index, raw stream handle) for a launch on ``t``'s card and
    PyTorch's current stream there."""
    import torch

    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def load() -> ctypes.CDLL:
    """The kernels' library, built from the package sources if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        so = BUILD_DIR / f"libkhipu_kernels_{_key(srcs)}.so"
        label = f"{so.name} ({', '.join(s.name for s in srcs)})"
        if so.exists():
            compile_log.record("hit", label)
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(srcs, so)
            compile_log.record("miss", label, time.perf_counter() - t0)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        _LIB = lib
        return lib
