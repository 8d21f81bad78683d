"""Wrappers of the mirror's kernels K3 (hash) and K4 (verify) in
``csrc/mirror.cu``.

Both read a class's word-major rows: a 2-D int32 tensor [nwords, n] on
the card whose rows (words) may be strided, as a column slice of the
class's ``resident`` buffer is, but whose columns are contiguous.
K4 reads them through TMA tensor maps, which need the planes' and the
claims' bases 16-byte aligned and their row strides a multiple of 4
words (``verify_plan``): a whole class, or a column slice from column 0.
``HASH_LAUNCHES`` counts K3's launches and ``VERIFY_LAUNCHES`` K4's;
each is raised only where its kernel is launched. The library is built
at first use (``ops/build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Tuple

import torch

from khipu_tpu_torch.ops import build

WORDS_PER_BLOCK = 34  # 136-byte rate / 4
TILE_ROWS = 128  # K4: rows a CTA's tile, the inner extent of its TMA box
MAPS_BYTES = 256  # K4: two CUtensorMaps, the planes' and the claims'
MAPS_CACHED = 64
HASH_LAUNCHES = 0
VERIFY_LAUNCHES = 0

# K4's encoded tensor maps by (planes' base, row stride, n, nwords_in,
# claims' base, row stride): a pure function of the key, so an entry
# stays right whatever tensor later lies at that address
_MAPS: Dict[tuple, ctypes.Array] = {}
# K4's CTAs resident on a whole card at once, by card
_CAPS: Dict[int, int] = {}


def _check_planes(name: str, t: torch.Tensor, rows: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: K3/K4 take CUDA tensors only")
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} must be int32[{rows}, n]")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs contiguous columns (stride(1) == 1)")


def _check_class(planes: torch.Tensor, nblocks: int, nwords_in: int) -> None:
    if not 0 < nwords_in <= nblocks * WORDS_PER_BLOCK:
        raise ValueError(
            f"nwords_in {nwords_in} outside (0, {nblocks * WORDS_PER_BLOCK}]"
        )
    if nwords_in < nblocks * WORDS_PER_BLOCK and nwords_in // WORDS_PER_BLOCK != nblocks - 1:
        raise ValueError(f"{nwords_in} unpadded words need another block count")
    _check_planes("planes", planes, nwords_in)


def hash_planes(planes: torch.Tensor, nblocks: int, nwords_in: int,
                out: torch.Tensor) -> torch.Tensor:
    """K3: digests of the ``n`` rows of ``planes`` (int32[nwords_in, n],
    ``nwords_in == nblocks * 34`` for padded rows, fewer for unpadded
    rows of an exact-length class) into ``out`` int32[8, n], word-major.
    ``out`` may be a column slice of a larger buffer."""
    _check_class(planes, nblocks, nwords_in)
    n = planes.shape[1]
    _check_planes("out", out, 8)
    if out.shape[1] != n or out.device != planes.device:
        raise ValueError("out must be int32[8, n] on the planes' card")
    if n == 0:
        return out
    lib = build.load()
    dev, stream = build.launch_args(planes)
    rc = lib.khipu_mirror_hash(
        planes.data_ptr(), planes.stride(0), n, nwords_in, nblocks,
        out.data_ptr(), out.stride(0), dev, stream,
    )
    if rc:
        raise RuntimeError(f"K3 mirror hash launch failed: cudaError {rc}")
    build.count_launch(__name__, "HASH_LAUNCHES")
    return out


def verify_plan(n: int, cap: int, maps: Iterable[Tuple[int, int]]) -> int:
    """K4's grid for ``n`` rows: a CTA a tile of ``TILE_ROWS`` rows, and
    at most ``cap`` CTAs (as many as the card holds at once), which then
    walk the remaining tiles. ``maps`` are the (base address, row stride
    in words) of the planes and of the claims. A tensor map needs each
    base 16-byte aligned and each row stride a multiple of 16 bytes, and
    TMA coordinates are signed 32-bit, so n < 2**31: ``ValueError``
    otherwise."""
    if not 0 < n < 2 ** 31:
        raise ValueError(f"K4 takes 0 < n < 2**31 rows, not {n}")
    for base, ld in maps:
        if base % 16:
            raise ValueError(f"K4's tensor maps need 16-byte aligned bases, not {base:#x}")
        if ld % 4:
            raise ValueError(
                f"K4's tensor maps need row strides of a multiple of 4 words, not {ld}")
    if cap < 1:
        raise ValueError(f"K4 fits no CTA on the card (cap {cap})")
    return min(-(-n // TILE_ROWS), cap)


def _cap(lib, dev: int) -> int:
    cap = _CAPS.get(dev)
    if cap is None:
        out = ctypes.c_int(0)
        rc = lib.khipu_mirror_verify_cap(dev, ctypes.byref(out))
        if rc:
            raise RuntimeError(f"K4 occupancy query failed: cudaError {rc}")
        cap = _CAPS[dev] = out.value
    return cap


def _maps(lib, planes: torch.Tensor, claimed: torch.Tensor, n: int,
          nwords_in: int) -> ctypes.Array:
    key = (planes.data_ptr(), planes.stride(0), n, nwords_in,
           claimed.data_ptr(), claimed.stride(0))
    maps = _MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(MAPS_BYTES)
        rc = lib.khipu_mirror_verify_maps(key[0], key[1], n, nwords_in,
                                          key[4], key[5], maps)
        if rc:
            raise RuntimeError(f"K4 tensor map encode failed: CUresult {rc}")
        if len(_MAPS) >= MAPS_CACHED:
            _MAPS.clear()
        _MAPS[key] = maps
    return maps


def verify_planes(planes: torch.Tensor, claimed: torch.Tensor, nblocks: int,
                  nwords_in: int) -> torch.Tensor:
    """K4: the number of rows of ``planes`` whose digest differs from
    ``claimed`` (int32[8, n]), as an int32[1] tensor on the card; the
    caller reads it when it needs it."""
    _check_class(planes, nblocks, nwords_in)
    n = planes.shape[1]
    _check_planes("claimed", claimed, 8)
    if claimed.shape[1] != n or claimed.device != planes.device:
        raise ValueError("claimed must be int32[8, n] on the planes' card")
    count = torch.zeros(1, dtype=torch.int32, device=planes.device)
    if n == 0:
        return count
    lib = build.load()
    dev, stream = build.launch_args(planes)
    grid = verify_plan(n, _cap(lib, dev),
                       [(planes.data_ptr(), planes.stride(0)),
                        (claimed.data_ptr(), claimed.stride(0))])
    rc = lib.khipu_mirror_verify(_maps(lib, planes, claimed, n, nwords_in), n,
                                 nwords_in, nblocks, grid, count.data_ptr(),
                                 dev, stream)
    if rc:
        raise RuntimeError(f"K4 mirror verify launch failed: cudaError {rc}")
    build.count_launch(__name__, "VERIFY_LAUNCHES")
    return count
