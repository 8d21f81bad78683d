"""Wrappers of the mirror's kernels K3 (hash) and K4 (verify) in
``csrc/mirror.cu``.

Both read a class's word-major rows: a 2-D int32 tensor [nwords, n] on
the card whose rows (words) may be strided, as a column slice of the
class's ``resident`` buffer is, but whose columns are contiguous.
``HASH_LAUNCHES`` counts K3's launches and ``VERIFY_LAUNCHES`` K4's;
each is raised only where its kernel is launched. The library is built
at first use (``ops/build.py``).
"""

from __future__ import annotations

import torch

from khipu_tpu_torch.ops import build

WORDS_PER_BLOCK = 34  # 136-byte rate / 4
HASH_LAUNCHES = 0
VERIFY_LAUNCHES = 0


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
    rc = lib.khipu_mirror_verify(
        planes.data_ptr(), planes.stride(0), n, nwords_in, nblocks,
        claimed.data_ptr(), claimed.stride(0), count.data_ptr(), dev, stream,
    )
    if rc:
        raise RuntimeError(f"K4 mirror verify launch failed: cudaError {rc}")
    build.count_launch(__name__, "VERIFY_LAUNCHES")
    return count
