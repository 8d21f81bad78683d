"""Wrapper of kernel K5 (``csrc/fixpoint.cu``): the whole fixpoint of a
packed window, every level in one cooperative launch.

``LAUNCHES`` counts the kernel's launches; it is raised only where the
kernel is launched. The library is built at first use (``ops/build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from khipu_tpu_torch.ops import build

RATE = 136
LAUNCHES = 0


def _check_i32(name: str, t: torch.Tensor, dev, n=None) -> None:
    if t.device != dev or t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"{name} must be i32[n] on {dev}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} must have {n} entries")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_digest_rows(name: str, t: torch.Tensor, dev) -> None:
    if t.device != dev or t.dtype != torch.uint8 or t.dim() != 2 or (
        t.shape[1] != 32
    ):
        raise ValueError(f"{name} must be u8[*, 32] on {dev}")
    if not t.is_contiguous() or t.data_ptr() % 8:
        raise ValueError(f"{name} must be contiguous and 8-byte aligned")


def resolve_levels(encs: Sequence[torch.Tensor], bases: Sequence[int],
                   digests: torch.Tensor, ext: torch.Tensor,
                   order: torch.Tensor, level_ptr: torch.Tensor,
                   tptr: torch.Tensor, toff: torch.Tensor,
                   tchild: torch.Tensor, widest: int) -> None:
    """In place: every row of every class substituted and hashed, level
    by level. Class i holds global rows ``[bases[i], bases[i] +
    len(encs[i]))`` in ``encs[i]``, u8[nrows, nb*136]; the classes tile
    ``[0, total_rows)`` in order. ``digests`` u8[total_rows, 32] receives
    every row's digest; ``ext`` u8[n_ext, 32] holds the resolved-input
    rows that children at or past total_rows name. ``order``
    i32[total_rows], ``level_ptr`` i32[L + 1], ``tptr`` i32[total_rows +
    1], ``toff``/``tchild`` i32[n]: the level plan of ``fused.pack``,
    which builds and range-checks them; the kernel does not check them
    again. ``widest`` is the largest level's row count (grid size)."""
    if not digests.is_cuda:
        raise ValueError("K5 takes CUDA tensors only")
    dev = digests.device
    if not encs or len(encs) != len(bases):
        raise ValueError("one base per class, at least one class")
    row = 0
    for e, b in zip(encs, bases):
        if e.device != dev or e.dtype != torch.uint8 or e.dim() != 2:
            raise ValueError(f"encodings must be u8[nrows, width] on {dev}")
        if e.shape[1] == 0 or e.shape[1] % RATE:
            raise ValueError(f"row width {e.shape[1]} is not a multiple of {RATE}")
        if not e.is_contiguous() or e.data_ptr() % 8:
            raise ValueError("encodings must be contiguous and 8-byte aligned")
        if b != row:
            raise ValueError(f"class base {b} != {row}: classes must tile the rows")
        row += e.shape[0]
    _check_digest_rows("digests", digests, dev)
    _check_digest_rows("ext", ext, dev)
    total_rows = digests.shape[0]
    if row != total_rows:
        raise ValueError(f"classes hold {row} rows, digests {total_rows}")
    _check_i32("order", order, dev, total_rows)
    _check_i32("level_ptr", level_ptr, dev)
    _check_i32("tptr", tptr, dev, total_rows + 1)
    _check_i32("toff", toff, dev)
    _check_i32("tchild", tchild, dev, toff.shape[0])
    nlevels = level_ptr.shape[0] - 1
    if nlevels < 1:
        raise ValueError("level_ptr needs at least two entries")
    k = len(encs)
    # khipu-lint: ok KL001 K5's launch table, 8 B x (3 x classes + 1) a
    # launch, not metered: under 100 B beside the pack each caller meters
    # (seal.upload, shard.dispatch)
    table = torch.tensor(
        [e.data_ptr() for e in encs] + list(bases) + [total_rows]
        + [e.shape[1] // RATE for e in encs],
        dtype=torch.int64,
    ).to(dev)
    lib = build.load()
    index, stream = build.launch_args(digests)
    rc = lib.khipu_fixpoint_levels(
        table.data_ptr(), k, order.data_ptr(), level_ptr.data_ptr(), nlevels,
        tptr.data_ptr(), toff.data_ptr(), tchild.data_ptr(),
        digests.data_ptr(), ext.data_ptr(), total_rows, int(widest),
        index, stream,
    )
    if rc:
        raise RuntimeError(f"K5 fixpoint kernel launch failed: cudaError {rc}")
    build.count_launch(__name__, "LAUNCHES")


def occupancy(device=None) -> Tuple[int, int]:
    """(K5 blocks co-resident on one SM, SMs of the card): the largest
    grid K5's cooperative launch may take."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = build.load().khipu_fixpoint_levels_occupancy(
        index, ctypes.byref(per_sm), ctypes.byref(sms))
    if rc:
        raise RuntimeError(f"K5 occupancy query failed: cudaError {rc}")
    return per_sm.value, sms.value
