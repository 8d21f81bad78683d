"""Wrapper of kernel K2 (``csrc/fixpoint.cu``): the fixpoint's
substitution scatter for one rate class and one round.

``LAUNCHES`` counts the kernel's launches; it is raised only where the
kernel is launched. The library is built at first use (``ops/build.py``).
"""

from __future__ import annotations

import torch

from khipu_tpu_torch.ops import build

LAUNCHES = 0


def substitute(enc, rows, offs, child, digests, ext, total_rows: int) -> None:
    """In place: ``enc[rows[i], offs[i]:offs[i]+32] = src[child[i]]`` with
    ``src`` = ``digests`` below ``total_rows`` and ``ext`` above.

    enc u8[nrows, width]; rows/offs/child i32[n]; digests
    u8[total_rows, 32]; ext u8[n_ext, 32] — all contiguous on one card.
    Indices are built and range-checked by the host pack
    (``fused.pack``); the kernel does not check them again."""
    global LAUNCHES
    dev = enc.device
    if not enc.is_cuda:
        raise ValueError("K2 takes CUDA tensors only")
    if enc.dtype != torch.uint8 or enc.dim() != 2:
        raise ValueError("enc must be u8[nrows, width]")
    for name, t in (("rows", rows), ("offs", offs), ("child", child)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be i32[n] on {dev}")
    n = rows.shape[0]
    if offs.shape[0] != n or child.shape[0] != n:
        raise ValueError("rows, offs and child differ in length")
    for name, t in (("digests", digests), ("ext", ext)):
        if t.device != dev or t.dtype != torch.uint8 or t.dim() != 2 or (
            t.shape[1] != 32
        ):
            raise ValueError(f"{name} must be u8[*, 32] on {dev}")
    if digests.shape[0] != total_rows:
        raise ValueError("digests must have total_rows rows")
    tensors = (enc, rows, offs, child, digests, ext)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K2 needs contiguous tensors")
    if n == 0:
        return
    lib = build.load()
    index, stream = build.launch_args(enc)
    rc = lib.khipu_fixpoint_substitute(
        enc.data_ptr(), enc.shape[1], rows.data_ptr(), offs.data_ptr(),
        child.data_ptr(), n, digests.data_ptr(), ext.data_ptr(), total_rows,
        index, stream,
    )
    if rc:
        raise RuntimeError(f"K2 fixpoint kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
