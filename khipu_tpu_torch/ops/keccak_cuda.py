"""Wrapper of kernel K1 (``csrc/keccak.cu``): padded rows -> digests.

``LAUNCHES`` counts the kernel's launches; it is raised only where the
kernel is launched. The library is built at first use (``ops/build.py``);
importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

from typing import Optional

import torch

from khipu_tpu_torch.ops import build

RATE = 136
LAUNCHES = 0


def absorb_padded(
    padded: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """u8[N, nblocks*136] (multi-rate padded, on the card) -> u8[N, 32].
    ``out``, when given, is a contiguous u8[N, 32] on the same card (a
    row slice of a larger digest tensor is fine)."""
    global LAUNCHES
    if not padded.is_cuda:
        raise ValueError("K1 takes CUDA tensors only")
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("K1 takes u8[N, nblocks*136]")
    n, width = padded.shape
    if width == 0 or width % RATE:
        raise ValueError(f"row width {width} is not a multiple of {RATE}")
    if not padded.is_contiguous() or padded.data_ptr() % 8:
        raise ValueError("K1 needs contiguous, 8-byte aligned rows")
    if out is None:
        out = torch.empty((n, 32), dtype=torch.uint8, device=padded.device)
    elif (
        out.device != padded.device
        or out.dtype != torch.uint8
        or tuple(out.shape) != (n, 32)
        or not out.is_contiguous()
        or out.data_ptr() % 8
    ):
        raise ValueError("out must be a contiguous, aligned u8[N, 32] on the same card")
    if n == 0:
        return out
    lib = build.load()
    dev = padded.device.index if padded.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    rc = lib.khipu_keccak256_rows(
        padded.data_ptr(), out.data_ptr(), n, width // RATE, dev, stream
    )
    if rc:
        raise RuntimeError(f"K1 keccak kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
