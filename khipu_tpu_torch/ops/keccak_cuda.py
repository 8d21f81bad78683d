"""Wrappers of kernels K1 (padded rows -> digests) and K1f (unpadded
rows of one length, the pad fused) in ``csrc/keccak.cu``.

``LAUNCHES`` counts K1's launches and ``FIXED_LAUNCHES`` K1f's; each is
raised only where its kernel is launched. The library is built at first use (``ops/build.py``);
importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

from typing import Optional

import torch

from khipu_tpu_torch.ops import build

RATE = 136
LAUNCHES = 0
FIXED_LAUNCHES = 0


def _check_out(out, n: int, device) -> torch.Tensor:
    if out is None:
        return torch.empty((n, 32), dtype=torch.uint8, device=device)
    if (
        out.device != device
        or out.dtype != torch.uint8
        or tuple(out.shape) != (n, 32)
        or not out.is_contiguous()
        or out.data_ptr() % 8
    ):
        raise ValueError("out must be a contiguous, aligned u8[N, 32] on the same card")
    return out


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
    out = _check_out(out, n, padded.device)
    if n == 0:
        return out
    lib = build.load()
    dev, stream = build.launch_args(padded)
    rc = lib.khipu_keccak256_rows(
        padded.data_ptr(), out.data_ptr(), n, width // RATE, dev, stream
    )
    if rc:
        raise RuntimeError(f"K1 keccak kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def absorb_fixed(
    data: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1f: u8[N, L] unpadded rows of one length L (contiguous, on the
    card) -> u8[N, 32]; the multi-rate pad is XORed in registers. Rows
    are read as u32 words when L % 4 == 0 and as bytes otherwise."""
    global FIXED_LAUNCHES
    if not data.is_cuda:
        raise ValueError("K1f takes CUDA tensors only")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("K1f takes u8[N, L]")
    if not data.is_contiguous():
        raise ValueError("K1f needs contiguous rows")
    n, length = data.shape
    out = _check_out(out, n, data.device)
    if n == 0:
        return out
    words = length % 4 == 0 and data.data_ptr() % 4 == 0
    lib = build.load()
    dev, stream = build.launch_args(data)
    rc = lib.khipu_keccak256_fixed(
        data.data_ptr(), out.data_ptr(), n, length, int(words), dev, stream
    )
    if rc:
        raise RuntimeError(f"K1f keccak kernel launch failed: cudaError {rc}")
    FIXED_LAUNCHES += 1
    return out
