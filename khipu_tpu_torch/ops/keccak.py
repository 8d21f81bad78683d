"""Batched Keccak-256 dispatcher: kernels K1 and K1f on the card, plain
PyTorch on the CPU.

The public hashing entry points of the port. A CUDA tensor goes to K1
or K1f (``keccak_cuda``) and a failure there raises; a CPU tensor goes
to the plain version (``keccak_torch``). Nothing falls back from one to
the other.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.ops import keccak_cuda, keccak_torch


def hash_padded(padded: torch.Tensor) -> torch.Tensor:
    """u8[N, nblocks*136] multi-rate padded rows -> u8[N, 32], on the
    rows' device."""
    if padded.is_cuda:
        return keccak_cuda.absorb_padded(padded)
    if padded.device.type != "cpu":
        raise ValueError(f"unsupported device {padded.device}")
    return keccak_torch.absorb_padded(padded)


def keccak256_batch(messages: Sequence[bytes], device=None) -> List[bytes]:
    """Hash a batch of byte strings to 32-byte digests, in input order."""
    return keccak_torch.hash_messages(
        messages, resolve_device(device), hash_padded
    )


_WORD_DTYPES = tuple(
    t for t in (torch.int32, getattr(torch, "uint32", None)) if t is not None
)


def _as_rows(data: Union[np.ndarray, torch.Tensor], dev) -> torch.Tensor:
    """u8[N, L] rows on ``dev`` from u8[N, L] or 32-bit words [N, L/4]
    (numpy or torch; words are read little-endian)."""
    if isinstance(data, np.ndarray):
        if data.dtype.itemsize == 4 and data.dtype.kind in "ui":
            data = np.require(data, "<u4", ["C"]).view(np.uint8)
        data = torch.from_numpy(np.require(data, np.uint8, ["C", "W"]))
    if data.dim() != 2:
        raise ValueError("expected u8[N, L] or u32[N, L/4]")
    if data.dtype in _WORD_DTYPES:
        data = data.contiguous().view(torch.uint8)
    if data.dtype != torch.uint8:
        raise ValueError("expected u8[N, L] or u32[N, L/4]")
    return data.to(dev).contiguous()



def keccak256_device_fixed(
    data: Union[np.ndarray, torch.Tensor], device=None
) -> torch.Tensor:
    """Hash N messages of one length L: u8[N, L], or 32-bit words
    [N, L/4], -> u8[N, 32] on ``device``. No padded copy is built on the
    card: K1f XORs the multi-rate pad in registers. The counterpart of
    the JAX package's ``_build_device_fixed`` and
    ``_build_device_fixed_words``."""
    rows = _as_rows(data, resolve_device(device))
    if rows.is_cuda:
        return keccak_cuda.absorb_fixed(rows)
    return keccak_torch.absorb_fixed(rows)


def keccak256_fixed(
    data: Union[np.ndarray, torch.Tensor], device=None
) -> torch.Tensor:
    """Hash N equal-length messages: u8[N, L] -> u8[N, 32] on ``device``.
    The same function as ``keccak256_device_fixed`` (K1f on the card);
    the name stays because the JAX package's API has both
    (``keccak256_fixed`` and ``_build_device_fixed``)."""
    return keccak256_device_fixed(data, device)
