"""Batched Keccak-256 dispatcher: kernel K1 on the card, plain PyTorch
on the CPU.

The public hashing entry points of the port. A CUDA tensor goes to K1
(``keccak_cuda``) and a failure there raises; a CPU tensor goes to the
plain version (``keccak_torch``). Nothing falls back from one to the
other.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
from khipu_tpu_torch.ops.keccak_torch import RATE


def hash_padded(
    padded: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """u8[N, nblocks*136] multi-rate padded rows -> u8[N, 32], on the
    rows' device."""
    if padded.is_cuda:
        return keccak_cuda.absorb_padded(padded, out)
    if padded.device.type != "cpu":
        raise ValueError(f"unsupported device {padded.device}")
    digests = keccak_torch.absorb_padded(padded)
    if out is None:
        return digests
    out.copy_(digests)
    return out


def keccak256_batch(messages: Sequence[bytes], device=None) -> List[bytes]:
    """Hash a batch of byte strings to 32-byte digests, in input order."""
    return keccak_torch.hash_messages(
        messages, resolve_device(device), hash_padded
    )


def keccak256_fixed(
    data: Union[np.ndarray, torch.Tensor], device=None
) -> torch.Tensor:
    """Hash N equal-length messages: u8[N, L] -> u8[N, 32] on ``device``.
    The multi-rate pad is applied on the device."""
    dev = resolve_device(device)
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.require(data, np.uint8, ["C", "W"]))
    data = data.to(dev)
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("expected u8[N, L]")
    n, length = data.shape
    width = (length // RATE + 1) * RATE
    padded = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    padded[:, :length] = data
    padded[:, length] ^= 0x01
    padded[:, width - 1] ^= 0x80
    return hash_padded(padded)
