"""Wrappers of kernels K1f (unpadded rows of one length, the pad fused)
and K1r (messages of any lengths in one blob, the pad fused) in
``csrc/keccak.cu``.

``FIXED_LAUNCHES`` counts K1f's launches and ``RAGGED_LAUNCHES`` K1r's;
each is raised only where its kernel is launched, through
``build.count_launch``. The
library is built at first use (``ops/build.py``); importing this module
needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from khipu_tpu_torch.observability.profiler import H2D, LEDGER
from khipu_tpu_torch.ops import build

FIXED_LAUNCHES = 0
RAGGED_LAUNCHES = 0
# K1r's column mode (five threads a message) up to this many rows, row
# mode (one thread a message) above. While a batch's warps (six messages
# each) fit one to an SM sub-partition (132 SMs x 4 x 6 = 3,168 rows),
# one message's serial chain of permutations is the cost and column
# mode's chain is the shorter; past that, warps share sub-partitions and
# row mode, with about half the instructions a message, wins. The mode
# sweep of scripts/k1_ablation.py (576 B rows) measures the crossover.
COLUMN_MAX_ROWS = 3000


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


def absorb_fixed(
    data: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1f: u8[N, L] unpadded rows of one length L (contiguous, on the
    card) -> u8[N, 32]; the multi-rate pad is XORed in registers. Rows
    are read as u32 words when L % 4 == 0 and as bytes otherwise."""
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
    _count("FIXED_LAUNCHES")
    return out


def _count(name: str) -> None:
    """One more launch on the counter ``name``; safe across threads."""
    build.count_launch(__name__, name)


def ragged_mode(n: int) -> str:
    """K1r's layout for a batch of ``n`` rows. Column mode runs each
    permutation on five threads, a shorter serial chain that wins while
    the card has SMs to spare; row mode issues about half the
    instructions a message and wins once the rows fill the card."""
    return "column" if n <= COLUMN_MAX_ROWS else "row"


def _host_header(offsets, lengths, size: int):
    """K1r's header, checked: offsets and lengths as host int32[n] arrays
    (numpy or CPU tensors); each offset a multiple of 8 and each message,
    rounded up to 8 bytes, inside a blob of ``size`` bytes. Returns one
    int32[2n] array, offsets then lengths."""
    parts = []
    for name, v in (("offsets", offsets), ("lengths", lengths)):
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                raise ValueError(f"K1r takes {name} on the host")
            v = v.numpy()
        if not isinstance(v, np.ndarray) or v.dtype != np.int32 or v.ndim != 1:
            raise ValueError(f"K1r takes {name} as host int32[n]")
        parts.append(v)
    off, lens = parts
    if off.shape != lens.shape:
        raise ValueError("K1r takes offsets and lengths of one length")
    if off.size:
        if (lens < 0).any() or (off < 0).any():
            raise ValueError("K1r takes no negative offset or length")
        if (off % 8).any():
            raise ValueError("K1r needs 8-byte aligned offsets")
        ends = off.astype(np.int64) + ((lens.astype(np.int64) + 7) & ~7)
        if int(ends.max()) > size:
            raise ValueError("a K1r message runs past the blob (offsets "
                             "out of bounds)")
    return np.concatenate([off, lens])


def absorb_ragged(
    blob: torch.Tensor,
    offsets,
    lengths,
    out: Optional[torch.Tensor] = None,
    mode: Optional[str] = None,
    header: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1r: message i is ``lengths[i]`` bytes of the u8[B] ``blob`` (on
    the card, 8-byte aligned) at ``offsets[i]`` -> u8[n, 32] on the card.
    The header (host int32 offsets and lengths) is checked here, then
    uploaded in one copy, unless ``header`` is given: the caller's device
    copy of those same arrays, int32[2n] (offsets, then lengths),
    uploaded together with the blob. The multi-rate pad is XORed in
    registers. ``mode`` forces "row" or "column"; by default
    ``ragged_mode(n)``."""
    if blob.dtype != torch.uint8 or blob.dim() != 1:
        raise ValueError("K1r takes a u8[B] blob")
    if blob.numel() >= 1 << 31:
        raise ValueError("K1r takes a blob under 2 GiB (int32 offsets)")
    host = _host_header(offsets, lengths, blob.numel())
    n = host.size // 2
    if not blob.is_cuda:
        raise ValueError("K1r takes a blob on the card")
    if not blob.is_contiguous() or blob.data_ptr() % 8:
        raise ValueError("K1r needs a contiguous, 8-byte aligned blob")
    mode = ragged_mode(n) if mode is None else mode
    if mode not in ("row", "column"):
        raise ValueError(f"unknown K1r mode {mode!r}")
    out = _check_out(out, n, blob.device)
    if header is not None and (
            header.device != blob.device or header.dtype != torch.int32
            or tuple(header.shape) != (2 * n,) or not header.is_contiguous()):
        raise ValueError("K1r's header is int32[2n] on the blob's card")
    if n == 0:
        return out
    if header is None:
        with LEDGER.transfer("ops.keccak", H2D, host.nbytes):
            header = torch.from_numpy(host).to(blob.device)
    lib = build.load()
    dev, stream = build.launch_args(blob)
    rc = lib.khipu_keccak256_ragged(
        blob.data_ptr(), header.data_ptr(), out.data_ptr(), n,
        int(mode == "column"), dev, stream,
    )
    if rc:
        raise RuntimeError(f"K1r keccak kernel launch failed: cudaError {rc}")
    _count("RAGGED_LAUNCHES")
    return out
