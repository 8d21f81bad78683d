"""Batched Keccak-256 dispatcher: kernels K1r and K1f on the card, plain
PyTorch on the CPU.

The public hashing entry points of the port. A CUDA tensor goes to a
kernel (``keccak_cuda``) and a failure there raises; a CPU tensor goes
to the plain version (``keccak_torch``). Nothing falls back from one to
the other.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability.profiler import D2H, H2D, LEDGER
from khipu_tpu_torch.observability.trace import span
from khipu_tpu_torch.ops import keccak_cuda, keccak_torch


def keccak256_batch(messages: Sequence[bytes], device=None) -> List[bytes]:
    """Hash a batch of byte strings to 32-byte digests, in input order.
    The messages are packed once into one blob (no padding on the host);
    on the card that is one upload (``stage_ragged``), one K1r launch
    whatever the mix of rate classes, and one copy of the digests back.
    Spans: ``keccak.pack``, ``keccak.dispatch`` (upload and launch),
    ``keccak.collect`` (the wait and the copy back). Ledger site
    ``ops.keccak``: the header and blob up, the digests back (metered on
    the CPU path too, where the copies are no-ops)."""
    dev = resolve_device(device)
    if not messages:
        return []
    with span("keccak.pack"):
        blob, offsets, lengths = keccak_torch.pack_ragged(messages)
    with span("keccak.dispatch"):
        up = offsets.nbytes + lengths.nbytes + blob.nbytes
        if dev.type == "cuda":
            with LEDGER.transfer("ops.keccak", H2D, up):
                blob_d, header_d = stage_ragged(blob, offsets, lengths, dev)
            out = keccak_cuda.absorb_ragged(blob_d, offsets, lengths,
                                            header=header_d)
        else:
            with LEDGER.transfer("ops.keccak", H2D, up):
                args = (torch.from_numpy(blob), torch.from_numpy(offsets),
                        torch.from_numpy(lengths))
            out = keccak_torch.absorb_ragged(*args)
    with span("keccak.collect"):
        with LEDGER.transfer("ops.keccak", D2H,
                             out.numel() * out.element_size()):
            raw = out.cpu().numpy().tobytes()
        return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def stage_ragged(blob: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                 dev: torch.device):
    """Upload a packed batch in one copy: header (int32 offsets, then
    lengths) and blob laid end to end in host memory (pinned when ``dev``
    is a card), copied without blocking. Returns the device blob and
    header, views of one buffer (the blob starts 8-byte aligned, after 8n
    header bytes)."""
    n = offsets.size
    staged = torch.empty(8 * n + blob.size, dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    host = staged.numpy()
    host[: 4 * n] = offsets.view(np.uint8)
    host[4 * n : 8 * n] = lengths.view(np.uint8)
    host[8 * n :] = blob
    # khipu-lint: ok KL001 metered by each caller's transfer around
    # stage_ragged (ops.keccak, shard.keccak)
    dev_buf = staged.to(dev, non_blocking=True)
    return dev_buf[8 * n :], dev_buf[: 8 * n].view(torch.int32)


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
    if data.device.type != "cpu":
        # khipu-lint: ok KL001 a tensor already on a device: card to card, no
        # host bytes (a host array is metered below)
        return data.to(dev).contiguous()
    with LEDGER.transfer("ops.keccak", H2D,
                         data.numel() * data.element_size()):
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
