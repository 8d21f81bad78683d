"""Keccak-256 in plain PyTorch: the sponge over padded rows
(``absorb_padded``, which the mirror's and the fixpoint's plain versions
call) and the plain versions of kernels K1f (``absorb_fixed``) and K1r
(``absorb_ragged``).

The sponge runs on int64 tensors shaped [25, N] (lane, message), so each
step of a round is one tensor op over every lane of every message. The
CPU build of torch has no ``~``, ``<<`` or ``>>`` for uint64, so lanes
are int64: left shifts wrap as they would on u64, and every right shift
is masked to stay logical. The same code runs on CUDA tensors, where
``chip_smoke.py`` holds the kernel against it.

Also here: the ragged packer (``pack_ragged``: messages at 8-byte
aligned offsets of one blob, no padding), and the host-side padding
helper, copied from the JAX package's ``ops/keccak_jnp.py`` (that module
imports jax), which the bucketed ``keccak256_batch_plain`` and the tests
use.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from khipu_tpu_torch.base.keccak import ROTATION, ROUND_CONSTANTS

RATE = 136  # keccak-256 rate in bytes
LANES_PER_BLOCK = RATE // 8  # 17 u64 lanes absorbed per block


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_RC = tuple(_signed(rc) for rc in ROUND_CONSTANTS)
# per-lane rho rotation, lane index x + 5y
_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _ROT[_x + 5 * _y] = ROTATION[_x][_y]
# pi: destination lane y + 5((2x + 3y) % 5) takes source lane x + 5y
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Per-device constant tensors of the permutation: rho's left and
    right shifts, its low-bit masks, and pi's source lanes."""
    # khipu-lint: ok KL001 a few hundred constant bytes, once a device
    rot = torch.tensor(_ROT, dtype=torch.int64, device=device)[:, None]
    return (
        rot,
        (64 - rot) % 64,
        (torch.ones_like(rot) << rot) - 1,  # low `rot` bits
        # khipu-lint: ok KL001 as above
        torch.tensor(_PI_SRC, dtype=torch.int64, device=device),
    )


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def f1600(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over int64[25, N]; returns the new state."""
    rot, rrot, rmask, pi_src = _consts(a.device)
    n = a.shape[1]
    for rc in _RC:
        s = a.view(5, 5, n)  # [y, x, N]
        # theta
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]  # [x, N]
        d = torch.roll(c, 1, 0) ^ _rotl(torch.roll(c, -1, 0), 1)
        a = (s ^ d[None]).reshape(25, n)
        # rho (per-lane rotation; lane 0 rotates by 0 and its mask is 0)
        a = (a << rot) | ((a >> rrot) & rmask)
        # pi
        b = a[pi_src].view(5, 5, n)
        # chi
        a = (b ^ (~torch.roll(b, -1, 1) & torch.roll(b, -2, 1))).reshape(25, n)
        # iota
        a[0] ^= rc
    return a


def absorb_padded(padded_u8: torch.Tensor) -> torch.Tensor:
    """Hash multi-rate padded rows: u8[N, nblocks*136] -> u8[N, 32],
    on the tensor's own device."""
    if padded_u8.dtype != torch.uint8 or padded_u8.dim() != 2:
        raise ValueError("expected u8[N, nblocks*136]")
    n, width = padded_u8.shape
    if width == 0 or width % RATE:
        raise ValueError(f"row width {width} is not a multiple of {RATE}")
    nblocks = width // RATE
    words = padded_u8.contiguous().view(torch.int64)  # [N, nblocks*17]
    a = torch.zeros(25, n, dtype=torch.int64, device=padded_u8.device)
    for b in range(nblocks):
        blk = words[:, b * LANES_PER_BLOCK : (b + 1) * LANES_PER_BLOCK]
        a[:LANES_PER_BLOCK] ^= blk.t()
        a = f1600(a)
    return a[:4].t().contiguous().view(torch.uint8).reshape(n, 32)


def pad_fixed(data_u8: torch.Tensor) -> torch.Tensor:
    """Multi-rate pad N messages of one length L on their own device:
    u8[N, L] -> u8[N, (L // 136 + 1) * 136]. The pad XORs, so L % 136 ==
    135 puts 0x81 in one byte and L % 136 == 0 adds a block of padding
    alone."""
    if data_u8.dtype != torch.uint8 or data_u8.dim() != 2:
        raise ValueError("expected u8[N, L]")
    n, length = data_u8.shape
    width = (length // RATE + 1) * RATE
    padded = torch.zeros((n, width), dtype=torch.uint8, device=data_u8.device)
    padded[:, :length] = data_u8
    padded[:, length] ^= 0x01
    padded[:, width - 1] ^= 0x80
    return padded


def absorb_fixed(data_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of K1f: u8[N, L] unpadded rows of one length ->
    u8[N, 32], on the tensor's own device."""
    return absorb_padded(pad_fixed(data_u8))


# rows of one rate class gathered at a time by ``absorb_ragged``
_RAGGED_CHUNK = 1 << 17
_GAPS = tuple(bytes(k) for k in range(8))


def pack_ragged(messages: Sequence[bytes]):
    """Pack messages for K1r: ``(blob, offsets, lengths)``, numpy u8[B]
    and int32[n] x 2. Message i sits at ``offsets[i]``, a multiple of 8,
    followed by zeros up to the next multiple of 8; nothing is padded to
    a rate block."""
    n = len(messages)
    lengths = np.fromiter(map(len, messages), dtype=np.int64, count=n)
    spans = (lengths + 7) & ~7
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(spans[:-1], out=offsets[1:])
    if n and int(offsets[-1] + spans[-1]) >= 1 << 31:
        raise ValueError("a ragged batch holds at most 2 GiB")
    blob = bytearray().join(
        [part for m in messages for part in (m, _GAPS[-len(m) & 7])]
    )
    return (np.frombuffer(blob, dtype=np.uint8), offsets.astype(np.int32),
            lengths.astype(np.int32))


def absorb_ragged(
    blob: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Plain version of K1r: message i is ``lengths[i]`` bytes of the u8
    ``blob`` at ``offsets[i]``; returns u8[n, 32] on the blob's device.
    Bucketed by rate class: each class's rows are gathered, padded and
    hashed with ``absorb_padded``."""
    if blob.dtype != torch.uint8 or blob.dim() != 1:
        raise ValueError("expected a u8[B] blob")
    dev = blob.device
    off = offsets.to(dev, torch.int64)
    lens = lengths.to(dev, torch.int64)
    if off.shape != lens.shape or off.dim() != 1:
        raise ValueError("offsets and lengths must be int[n] of one length")
    n = off.numel()
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    # bytes past the blob never count (they are masked), so an empty blob
    # reads as one zero byte
    src = blob if blob.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    nblocks = lens // RATE + 1
    for nb in torch.unique(nblocks).tolist():
        width = nb * RATE
        cols = torch.arange(width, device=dev)
        for idx in torch.nonzero(nblocks == nb).flatten().split(_RAGGED_CHUNK):
            length = lens[idx, None]
            pos = (off[idx, None] + cols).clamp_(0, src.numel() - 1)
            rows = torch.where(cols < length, src[pos], 0).to(torch.uint8)
            rows[torch.arange(idx.numel(), device=dev), lens[idx]] ^= 0x01
            rows[:, width - 1] ^= 0x80
            out[idx] = absorb_padded(rows)
    return out


def pad_to_words(messages: Sequence[bytes], nblocks: int) -> np.ndarray:
    """Host-side multi-rate padding, batch-major: uint32[B, nblocks*34]
    (``.view(np.uint8)`` gives the padded rows). The pad XORs, so a
    message of length 135 mod 136 carries 0x81 in one byte."""
    batch = len(messages)
    buf = np.zeros((batch, nblocks * RATE), dtype=np.uint8)
    for j, m in enumerate(messages):
        if len(m) // RATE + 1 != nblocks:
            raise ValueError(
                f"message {j} needs {len(m)//RATE + 1} blocks, "
                f"class is {nblocks}"
            )
        buf[j, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        buf[j, len(m)] ^= 0x01
        buf[j, nblocks * RATE - 1] ^= 0x80
    return buf.view("<u4")  # (B, nblocks*34)


def keccak256_batch_plain(messages: Sequence[bytes], device="cpu") -> List[bytes]:
    """A plain version of ``ops.keccak.keccak256_batch`` on ``device``,
    independent of K1r's packing: bucket by rate class, pad each bucket
    on the host, ``absorb_padded`` it and scatter the digests back in
    input order. On the card it is an oracle for the kernel, and a hasher
    for the level loop that launches no kernel."""
    buckets = {}
    for idx, m in enumerate(messages):
        buckets.setdefault(len(m) // RATE + 1, []).append(idx)
    out: List[bytes] = [b""] * len(messages)
    for nblocks, idxs in sorted(buckets.items()):
        rows = pad_to_words([messages[i] for i in idxs], nblocks).view(np.uint8)
        digests = absorb_padded(torch.from_numpy(rows).to(device))
        blob = digests.cpu().numpy().tobytes()
        for j, i in enumerate(idxs):
            out[i] = blob[32 * j : 32 * j + 32]
    return out
