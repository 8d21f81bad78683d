"""Sharded batched Keccak-256 and snapshot verification over a mesh.

The counterpart of ``khipu_tpu/parallel/keccak_sharded.py``. The JAX
package jits one ``shard_map`` program a function: each chip pads, packs
and hashes its shard (``_fixed_digests``), and XLA's collectives stitch
the results. The port runs one process a rank (parallel/mesh.py): every
rank calls with the same whole batch, hashes its contiguous share with
the one-card kernels, and NCCL (gloo on the CPU) stitches the shares:

* fixed-length rows: K1f on the share (the pad fused in registers, so
  the share is uploaded as it is), then one all_gather of the digests;
* a ragged batch: K1r on the share, one launch whatever its rate
  classes (the JAX package buckets by class and pads each bucket), then
  one all_gather;
* snapshot verify: K1f on the share, ``ne().any(1).sum()`` against the
  share's keys, then one all_reduce of the count.

An all_gather takes equal sizes, so each share's digests are padded to
``ceil(n / world)`` rows; the gathered table is cut to ``n``. The shares
need no filler rows of their own, so no padding row is hashed or can
count as a mismatch.

Ledger sites, as in the JAX package: ``shard.keccak`` (a share's upload,
the digests back), ``shard.gather`` (the level table back),
``shard.verify`` (values and keys up, the count back).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from khipu_tpu_torch.observability.profiler import D2H, H2D, LEDGER
from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
from khipu_tpu_torch.ops.keccak import _WORD_DTYPES, stage_ragged
from khipu_tpu_torch.parallel.mesh import Mesh

Rows = Union[np.ndarray, torch.Tensor]


def _share_rows(data: Rows, lo: int, hi: int, mesh: Mesh,
                site: str) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``data`` on the rank's device, in a buffer
    whose alignment the wrappers accept at any L. ``data`` is u8[N, L]
    or 32-bit words [N, L/4], numpy or a tensor, as
    ``ops.keccak._as_rows`` takes it. A host share is uploaded alone into
    a buffer of its own, metered at ``site``; a share already on the
    card is a view unless it is misaligned."""
    part = data[lo:hi]
    if isinstance(part, np.ndarray):
        if part.dtype.itemsize == 4 and part.dtype.kind in "ui":
            part = np.require(part, "<u4", ["C"]).view(np.uint8)
        part = torch.from_numpy(np.require(part, np.uint8, ["C"]))
    if part.dim() == 2 and part.dtype in _WORD_DTYPES:
        part = part.contiguous().view(torch.uint8)
    if part.dim() != 2 or part.dtype != torch.uint8:
        raise ValueError("expected u8[N, L] or u32[N, L/4] rows")
    if part.device.type == "cpu":
        with LEDGER.transfer(site, H2D, part.numel()):
            return part.to(mesh.device).contiguous()
    # khipu-lint: ok KL001 the share already lies on a card: card to card, no
    # host bytes
    part = part.to(mesh.device)
    if not part.is_contiguous() or part.data_ptr() % 8:
        part = torch.empty(part.shape, dtype=part.dtype,
                           device=part.device).copy_(part)
    return part


def _hash_rows(rows: torch.Tensor, out: torch.Tensor) -> None:
    """K1f into ``out`` on the card, the plain sponge on the CPU."""
    if rows.is_cuda:
        keccak_cuda.absorb_fixed(rows, out)
    else:
        out.copy_(keccak_torch.absorb_fixed(rows))


def _gathered_digests(data: Rows, mesh: Mesh) -> torch.Tensor:
    """Every rank hashes its share of u8[N, L] and all_gathers: u8[N,
    32] on the rank's device."""
    n = int(data.shape[0])
    lo, hi = mesh.share(n)
    per = -(-n // mesh.size)
    local = torch.zeros((per, 32), dtype=torch.uint8, device=mesh.device)
    if hi > lo:
        _hash_rows(_share_rows(data, lo, hi, mesh, "shard.keccak"),
                   local[: hi - lo])
    return mesh.all_gather_rows(local)[:n]


def _to_host(t: torch.Tensor, site: str) -> np.ndarray:
    with LEDGER.transfer(site, D2H, t.numel() * t.element_size()):
        return t.cpu().numpy()


def keccak256_fixed_sharded(data: Rows, mesh: Mesh) -> np.ndarray:
    """Hash N equal-length messages across the mesh: u8[N, L] ->
    u8[N, 32], every digest on every rank."""
    if int(data.shape[0]) == 0:
        return np.zeros((0, 32), np.uint8)
    return _to_host(_gathered_digests(data, mesh), "shard.keccak")


def hash_level_all_gather(data: Rows, mesh: Mesh) -> np.ndarray:
    """Hash one trie level's nodes sharded; return the replicated digest
    table as the host sees it, u8[N, 32]."""
    if int(data.shape[0]) == 0:
        return np.zeros((0, 32), np.uint8)
    return _to_host(_gathered_digests(data, mesh), "shard.gather")


def keccak256_batch_sharded(messages: Sequence[bytes],
                            mesh: Mesh) -> List[bytes]:
    """Variable-length batch hashing across the mesh: the Hasher shape
    (Sequence[bytes] -> List[bytes]) that bulk_build and batch_commit
    take. Each rank packs its share once and hashes it in one K1r launch
    (the plain sponge on the CPU), then one all_gather."""
    n = len(messages)
    if n == 0:
        return []
    lo, hi = mesh.share(n)
    per = -(-n // mesh.size)
    local = torch.zeros((per, 32), dtype=torch.uint8, device=mesh.device)
    if hi > lo:
        blob, offsets, lengths = keccak_torch.pack_ragged(messages[lo:hi])
        up = offsets.nbytes + lengths.nbytes + blob.nbytes
        with LEDGER.transfer("shard.keccak", H2D, up):
            if mesh.device.type == "cuda":
                blob_d, header_d = stage_ragged(blob, offsets, lengths,
                                                mesh.device)
            else:
                blob_d = torch.from_numpy(blob)
        if mesh.device.type == "cuda":
            keccak_cuda.absorb_ragged(blob_d, offsets, lengths,
                                      out=local[: hi - lo], header=header_d)
        else:
            local[: hi - lo] = keccak_torch.absorb_ragged(
                blob_d, torch.from_numpy(offsets), torch.from_numpy(lengths))
    table = mesh.all_gather_rows(local)[:n]
    raw = _to_host(table, "shard.keccak").tobytes()
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def sharded_hasher(mesh: Mesh) -> Callable[[Sequence[bytes]], List[bytes]]:
    """Bind a mesh into a Hasher usable by trie.bulk.bulk_build and
    trie.deferred.batch_commit."""
    return lambda messages: keccak256_batch_sharded(messages, mesh)


def snapshot_verify_sharded(values: Rows, keys: Rows, mesh: Mesh) -> int:
    """Global count of nodes whose keccak256(value) != key: K1f on each
    rank's share of the values, compared with its share of the keys,
    and one all_reduce of the counts. Every rank returns the total."""
    if values.shape[0] != keys.shape[0]:
        raise ValueError("values/keys batch mismatch")
    lo, hi = mesh.share(int(values.shape[0]))
    bad = torch.zeros((), dtype=torch.int64, device=mesh.device)
    if hi > lo:
        vals = _share_rows(values, lo, hi, mesh, "shard.verify")
        claims = _share_rows(keys, lo, hi, mesh, "shard.verify")
        digests = torch.empty((hi - lo, 32), dtype=torch.uint8,
                              device=mesh.device)
        _hash_rows(vals, digests)
        bad += digests.ne(claims).any(1).sum()
    mesh.all_reduce_sum(bad)
    with LEDGER.transfer("shard.verify", D2H, 8):
        return int(bad.item())
