"""Fused window finalize: the whole placeholder DAG in one fixpoint.

The level-synchronous finalize (deferred.finalize) issues one batched
hash call per trie level. This module resolves every staged node of a
window (or of a bulk build) with a FIXPOINT iteration instead:

  1. The host packs every staged node's raw encoding (multi-rate padded)
     into per-rate-class u8 tensors and scans each encoding once for
     its placeholder spans -> substitution triples
     (parent_row, byte_offset, child_index).
  2. ``rounds`` times, on the device:
         G = keccak(every row of every class)     # kernel K1, per class
         enc[row, off:off+32] = G[child]          # kernel K2, per class
     After k rounds every node within k levels of the leaves carries
     its final digest, so ``rounds = depth`` resolves the DAG.

Substitution is length-invariant (a placeholder is exactly 32 bytes,
replaced by a 32-byte hash; RLP headers never change), so byte offsets
recorded from the RAW encodings stay valid through every round.

On the card K1 and K2 are the hand-written kernels; on the CPU the
same loop runs the plain versions (``keccak_torch.absorb_padded`` and
``_substitute_plain``). The JAX package pads rows and triples to
compile-friendly buckets (1024-row tiles, pow-2 counts); the port
compiles nothing per shape, so a class holds its real rows plus one
spare filler row, and only real triples.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability import REGISTRY, span as _span
from khipu_tpu_torch.ops.keccak import hash_padded
from khipu_tpu_torch.ops.keccak_torch import RATE
from khipu_tpu_torch.trie import fixpoint_cuda

MAX_DEPTH = 64  # DAG deeper than this falls back to the level loop
ADMIT_TILE = 1024  # rows per mirror tile (admit gathers come in whole tiles)

FUSED_GAUGES = REGISTRY.gauge_group("khipu_fused", {
    # fixpoints run (fused_submit calls that reached the device)
    "dispatches": 0,
    # shape of the last fixpoint: staged nodes and rounds (= DAG depth)
    "last_nodes": 0,
    "last_rounds": 0,
    # finalize(fused=True) windows that fell back to the level loop
    # because the DAG was deeper than MAX_DEPTH
    "unsupported_fallbacks": 0,
}, help="fused fixpoint state (khipu_tpu_torch/trie/fused.py)")


class FusedUnsupported(Exception):
    """Raised when the fused path cannot handle this window (the caller
    falls back to the per-level hasher loop)."""


def topo_levels(deps: Dict[bytes, List[bytes]]) -> List[List[bytes]]:
    """Topological levels of the dependency DAG, leaves first. Raises
    AssertionError on a cycle / unresolvable reference."""
    done: set = set()
    pending = dict(deps)
    levels: List[List[bytes]] = []
    while pending:
        level = [
            ph for ph, cs in pending.items()
            if all(c in done for c in cs)
        ]
        if not level:
            raise AssertionError("placeholder dependency cycle")
        for ph in level:
            done.add(ph)
            del pending[ph]
        levels.append(level)
    return levels


def _pow2(n: int, floor: int = 1) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _substitute_plain(enc, rows, offs, child, digests, ext, total_rows):
    """Plain version of K2: ``enc[row, off:off+32] = cat(G, ext)[child]``
    for every triple, in place."""
    gf = torch.cat([digests, ext], dim=0)
    cols = offs.long()[:, None] + torch.arange(32, device=enc.device)
    enc[rows.long()[:, None], cols] = gf[child.long()]


def substitute(enc, rows, offs, child, digests, ext, total_rows) -> None:
    """One class's substitution pass: K2 on the card, the plain version
    on the CPU."""
    if enc.is_cuda:
        fixpoint_cuda.substitute(
            enc, rows, offs, child, digests, ext, total_rows
        )
    elif enc.device.type == "cpu":
        _substitute_plain(enc, rows, offs, child, digests, ext, total_rows)
    else:
        raise ValueError(f"unsupported device {enc.device}")


class PackedClass:
    """One rate class of a packed window, on the device: ``enc``
    u8[nrows, nb*136] (real rows, then one spare filler row), the
    triples ``rows``/``offs``/``child`` i32[nsubs], and ``base``, the
    class's first row in the window's digest tensor."""

    __slots__ = ("nb", "keys", "base", "enc", "rows", "offs", "child",
                 "aidx", "admit_keys", "admit_lens")

    @property
    def nrows(self) -> int:
        return int(self.enc.shape[0])

    @property
    def nsubs(self) -> int:
        return int(self.rows.shape[0])


def pack(to_resolve, prefix, device, ext_pos=None, n_ext=0,
         admit_live=None) -> Tuple[List[PackedClass], Dict[bytes, int], int]:
    """Host pack + upload: bucket the encodings by rate class, pad them,
    scan each for the placeholder prefix and build the triples. Returns
    (classes, dpos: ph -> global row, total_rows)."""
    buckets: Dict[int, List[bytes]] = {}
    for ph in to_resolve:
        buckets.setdefault(len(to_resolve[ph]) // RATE + 1, []).append(ph)
    classes: List[PackedClass] = []
    dpos: Dict[bytes, int] = {}
    base = 0
    for nb in sorted(buckets):
        c = PackedClass()
        c.nb, c.keys, c.base = nb, buckets[nb], base
        for r, ph in enumerate(c.keys):
            dpos[ph] = base + r
        base += len(c.keys) + 1  # one spare filler row per class
        classes.append(c)
    total_rows = base
    ext_pos = ext_pos or {}

    for c in classes:
        width = c.nb * RATE
        npad = len(c.keys) + 1
        zero = bytes(width)
        parts: List[bytes] = []
        lens = np.zeros(npad, dtype=np.int64)
        subs: List[Tuple[int, int, int]] = []
        for r, ph in enumerate(c.keys):
            enc = to_resolve[ph]
            parts.append(enc)
            parts.append(zero[: width - len(enc)])
            lens[r] = len(enc)
            pos = enc.find(prefix)
            while pos >= 0:
                ref = enc[pos : pos + 32]
                cp = dpos.get(ref)
                if cp is None:
                    ep = ext_pos.get(ref)
                    if ep is not None:
                        if not 0 <= ep < n_ext:
                            raise ValueError(f"ext row {ep} outside [0, {n_ext})")
                        cp = total_rows + ep  # resolved-input tile row
                if cp is not None:
                    subs.append((r, pos, cp))
                pos = enc.find(prefix, pos + 32)
        parts.append(zero)  # the spare filler row
        buf = (
            np.frombuffer(b"".join(parts), dtype=np.uint8)
            .reshape(npad, width)
            .copy()
        )
        buf[np.arange(npad), lens] ^= 0x01  # multi-rate pad (a fixed
        buf[:, width - 1] ^= 0x80  # region: substitution never touches it)
        sub_np = np.asarray(subs, dtype=np.int32).reshape(-1, 3)
        c.enc = torch.from_numpy(buf).to(device)
        c.rows, c.offs, c.child = (
            torch.from_numpy(np.ascontiguousarray(sub_np[:, i])).to(device)
            for i in range(3)
        )
        c.aidx, c.admit_keys, c.admit_lens = None, None, None
        if admit_live:
            live = [r for r, ph in enumerate(c.keys) if ph in admit_live]
            if live:
                # whole mirror tiles; filler slots point at the spare row,
                # a valid padded filler whose digest is self-consistent
                nadmit = _pow2(-(-len(live) // ADMIT_TILE)) * ADMIT_TILE
                aidx = np.full(nadmit, npad - 1, dtype=np.int64)
                aidx[: len(live)] = live
                c.aidx = torch.from_numpy(aidx).to(device)
                pad = nadmit - len(live)
                c.admit_keys = [c.keys[r] for r in live] + [None] * pad
                c.admit_lens = [int(lens[r]) for r in live] + [0] * pad
    return classes, dpos, total_rows


def run_fixpoint(classes: List[PackedClass], total_rows: int,
                 ext: torch.Tensor, rounds: int, hash_rows=hash_padded,
                 scatter=substitute) -> torch.Tensor:
    """``rounds`` rounds of (hash every class, then substitute every
    class), in place into each class's ``enc``. Returns the digest
    tensor u8[total_rows, 32] of the last round: with rounds >= depth
    both it and the encodings are at the fixpoint.

    ``hash_rows(enc, out=)`` and ``scatter`` default to the dispatchers
    (K1 and K2 on the card); ``chip_smoke.py`` passes the plain versions
    to hold the kernels against them on the same device."""
    device = classes[0].enc.device
    digests = torch.empty((total_rows, 32), dtype=torch.uint8, device=device)
    for _ in range(rounds):
        for c in classes:
            hash_rows(c.enc, out=digests[c.base : c.base + c.nrows])
        for c in classes:
            if c.nsubs:
                scatter(c.enc, c.rows, c.offs, c.child, digests, ext,
                        total_rows)
    return digests


class FusedJob:
    """A fixpoint whose kernels have been enqueued on the device but
    whose digests have not been fetched. ``collect`` waits on the one
    device->host copy.

    ``digests`` stays referenced after collect so a later window can
    gather rows from it on the device (resolved-input tiles); ``dpos``
    maps each placeholder to its row for that gather. ``encs`` are the
    per-class FINAL substituted encodings, still on the device, in the
    class/row order of ``class_rows``. ``admit_tiles`` holds, per class
    with live rows, (nblocks, keys, enc u8[nadmit, width], claim
    u8[nadmit, 32], lengths) gathered from them."""

    __slots__ = ("digests", "encs", "class_rows", "dpos", "_mapping",
                 "admit_tiles", "_host", "_event")

    def __init__(self, digests, class_rows, dpos=None, encs=None,
                 admit_tiles=None):
        self.digests = digests  # device u8[total_rows, 32]
        self.encs = encs  # per-class device u8[nrows, nb*RATE]
        self.class_rows = class_rows  # [(phs in row order, global base)]
        self.dpos = dpos or {}  # ph -> global row (cross-window gather)
        self._mapping: Optional[Dict[bytes, bytes]] = None
        self.admit_tiles = admit_tiles
        self._host = None
        self._event = None
        if digests is not None:
            self._start_copy()

    def _start_copy(self) -> None:
        """Begin the device->host digest copy now, so ``collect`` only
        waits for it: a non-blocking copy into pinned memory, then an
        event that ``collect`` synchronizes on."""
        if self.digests.is_cuda:
            self._host = torch.empty(
                self.digests.shape, dtype=torch.uint8, pin_memory=True
            )
            self._host.copy_(self.digests, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = self.digests

    def fetch_rows(self, refs) -> Dict[bytes, bytes]:
        """Digests of ``refs`` only: a device row gather plus a 32 B x n
        host copy."""
        if self._mapping is not None:
            m = self._mapping
            return {r: m[r] for r in refs if r in m}
        out: Dict[bytes, bytes] = {}
        if self.digests is None:
            return out
        present = [r for r in refs if r in self.dpos]
        if not present:
            return out
        rows = torch.tensor(
            [self.dpos[r] for r in present], dtype=torch.long,
            device=self.digests.device,
        )
        with _span("fused.rootcheck"):
            blob = self.digests.index_select(0, rows).cpu().numpy().tobytes()
        for i, r in enumerate(present):
            out[r] = blob[32 * i : 32 * i + 32]
        return out

    def release_encs(self) -> None:
        """Drop the final-encoding tensors (the admit tiles are separate
        tensors and stay)."""
        self.encs = None

    def release(self) -> None:
        """Drop every device reference once the window has retired."""
        self.encs = None
        self.digests = None
        self.admit_tiles = None

    def collect(self) -> Dict[bytes, bytes]:
        if self._mapping is not None:
            return self._mapping
        if self._host is None:
            return {}
        with _span("fused.collect"):
            if self._event is not None:
                self._event.synchronize()
            blob = self._host.numpy().tobytes()
            out: Dict[bytes, bytes] = {}
            for rows, base in self.class_rows:
                o = base * 32
                out.update(
                    zip(
                        rows,
                        (blob[o + 32 * r : o + 32 * r + 32]
                         for r in range(len(rows))),
                    )
                )
        self._mapping = out
        self._host = None
        self._event = None
        return out


def fused_resolve(
    to_resolve: Dict[bytes, bytes],
    deps: Dict[bytes, List[bytes]],
    prefix: bytes,
    device=None,
    depth: int = None,
) -> Dict[bytes, bytes]:
    return fused_submit(to_resolve, deps, prefix, device, depth).collect()


def fused_submit(
    to_resolve: Dict[bytes, bytes],
    deps: Dict[bytes, List[bytes]],
    prefix: bytes,
    device=None,
    depth: int = None,
    ext=None,
    admit_live=None,
) -> FusedJob:
    """Pack, upload and enqueue the fixpoint that resolves placeholder ->
    real Keccak-256 hash for every entry of ``to_resolve`` (placeholder
    -> raw encoding); returns without waiting for the device.

    ``deps`` is the child map (restricted to session placeholders);
    ``prefix`` is the session's placeholder prefix for the offset scan.
    Callers that know the DAG depth pass ``depth`` to skip the
    topological scan. ``rounds = depth``: the least that resolves the
    DAG (the JAX package rounds it up to a power of two, at least 4, for
    its compile cache; any rounds >= depth gives the same real rows).

    ``ext``: optional ``(digests, pos)`` resolved-input tile — a device
    u8[n, 32] tensor of FINAL digests from earlier windows and a
    ``ph -> row`` map. Encodings that embed those placeholders get them
    substituted on the device from the tile.

    ``admit_live``: optional set of placeholders whose FINAL encodings
    and digests the caller wants gathered into whole mirror tiles
    (``FusedJob.admit_tiles``).
    """
    dev = resolve_device(device)
    with _span("fused.dispatch"):
        return _fused_submit(
            to_resolve, deps, prefix, dev, depth, ext, admit_live
        )


def _fused_submit(to_resolve, deps, prefix, dev, depth, ext,
                  admit_live) -> FusedJob:
    if not to_resolve:
        return FusedJob(None, [])
    if depth is None:
        depth = len(topo_levels(deps))
    if depth > MAX_DEPTH:
        raise FusedUnsupported(f"DAG depth {depth} > {MAX_DEPTH}")
    if ext is not None:
        ext_dev, ext_pos = ext
        if ext_dev.device != dev or ext_dev.dtype != torch.uint8:
            raise ValueError("ext must be a u8[n, 32] tensor on the device")
    else:
        ext_dev = torch.zeros((0, 32), dtype=torch.uint8, device=dev)
        ext_pos = {}

    with _span("seal.dispatch_build"):
        classes, dpos, total_rows = pack(
            to_resolve, prefix, dev, ext_pos, int(ext_dev.shape[0]),
            admit_live,
        )
    rounds = max(1, depth)
    with _span("seal.upload"):
        digests = run_fixpoint(classes, total_rows, ext_dev, rounds)
    FUSED_GAUGES["dispatches"] += 1
    FUSED_GAUGES["last_nodes"] = len(to_resolve)
    FUSED_GAUGES["last_rounds"] = rounds

    admit_tiles = None
    if admit_live:
        admit_tiles = []
        for c in classes:
            if c.aidx is None:
                continue
            enc_g = c.enc.index_select(0, c.aidx)
            claim_g = digests.index_select(0, c.aidx + c.base)
            admit_tiles.append(
                (c.nb, c.admit_keys, enc_g, claim_g, c.admit_lens)
            )
    return FusedJob(
        digests,
        [(c.keys, c.base) for c in classes],
        dpos,
        encs=[c.enc for c in classes],
        admit_tiles=admit_tiles,
    )
