"""Fused window finalize: the whole placeholder DAG in one kernel.

The level-synchronous finalize (deferred.finalize) issues one batched
hash call per trie level. This module resolves every staged node of a
window (or of a bulk build) in one device program instead:

  1. The host packs every staged node's raw encoding (multi-rate padded)
     into per-rate-class u8 tensors and scans each encoding once for
     its placeholder spans -> substitution triples
     (parent_row, byte_offset, child_index), grouped by parent.
  2. From the triples alone (vectorised numpy) it derives each row's
     level: 0 for a row with no in-window child, else 1 + the largest
     level of its in-window children; and the rows in (level, class)
     order.
  3. Level by level, on the device, each row is substituted
     (``enc[row, off:off+32] = digest of child``, the child from this
     window's digests or from the resolved-input tile ``ext``) and
     hashed into ``digests[row]``. Every row is hashed once.

Substitution is length-invariant (a placeholder is exactly 32 bytes,
replaced by a 32-byte hash; RLP headers never change), so byte offsets
recorded from the RAW encodings are the offsets in the final ones.

On the card step 3 is kernel K5 (``fixpoint_cuda.resolve_levels``), one
launch for all levels; on the CPU it is ``resolve_levels_plain``. The
JAX package instead runs ``depth`` rounds of (hash every row,
substitute every triple) and pads rows and triples to compile-friendly
buckets (1024-row tiles, pow-2 counts); the port compiles nothing per
shape, so a class holds its real rows plus one spare filler row, and
only real triples.

The module also holds the execute stage's device hook,
``fused_exec_validate``: the scheduled executor's batch row validation,
kernel K6 on the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability.profiler import D2H, H2D, HOST, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import span as _span
from khipu_tpu_torch.ops import keccak_torch
from khipu_tpu_torch.ops.keccak_torch import RATE
from khipu_tpu_torch.trie import exec_validate_cuda, fixpoint_cuda

ADMIT_TILE = 1024  # rows per mirror tile (admit gathers come in whole tiles)

FUSED_GAUGES = REGISTRY.gauge_group("khipu_fused", {
    # fixpoints run (fused_submit calls that reached the device)
    "dispatches": 0,
    # shape of the last fixpoint: staged nodes and levels (= DAG depth)
    "last_nodes": 0,
    "last_levels": 0,
}, help="fused fixpoint state (khipu_tpu_torch/trie/fused.py)")


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


class PackedClass:
    """One rate class of a packed window: ``enc`` u8[nrows, nb*136]
    (real rows, then one spare filler row; numpy after ``pack_host``, a
    device tensor after ``upload_packed``) and ``base``, the class's
    first row in the window's digest tensor."""

    __slots__ = ("nb", "keys", "base", "enc", "aidx", "admit_keys",
                 "admit_lens")

    @property
    def nrows(self) -> int:
        return int(self.enc.shape[0])


class LevelPlan:
    """The level order of a packed window.

    Host (numpy): ``level`` i32[total_rows], each row's height;
    ``level_ptr`` i64[L + 1], level l's slice of ``order``; ``order``
    i32[total_rows], the rows sorted by (level, row), so by class inside
    a level; ``tptr`` i64[total_rows + 1], row r's triples are
    ``[tptr[r], tptr[r + 1])``.
    Device (i32 tensors): ``d_order``, ``d_level_ptr``, ``d_tptr`` and
    the triples' byte offsets ``d_toff`` and children ``d_tchild``
    (a child at or past total_rows is row ``child - total_rows`` of the
    resolved-input tile)."""

    __slots__ = ("level", "level_ptr", "order", "tptr", "toff", "tchild",
                 "d_order", "d_level_ptr", "d_tptr", "d_toff", "d_tchild")

    @property
    def nlevels(self) -> int:
        return len(self.level_ptr) - 1

    @property
    def ntriples(self) -> int:
        return int(self.tptr[-1])

    @property
    def widest(self) -> int:
        """Rows in the largest level."""
        return int(np.diff(self.level_ptr).max())


def level_plan(parent: np.ndarray, toff: np.ndarray, tchild: np.ndarray,
               total_rows: int, device=None) -> LevelPlan:
    """Levels, order and the CSR of the triples ``(parent, toff,
    tchild)``, which must be sorted by parent. Vectorised: each pass of
    ``np.maximum.reduceat`` over the parent-sorted triples raises every
    row to 1 + its children's levels, and the levels stop changing after
    depth + 1 passes. Raises AssertionError on a cycle. The device
    tensors are uploaded to ``device`` (``upload_packed`` does it later
    when ``device`` is None)."""
    parent = np.asarray(parent, dtype=np.int64)
    tchild = np.asarray(tchild, dtype=np.int64)
    if len(parent) and np.any(np.diff(parent) < 0):
        raise ValueError("triples must be sorted by parent")
    if max(total_rows, len(parent)) >= 1 << 31:
        raise ValueError("a window holds fewer than 2**31 rows and triples")
    counts = np.bincount(parent, minlength=total_rows)
    tptr = np.zeros(total_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=tptr[1:])
    level = np.zeros(total_rows, dtype=np.int64)
    inner = tchild < total_rows  # ext children are final from the start
    if inner.any():
        p_in, c_in = parent[inner], tchild[inner]
        heads, starts = np.unique(p_in, return_index=True)
        while True:
            raised = np.maximum.reduceat(level[c_in], starts) + 1
            if np.array_equal(raised, level[heads]):
                break
            level[heads] = raised
            if raised.max() >= total_rows:
                raise AssertionError("placeholder dependency cycle")
    order = np.argsort(level, kind="stable").astype(np.int32)
    level_ptr = np.zeros(int(level.max()) + 2, dtype=np.int64)
    np.cumsum(np.bincount(level), out=level_ptr[1:])

    plan = LevelPlan()
    plan.level, plan.level_ptr, plan.order, plan.tptr = (
        level.astype(np.int32), level_ptr, order, tptr
    )
    plan.toff = np.asarray(toff, dtype=np.int32)
    plan.tchild = tchild.astype(np.int32)
    plan.d_order = plan.d_level_ptr = plan.d_tptr = None
    plan.d_toff = plan.d_tchild = None
    if device is not None:
        upload_packed([], plan, device)
    return plan


def _plan_arrays(plan: LevelPlan) -> List[np.ndarray]:
    """The host arrays behind the plan's device tensors, as int32."""
    return [np.ascontiguousarray(a, np.int32) for a in (
        plan.order, plan.level_ptr, plan.tptr, plan.toff, plan.tchild)]


def packed_nbytes(classes: List[PackedClass], plan: LevelPlan) -> int:
    """Bytes of the host buffers ``upload_packed`` sends to the device:
    every class's padded encodings and admit rows, and the level plan's
    five int32 arrays."""
    n = sum(c.enc.nbytes for c in classes)
    n += sum(c.aidx.nbytes for c in classes if c.aidx is not None)
    return n + sum(a.nbytes for a in _plan_arrays(plan))


def upload_packed(classes: List[PackedClass], plan: LevelPlan,
                  device) -> None:
    """Move a host pack to ``device`` in place: each class's ``enc``
    and ``aidx`` become tensors there, and the plan gets its ``d_*``
    tensors."""
    for c in classes:
        c.enc = torch.from_numpy(c.enc).to(device)
        if c.aidx is not None:
            c.aidx = torch.from_numpy(c.aidx).to(device)
    plan.d_order, plan.d_level_ptr, plan.d_tptr, plan.d_toff, plan.d_tchild = (
        torch.from_numpy(a).to(device) for a in _plan_arrays(plan)
    )


def pack(to_resolve, prefix, device, ext_pos=None, n_ext=0,
         admit_live=None
         ) -> Tuple[List[PackedClass], Dict[bytes, int], int, LevelPlan]:
    """Host pack + upload: ``pack_host``, then ``upload_packed`` to
    ``device``. Returns (classes, dpos: ph -> global row, total_rows,
    plan)."""
    classes, dpos, total_rows, plan = pack_host(
        to_resolve, prefix, ext_pos, n_ext, admit_live
    )
    upload_packed(classes, plan, device)
    return classes, dpos, total_rows, plan


def pack_host(to_resolve, prefix, ext_pos=None, n_ext=0, admit_live=None
              ) -> Tuple[List[PackedClass], Dict[bytes, int], int, LevelPlan]:
    """Host pack: bucket the encodings by rate class, pad them, scan
    each for the placeholder prefix and build the triples and their
    level plan, all in host memory (numpy; ``upload_packed`` moves them).
    Returns (classes, dpos: ph -> global row, total_rows, plan).
    ``ext_pos`` maps a placeholder outside ``to_resolve`` to its row of
    the resolved-input tile, which holds ``n_ext`` rows; an ``ExtRows``
    assigns the rows as the scan meets the refs (pass ``n_ext=None``)."""
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
    if ext_pos is None:
        ext_pos = {}

    # (global parent row, offset, child), in row order: sorted by parent
    subs: List[Tuple[int, int, int]] = []
    for c in classes:
        width = c.nb * RATE
        npad = len(c.keys) + 1
        zero = bytes(width)
        parts: List[bytes] = []
        lens = np.zeros(npad, dtype=np.int64)
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
                        if ep < 0 or (n_ext is not None and ep >= n_ext):
                            raise ValueError(f"ext row {ep} outside [0, {n_ext})")
                        cp = total_rows + ep  # resolved-input tile row
                if cp is not None:
                    subs.append((c.base + r, pos, cp))
                pos = enc.find(prefix, pos + 32)
        parts.append(zero)  # the spare filler row
        buf = (
            np.frombuffer(b"".join(parts), dtype=np.uint8)
            .reshape(npad, width)
            .copy()
        )
        buf[np.arange(npad), lens] ^= 0x01  # multi-rate pad (a fixed
        buf[:, width - 1] ^= 0x80  # region: substitution never touches it)
        c.enc = buf
        c.aidx, c.admit_keys, c.admit_lens = None, None, None
        if admit_live:
            live = [r for r, ph in enumerate(c.keys) if ph in admit_live]
            if live:
                # whole mirror tiles; filler slots point at the spare row,
                # a valid padded filler whose digest is self-consistent
                nadmit = _pow2(-(-len(live) // ADMIT_TILE)) * ADMIT_TILE
                aidx = np.full(nadmit, npad - 1, dtype=np.int64)
                aidx[: len(live)] = live
                c.aidx = aidx
                pad = nadmit - len(live)
                c.admit_keys = [c.keys[r] for r in live] + [None] * pad
                c.admit_lens = [int(lens[r]) for r in live] + [0] * pad
    sub_np = np.asarray(subs, dtype=np.int64).reshape(-1, 3)
    plan = level_plan(sub_np[:, 0], sub_np[:, 1], sub_np[:, 2], total_rows)
    return classes, dpos, total_rows, plan


def resolve_levels_plain(classes: List[PackedClass], total_rows: int,
                         ext: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """Plain version of K5: for each level, for each class present in
    it, write ``cat(digests, ext)[child]`` into ``enc[row, off:off+32]``
    for the level's triples, then hash those rows into ``digests``.
    In place into each class's ``enc``; returns the digest tensor
    u8[total_rows, 32]. Each row is hashed once."""
    device = classes[0].enc.device
    digests = torch.empty((total_rows, 32), dtype=torch.uint8, device=device)
    for lvl in range(plan.nlevels):
        _resolve_rows_plain(classes, total_rows, ext, plan, digests,
                            plan.level_ptr[lvl], plan.level_ptr[lvl + 1])
    return digests


def _resolve_rows_plain(classes, total_rows, ext, plan, digests, lo, hi):
    """The plain version's work on rows ``order[lo:hi]``, all of one
    level: substitute their triples from ``cat(digests, ext)``, then
    hash them into ``digests``."""
    device = digests.device
    rows_l = plan.order[lo:hi]
    src = torch.cat([digests, ext], dim=0)
    bounds = [c.base for c in classes] + [total_rows]
    span32 = torch.arange(32, device=device)
    cuts = np.searchsorted(rows_l, bounds)
    for c, a, b in zip(classes, cuts[:-1], cuts[1:]):
        if a == b:
            continue
        rows = rows_l[a:b].astype(np.int64)
        starts = plan.tptr[rows]
        counts = plan.tptr[rows + 1] - starts
        # CSR expansion: the indices of every triple of these rows
        first = np.repeat(starts - np.cumsum(counts) + counts, counts)
        tidx = first + np.arange(int(counts.sum()))
        local = torch.from_numpy(rows - c.base).to(device)
        if len(tidx):
            parents = torch.from_numpy(
                np.repeat(rows - c.base, counts)).to(device)
            cols = torch.from_numpy(
                plan.toff[tidx].astype(np.int64)).to(device)
            child = torch.from_numpy(
                plan.tchild[tidx].astype(np.int64)).to(device)
            c.enc[parents[:, None], cols[:, None] + span32] = src[child]
        digests[torch.from_numpy(rows).to(device)] = (
            keccak_torch.absorb_padded(c.enc[local])
        )


def resolve_level_rows(classes: List[PackedClass], total_rows: int,
                       ext: torch.Tensor, plan: LevelPlan,
                       digests: torch.Tensor, lo: int, hi: int,
                       d_bounds: Optional[torch.Tensor] = None) -> None:
    """In place: rows ``order[lo:hi]``, which lie in one level, each
    substituted from ``digests`` (their children's rows must hold their
    final digests) and the resolved-input tile ``ext``, then hashed into
    ``digests``. On the card one K5 launch over a one-level plan
    ``level_ptr = [lo, hi]`` (``d_bounds``, that pair as an int32 tensor
    on the card, saves its upload); on the CPU the plain version's work
    on those rows. The sharded fixpoint (parallel/fused_sharded.py) runs
    a level's rows this way, a share on each rank."""
    if hi <= lo:
        return
    device = digests.device
    if device.type == "cpu":
        _resolve_rows_plain(classes, total_rows, ext, plan, digests, lo, hi)
        return
    if d_bounds is None:
        # khipu-lint: ok KL001 the one-level bounds (8 B) when the caller
        # passes none; the sharded fixpoint uploads every level's under
        # shard.dispatch
        d_bounds = torch.tensor([lo, hi], dtype=torch.int32).to(device)
    fixpoint_cuda.resolve_levels(
        [c.enc for c in classes], [c.base for c in classes], digests, ext,
        plan.d_order, d_bounds, plan.d_tptr, plan.d_toff, plan.d_tchild,
        hi - lo,
    )


def resolve_levels(classes: List[PackedClass], total_rows: int,
                   ext: torch.Tensor, plan: LevelPlan) -> torch.Tensor:
    """Resolve a packed window: K5 on the card (one launch), the plain
    version on the CPU. Returns the digests u8[total_rows, 32]; the final
    encodings are in each class's ``enc``."""
    device = classes[0].enc.device
    if device.type == "cpu":
        return resolve_levels_plain(classes, total_rows, ext, plan)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    digests = torch.empty((total_rows, 32), dtype=torch.uint8, device=device)
    fixpoint_cuda.resolve_levels(
        [c.enc for c in classes], [c.base for c in classes], digests, ext,
        plan.d_order, plan.d_level_ptr, plan.d_tptr, plan.d_toff,
        plan.d_tchild, plan.widest,
    )
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
            # khipu-lint: ok KL001 the digests' copy back begins here and is
            # metered by collect() (fused.collect), where the host waits for it
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
        # khipu-lint: ok KL001 the gather's row indices, 8 B a ref: the
        # JAX package meters the digests back only (seal.rootcheck), and
        # the two packages' ledgers are held equal site by site
        rows = torch.tensor(
            [self.dpos[r] for r in present], dtype=torch.long,
            device=self.digests.device,
        )
        sub = self.digests.index_select(0, rows)  # gathered on the device
        with _span("fused.rootcheck", rows=len(present)):
            with LEDGER.transfer("seal.rootcheck", D2H,
                                 sub.numel() * sub.element_size()):
                blob = sub.cpu().numpy().tobytes()
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
        fault_point("fused.collect")
        host = self._host
        with _span("fused.collect", rows=int(host.shape[0])):
            # the copy back began at launch (_start_copy); the wait is
            # the crossing the movement ledger classifies
            with LEDGER.transfer("fused.collect", D2H,
                                 host.numel() * host.element_size()):
                if self._event is not None:
                    self._event.synchronize()
            blob = host.numpy().tobytes()
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


class ExtRows:
    """The resolved-input tile of a launch whose refs out of the window
    are found by ``pack``'s scan: ``get(ref)`` gives ``ref`` the next
    tile row the first time ``lookup(ref)`` knows its digest, either as
    32 bytes on the host or as ``(digests tensor, row)`` of an earlier
    launch still on the device; None leaves the ref unsubstituted.
    ``tile(device)`` then builds u8[n, 32] in row order: device rows by
    ``index_select`` card to card, host digests by one upload."""

    __slots__ = ("lookup", "pos", "src", "span_tags")

    def __init__(self, lookup, span_tags: Optional[dict] = None):
        self.lookup = lookup
        self.pos: Dict[bytes, int] = {}
        self.src: list = []
        # extra tags of the seal.alias_gather span (a window's range)
        self.span_tags = span_tags or {}

    def get(self, ref: bytes) -> Optional[int]:
        row = self.pos.get(ref)
        if row is None:
            src = self.lookup(ref)
            if src is None:
                return None
            row = self.pos[ref] = len(self.src)
            self.src.append(src)
        return row

    def tile(self, device) -> torch.Tensor:
        out = torch.empty((len(self.src), 32), dtype=torch.uint8,
                          device=device)
        host_rows: List[int] = []
        host_digests: List[bytes] = []
        groups: Dict[int, Tuple[torch.Tensor, List[int], List[int]]] = {}
        for i, src in enumerate(self.src):
            if isinstance(src, bytes):
                host_rows.append(i)
                host_digests.append(src)
            else:
                digests, row = src
                g = groups.setdefault(id(digests), (digests, [], []))
                g[1].append(i)
                g[2].append(row)

        def idx(rows):
            # khipu-lint: ok KL001 called only inside tile()'s
            # seal.alias_gather transfer, whose bytes count these indices
            return torch.tensor(rows, dtype=torch.long, device=device)

        # only the row indices and the host digests cross to the device;
        # the in-flight rows are gathered card to card
        nbytes = 8 * (len(self.src) + sum(len(g[2]) for g in
                                          groups.values()))
        nbytes += 32 * len(host_rows)
        with _span("seal.alias_gather", refs=len(self.src),
                   **self.span_tags), \
                LEDGER.transfer("seal.alias_gather", H2D, nbytes):
            for digests, rows, src_rows in groups.values():
                out.index_copy_(0, idx(rows),
                                digests.index_select(0, idx(src_rows)))
            if host_rows:
                blob = np.frombuffer(bytearray(b"".join(host_digests)),
                                     np.uint8)
                out.index_copy_(0, idx(host_rows),
                                torch.from_numpy(blob.reshape(-1, 32))
                                .to(device))
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
    span_tags: Optional[dict] = None,
) -> FusedJob:
    """Pack, upload and enqueue the fixpoint that resolves placeholder ->
    real Keccak-256 hash for every entry of ``to_resolve`` (placeholder
    -> raw encoding); returns without waiting for the device.

    ``prefix`` is the session's placeholder prefix for the offset scan;
    the DAG and its levels come from the triples that scan finds, so
    ``deps`` (the child map the JAX package's fixpoint takes) is not
    read. ``depth``, when a caller knows it, must be at least the number
    of levels found: a smaller one raises ValueError. No depth is
    compiled in: K5 walks every level in one launch.

    ``ext``: optional resolved-input tile — a ``(digests, pos)`` pair of
    a device u8[n, 32] tensor of FINAL digests from earlier windows and
    a ``ph -> row`` map, or an ``ExtRows`` that the scan fills and that
    is gathered after it. Encodings that embed those placeholders get
    them substituted on the device from the tile.

    ``admit_live``: optional set of placeholders whose FINAL encodings
    and digests the caller wants gathered into whole mirror tiles
    (``FusedJob.admit_tiles``).

    ``span_tags``: extra tags of this dispatch's spans — the window
    committer passes its window's ``block_lo`` / ``block_hi``, so
    ``fused.dispatch`` joins each block's lifecycle record and the seal
    sub-phases join the window's cost rows (the JAX package's carry no
    block range).
    """
    dev = resolve_device(device)
    # chaos seam: a ``raise`` here models a runtime dispatch failure,
    # which stops the windowed replay (the port hashes no window on the
    # host after a device error; the JAX package degrades that window)
    fault_point("fused.dispatch")
    with _span(
        "fused.dispatch",
        nodes=len(to_resolve),
        admit=len(admit_live) if admit_live else 0,
        **(span_tags or {}),
    ):
        return _fused_submit(
            to_resolve, prefix, dev, depth, ext, admit_live, span_tags or {}
        )


def _fused_submit(to_resolve, prefix, dev, depth, ext,
                  admit_live, tags) -> FusedJob:
    if not to_resolve:
        return FusedJob(None, [])
    ext_dev = None
    if isinstance(ext, ExtRows):
        ext_pos, n_ext = ext, None
    elif ext is not None:
        ext_dev, ext_pos = ext
        if ext_dev.device != dev or ext_dev.dtype != torch.uint8:
            raise ValueError("ext must be a u8[n, 32] tensor on the device")
        n_ext = int(ext_dev.shape[0])
    else:
        ext_pos, n_ext = {}, 0

    build_t0 = time.perf_counter() if LEDGER.enabled else 0.0
    with _span("seal.dispatch_build", nodes=len(to_resolve), **tags):
        classes, dpos, total_rows, plan = pack_host(
            to_resolve, prefix, ext_pos, n_ext, admit_live,
        )
        # host->device upload = every host-built input buffer; the
        # resolved-input tile is gathered card to card and its few host
        # rows are billed to seal.alias_gather (ExtRows.tile)
        up = packed_nbytes(classes, plan)
    if LEDGER.enabled:
        # host-side classification event: bytes of the input buffers the
        # build step packed, with its wall duration
        LEDGER.record("seal.dispatch_build", HOST, up,
                      duration=time.perf_counter() - build_t0)
    if depth is not None and depth < plan.nlevels:
        raise ValueError(f"depth {depth} < the DAG's {plan.nlevels} levels")
    if ext_dev is None:
        ext_dev = (ext.tile(dev) if ext is not None else
                   torch.zeros((0, 32), dtype=torch.uint8, device=dev))
    # the upload from pageable host memory and K5's launch: the span and
    # the crossing time the enqueue, not the device's work
    with _span("seal.upload", nbytes=up, **tags):
        with LEDGER.transfer("seal.upload", H2D, up):
            upload_packed(classes, plan, dev)
            digests = resolve_levels(classes, total_rows, ext_dev, plan)
    FUSED_GAUGES["dispatches"] += 1
    FUSED_GAUGES["last_nodes"] = len(to_resolve)
    FUSED_GAUGES["last_levels"] = plan.nlevels

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


# ------------------------------------------- execute-stage device hook
#
# The gathered account rows of the scheduled executor's fast-path and
# trusted-call batches (ledger/batch_exec.py, batch_call.py) validate in
# one device pass: the transaction's nonce must equal the account's, and
# the balance must cover the upfront cost. The rows are the host pass's
# 256-bit big-endian limbs as u32 words, packed one row of 20 words a
# transaction, so a batch is one upload. On the card the pass is kernel
# K6 (exec_validate_cuda.validate_rows), on the CPU exec_validate_plain.
# The JAX package pads rows to a power of two for its compile cache; the
# port compiles nothing per shape and sends the real rows only. Only
# reachable with sync.exec_device (adaptive.exec_device_allowed).


def pack_exec_rows(tx_nonces, acct_nonces, balances,
                   upfronts) -> np.ndarray:
    """uint32[n, 20] rows: the transaction's nonce and the account's
    (2 big-endian words each), then the balance and the upfront cost (8
    big-endian limbs each). Nonces must fit in 64 bits and the amounts
    in 256 (OverflowError otherwise)."""
    raw = b"".join(
        t.to_bytes(8, "big") + a.to_bytes(8, "big")
        + b.to_bytes(32, "big") + u.to_bytes(32, "big")
        for t, a, b, u in zip(tx_nonces, acct_nonces, balances, upfronts)
    )
    return (np.frombuffer(raw, dtype=">u4").astype(np.uint32)
            .reshape(-1, exec_validate_cuda.ROW_WORDS))


def exec_validate_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of K6 on ``rows`` (int32[n, 20], the u32 words
    of ``pack_exec_rows``) on any device: u8[n], 1 where the row is
    valid. The limbs are held in int64, where torch on the CPU lacks
    unsigned compares."""
    w = rows.to(torch.int64) & 0xFFFFFFFF
    nonce_ok = (w[:, 0:2] == w[:, 2:4]).all(dim=1)
    bal, up = w[:, 4:12], w[:, 12:20]
    neq = bal != up
    has_diff = neq.any(dim=1)
    # torch.argmax gives the first of equal maxima: the first limb that
    # differs decides, all-equal passes
    first = torch.argmax(neq.to(torch.int8), dim=1, keepdim=True)
    first_gt = torch.gather(bal > up, 1, first)[:, 0]
    balance_ok = torch.where(has_diff, first_gt, torch.ones_like(first_gt))
    return (nonce_ok & balance_ok).to(torch.uint8)


def fused_exec_validate(tx_nonces, acct_nonces, balances, upfronts,
                        device=None) -> np.ndarray:
    """Validate one gathered batch of account rows on ``device``
    (``None`` means the card): a bool mask, True where the nonce matches
    and the balance covers the upfront cost — the host pass of
    ``ledger/batch_exec.gather_validate_rows``. K6 on the card, the plain
    version on the CPU; an error on the card propagates."""
    dev = resolve_device(device)
    rows = torch.from_numpy(
        pack_exec_rows(tx_nonces, acct_nonces, balances, upfronts)
        .view(np.int32)
    )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    # the crossings are metered on either device (on the CPU the copies
    # are no-ops), so the ledger reads alike wherever the replay runs
    with LEDGER.transfer("exec.batch_device", H2D,
                         rows.numel() * rows.element_size()):
        rows_d = rows.to(dev)
    if dev.type == "cpu":
        mask = exec_validate_plain(rows_d)
    else:
        mask = exec_validate_cuda.validate_rows(rows_d)
    with LEDGER.transfer("exec.batch_device", D2H,
                         mask.numel() * mask.element_size()):
        ok = mask.cpu()
    return ok.numpy().astype(bool)
