"""Device-resident word-major node mirror: the hot-read store's card
half.

The port's counterpart of ``khipu_tpu.storage.device_mirror``. It keeps
admitted trie nodes on the card in the sponge kernels' native layout,
with their claimed content addresses beside them, so that

  * :meth:`DeviceNodeMirror.verify` re-hashes every resident node and
    counts content-address mismatches (the fast-sync snapshot verify,
    BASELINE config #5) in ONE launch of kernel K4 per size class;
  * nodes committed on the card can be read back (``get``,
    ``spill_rows``) before the host store holds them.

Layout (the port's own, not the TPU's tiles): a class keeps
``resident`` as int32 words ``[nwords, capacity_rows]`` and ``claimed``
as ``[8, capacity_rows]``, word-major across the whole class — the JAX
package's ``[tiles, nwords, 8, 128]`` with the TPU tile flattened. One
thread per row in K3/K4 then reads word w of 32 neighbouring rows from
128 consecutive bytes. The bits live in int32, a dtype torch's CPU
build copies and transposes, so the plain versions run on the CPU.
``TILE = 1024`` stays as the unit of admit and of the ring; it is the
contract of ``admit_packed`` and ``admit_device``, not a kernel tile.

Capacity is fixed per size class at construction; the ring overwrites
the oldest tile. Unfilled rows hold a synthetic filler row whose claimed
digest is its own, so verify needs no mask. The JAX package's donated
jit installs (``set_tile``, ``admit_device``) are in-place ``copy_``s of
a transposed view into ``resident[:, tile]`` here.

On a CUDA mirror K3 and K4 (``mirror_cuda``) run; on a CPU mirror the
plain versions below. The choice follows the buffers' device only.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability.profiler import D2H, H2D, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import span as _span
from khipu_tpu_torch.ops import keccak_torch
from khipu_tpu_torch.ops.keccak_torch import RATE
from khipu_tpu_torch.storage import mirror_cuda

TILE = 8 * 128  # rows per admit unit and ring step

MIRROR_GAUGES = REGISTRY.gauge_group("khipu_mirror", {
    # ring evictions that overwrote a window row BEFORE the persist
    # stage spilled it to the host store (a sizing signal: nonzero means
    # the mirror is too small for the pipeline depth)
    "unspilled_evictions": 0,
    # whole resident tiles fetched by the bulk spill read-back
    "spilled_tiles": 0,
}, help="device-mirror spill watermark state (storage/device_mirror.py)")


# ------------------------------------------------------------ kernels


def _rows_of(planes: torch.Tensor) -> torch.Tensor:
    """Word-major int32[nwords, n] -> row-major u8[n, nwords * 4] (a
    fresh tensor with plain strides, even where n == 1)."""
    nwords, n = planes.shape
    rows = torch.empty((n, nwords), dtype=torch.int32, device=planes.device)
    return rows.copy_(planes.t()).view(torch.uint8)


def hash_planes_plain(planes: torch.Tensor, nblocks: int,
                      exact_len: Optional[int]) -> torch.Tensor:
    """Plain version of K3: int32[nwords, n] -> digests int32[8, n]."""
    rows = _rows_of(planes)
    if exact_len:
        digests = keccak_torch.absorb_fixed(rows)
    else:
        digests = keccak_torch.absorb_padded(rows)
    return digests.view(torch.int32).t()


def verify_planes_plain(planes: torch.Tensor, claimed: torch.Tensor,
                        nblocks: int, exact_len: Optional[int]) -> int:
    """Plain version of K4: rows whose digest differs from ``claimed``."""
    digests = hash_planes_plain(planes, nblocks, exact_len)
    return int((digests != claimed).any(dim=0).sum())


def _nwords_in(nblocks: int, exact_len: Optional[int]) -> int:
    return (exact_len if exact_len else nblocks * RATE) // 4


def hash_planes(planes: torch.Tensor, nblocks: int, exact_len: Optional[int],
                out: torch.Tensor) -> torch.Tensor:
    """Digests of a class's word-major rows into ``out`` int32[8, n]: K3
    on the card, the plain version on the CPU."""
    if planes.is_cuda:
        return mirror_cuda.hash_planes(
            planes, nblocks, _nwords_in(nblocks, exact_len), out
        )
    if planes.device.type != "cpu":
        raise ValueError(f"unsupported device {planes.device}")
    out.copy_(hash_planes_plain(planes, nblocks, exact_len))
    return out


def verify_planes(planes: torch.Tensor, claimed: torch.Tensor, nblocks: int,
                  exact_len: Optional[int]) -> int:
    """Content-address mismatches of a class: K4 on the card, the plain
    version on the CPU."""
    if planes.is_cuda:
        count = mirror_cuda.verify_planes(
            planes, claimed, nblocks, _nwords_in(nblocks, exact_len)
        )
        with LEDGER.transfer("mirror.verify", D2H,
                             count.numel() * count.element_size()):
            return int(count.item())
    if planes.device.type != "cpu":
        raise ValueError(f"unsupported device {planes.device}")
    with LEDGER.transfer("mirror.verify", D2H, 4):
        return verify_planes_plain(planes, claimed, nblocks, exact_len)


def _filler_row_u8_for(width: int, exact_len: Optional[int]) -> np.ndarray:
    filler = np.zeros(width, dtype=np.uint8)
    if exact_len is None:
        filler[0] ^= 0x01
        filler[-1] ^= 0x80
    return filler


@lru_cache(maxsize=None)
def _filler_for(nblocks: int, exact_len: Optional[int],
                device: torch.device) -> Tuple[bytes, bytes]:
    """(filler row words, filler digest words) as raw bytes — the
    synthetic padding row and its self-consistent digest, hashed once
    per class per process and device (K3 on the card)."""
    width = exact_len if exact_len else nblocks * RATE
    words = torch.from_numpy(
        _filler_row_u8_for(width, exact_len).view("<i4").copy()
    )
    # amortized one-time cost: billed to its own phase so the lazy
    # first-admit build never pollutes a steady-state stage's totals
    with LEDGER.context(phase="init"):
        LEDGER.record("mirror.init", H2D, words.numel() * 4)
        planes = words.to(device)[:, None]
        digest = torch.empty((8, 1), dtype=torch.int32, device=device)
        hash_planes(planes, nblocks, exact_len, digest)
        with LEDGER.transfer("mirror.init", D2H, 32):
            digest_b = digest.cpu().numpy().tobytes()
    return words.numpy().tobytes(), digest_b


def _claim_words(hashes: List[bytes], device) -> torch.Tensor:
    """Claimed digests as word-major int32[8, len(hashes)] on ``device``."""
    arr = np.frombuffer(b"".join(hashes), dtype="<i4").reshape(len(hashes), 8)
    # khipu-lint: ok KL001 each caller meters it (mirror.admit, mirror.claim)
    return torch.from_numpy(arr.copy()).to(device).t()


# ------------------------------------------------------------ classes


class _ClassMirror:
    """One size class (fixed rate-block count, optionally one exact
    length).

    Thread model as in the JAX package: admits, rekeys and row reads may
    come from different threads; ``_lock`` serializes buffer installs
    against reads and keeps the row <-> key bookkeeping consistent."""

    def _filler_row_u8(self) -> np.ndarray:
        return _filler_row_u8_for(self.width, self.exact_len)

    def __init__(self, nblocks: int, capacity_rows: int, device: torch.device,
                 exact_len: Optional[int] = None):
        """``exact_len``: every row of this class is exactly that many
        bytes (a multiple of 4), stored UNPADDED; the kernel XORs the
        multi-rate pad in registers. The generic class (exact_len None)
        stores padded rows and serves any length within its rate-block
        count."""
        if capacity_rows % TILE:
            raise ValueError("capacity_rows must be a multiple of 1024")
        if exact_len is not None and exact_len % 4:
            raise ValueError("exact_len must be a multiple of 4")
        self.nblocks = nblocks
        self.exact_len = exact_len
        self.device = device
        self.width = exact_len if exact_len else nblocks * RATE
        self.nwords = self.width // 4
        self.capacity = capacity_rows
        self.tiles = capacity_rows // TILE
        self.fill = 0  # ring write pointer (rows)
        self.count = 0  # resident rows (<= capacity)
        self.rows: Dict[bytes, int] = {}  # hash -> row
        # placeholder-keyed rows of not-yet-published windows, kept OUT
        # of the content-address namespace until rekey()
        self.alias_rows: Dict[bytes, int] = {}
        self.row_hash: List[Optional[bytes]] = [None] * capacity_rows
        self.lengths: Dict[bytes, int] = {}  # exact unpadded length
        # the SPILL WATERMARK: window-admitted keys the persist stage has
        # not written to the host store yet
        self.unspilled: set = set()
        self._lock = threading.RLock()
        fw, fd = _filler_for(nblocks, exact_len, device)
        filler_words = torch.from_numpy(np.frombuffer(fw, "<i4").copy())
        filler_digest = torch.from_numpy(np.frombuffer(fd, "<i4").copy())
        # one-time materialization: only the two small filler vectors
        # cross to the card; the broadcast to full size happens there
        # (billed to the init phase, not the stage that built the class)
        with LEDGER.context(phase="init"), LEDGER.transfer(
            "mirror.init", H2D, 4 * (self.nwords + 8)
        ):
            self.resident = (
                filler_words.to(device)[:, None]
                .expand(self.nwords, capacity_rows).contiguous()
            )
            self.claimed = (
                filler_digest.to(device)[:, None]
                .expand(8, capacity_rows).contiguous()
            )

    def _cols(self) -> slice:
        return slice(self.fill, self.fill + TILE)

    def admit_tile(self, hashes: List[bytes], rows, lengths) -> None:
        """Install one full tile: ``rows`` u8[1024, width] (numpy or a
        tensor on any device; short batches are filled with the synthetic
        row by the caller). Claims come from the CLAIMED hashes, not the
        kernel, so verify catches a corrupt admit; in a partial tile the
        filler rows self-claim through K3."""
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.require(rows, np.uint8, ["C", "W"]))
        # the resident-tile refresh: the tile's rows (unless a snapshot
        # generated on the card is already there) and its claims cross
        # to the device
        up = rows.numel() if rows.device.type == "cpu" else 0
        full = len(hashes) >= TILE
        with LEDGER.transfer("mirror.admit", H2D,
                             up + (32 * TILE if full else 0)):
            words = rows.to(self.device).contiguous().view(torch.int32)
            claims = _claim_words(hashes, self.device) if full else None
        with self._lock:
            cols = self._cols()
            self.resident[:, cols].copy_(words.t())
            if full:
                self.claimed[:, cols].copy_(claims)
            else:
                # partial tile: the filler rows self-claim through K3
                # on the device; only the real rows' claims cross
                hash_planes(self.resident[:, cols], self.nblocks,
                            self.exact_len, self.claimed[:, cols])
                if hashes:
                    with LEDGER.transfer("mirror.claim", H2D,
                                         32 * len(hashes)):
                        claims = _claim_words(hashes, self.device)
                    self.claimed[:, self.fill:self.fill + len(hashes)].copy_(
                        claims
                    )
            self._bookkeep_tile(hashes, lengths, self.rows)

    def _evict_row(self, row: int) -> None:
        # evict only if the mapping still points HERE: a duplicate
        # re-admit may have moved the hash to a newer row
        old = self.row_hash[row]
        if old is None:
            return
        if self.rows.get(old) == row:
            del self.rows[old]
            self.lengths.pop(old, None)
            self.count -= 1
        elif self.alias_rows.get(old) == row:
            del self.alias_rows[old]
            self.lengths.pop(old, None)
            self.count -= 1
        else:
            return
        if old in self.unspilled:
            self.unspilled.discard(old)
            MIRROR_GAUGES["unspilled_evictions"] += 1

    def _bookkeep_tile(self, keys, lengths,
                       target: Dict[bytes, int]) -> None:
        """Row <-> key accounting for one freshly installed tile
        starting at ``self.fill`` (lock held by caller)."""
        with _span("mirror.bookkeep"):
            for r in range(TILE):
                row = self.fill + r
                self._evict_row(row)
                h = keys[r] if r < len(keys) else None
                self.row_hash[row] = h
                if h is not None:
                    if h not in target:
                        self.count += 1  # re-admit of a resident key
                    target[h] = row  # latest copy wins
                    self.lengths[h] = int(lengths[r])
            self.fill = (self.fill + TILE) % self.capacity

    def admit_tile_device(self, keys: List[Optional[bytes]],
                          enc_dev: torch.Tensor, claim_dev: torch.Tensor,
                          lengths, alias: bool = True) -> None:
        """Install one tile whose padded encodings (u8[1024, width]) and
        claimed digests (u8[1024, 32]) already live on the mirror's
        device — the window-commit path; no node bytes cross to the
        host. ``alias`` keys go to the placeholder namespace."""
        for name, t, w in (("enc", enc_dev, self.width),
                           ("claim", claim_dev, 32)):
            if (t.device != self.device or t.dtype != torch.uint8
                    or tuple(t.shape) != (TILE, w)):
                raise ValueError(
                    f"{name} must be u8[{TILE}, {w}] on {self.device}"
                )
        with self._lock, _span("mirror.admit_tile", rows=len(keys)):
            cols = self._cols()
            self.resident[:, cols].copy_(
                enc_dev.contiguous().view(torch.int32).t()
            )
            self.claimed[:, cols].copy_(
                claim_dev.contiguous().view(torch.int32).t()
            )
            self._bookkeep_tile(
                keys, lengths, self.alias_rows if alias else self.rows
            )
            if alias:
                # below the spill watermark until persist reads them
                self.unspilled.update(k for k in keys if k is not None)

    def rekey(self, mapping: Mapping[bytes, bytes]) -> int:
        """Move alias-keyed rows to their real content addresses.
        Returns the number of rows promoted."""
        moved = 0
        with self._lock:
            for alias, real in mapping.items():
                row = self.alias_rows.pop(alias, None)
                if row is None:
                    continue
                if self.row_hash[row] != alias:
                    continue  # slot was ring-evicted since admit
                if real in self.rows:
                    self.count -= 1  # duplicate: newer copy wins below
                self.rows[real] = row
                self.row_hash[row] = real
                ln = self.lengths.pop(alias, None)
                if ln is not None:
                    self.lengths[real] = ln
                if alias in self.unspilled:
                    self.unspilled.discard(alias)
                    self.unspilled.add(real)
                moved += 1
        return moved

    def drop_aliases(self, aliases) -> None:
        """Forget alias rows without promoting them (torn window)."""
        with self._lock:
            for alias in aliases:
                row = self.alias_rows.pop(alias, None)
                if row is not None and self.row_hash[row] == alias:
                    self.row_hash[row] = None
                    self.count -= 1
                self.lengths.pop(alias, None)
                self.unspilled.discard(alias)

    def fetch_row(self, key: bytes) -> Optional[bytes]:
        """Read one row back by content address (unpadded): a strided
        gather of one column."""
        with self._lock:
            row = self.rows.get(key)
            if row is None:
                return None
            ln = self.lengths.get(key)
            if ln is None:
                return None
            with LEDGER.transfer("mirror.get", D2H, self.nwords * 4):
                words = self.resident[:, row].cpu().numpy()
            return words.astype("<i4").tobytes()[:ln]

    def spill_rows(self, keys) -> Dict[bytes, bytes]:
        """Bulk read-back for the persist spill: one whole-tile gather
        per resident tile covering the requested keys. Keys not resident
        are absent; fetched keys drop below the spill watermark."""
        out: Dict[bytes, bytes] = {}
        with self._lock:
            by_tile: Dict[int, List[Tuple[bytes, int, int]]] = {}
            for key in keys:
                row = self.rows.get(key)
                if row is None:
                    row = self.alias_rows.get(key)
                if row is None:
                    continue
                ln = self.lengths.get(key)
                if not ln:
                    continue
                by_tile.setdefault(row // TILE, []).append(
                    (key, row % TILE, ln)
                )
            for t in sorted(by_tile):
                with LEDGER.transfer("mirror.spill", D2H,
                                     self.nwords * 4 * TILE):
                    rows_u8 = _rows_of(
                        self.resident[:, t * TILE:(t + 1) * TILE]
                    ).cpu().numpy()
                MIRROR_GAUGES["spilled_tiles"] += 1
                for key, r, ln in by_tile[t]:
                    out[key] = rows_u8[r, :ln].tobytes()
                    self.unspilled.discard(key)
        return out

    def verify(self) -> int:
        # lock held across the launch: a concurrent install would change
        # the very rows being hashed
        with self._lock:
            return verify_planes(self.resident, self.claimed, self.nblocks,
                                 self.exact_len)


class DeviceNodeMirror:
    """Multi-class device mirror; admit in batches, verify in one launch
    per class. See the module docstring. ``device=None`` means the card
    (raising where there is none); ``device="cpu"`` runs the plain
    versions."""

    def __init__(self, capacity_rows_per_class: int = 16 * TILE,
                 device=None):
        self.capacity = capacity_rows_per_class
        self.device = resolve_device(device)
        # keyed by (nblocks, exact_len-or-None)
        self._classes: Dict[Tuple[int, Optional[int]], _ClassMirror] = {}
        # host staging until a whole tile per class is ready
        self._pending: Dict[int, List[Tuple[bytes, bytes]]] = {}

    def _class(self, nblocks: int,
               exact_len: Optional[int] = None) -> _ClassMirror:
        key = (nblocks, exact_len)
        cm = self._classes.get(key)
        if cm is None:
            cm = _ClassMirror(nblocks, self.capacity, self.device, exact_len)
            self._classes[key] = cm
        return cm

    def admit(self, items: Mapping[bytes, bytes]) -> None:
        """Stage nodes (hash -> encoding); full 1024-row tiles install
        immediately, the remainder stays staged until flush()."""
        for h, enc in items.items():
            nb = len(enc) // RATE + 1
            self._pending.setdefault(nb, []).append((h, enc))
        for nb, pend in self._pending.items():
            while len(pend) >= TILE:
                self._install(nb, pend[:TILE])
                del pend[:TILE]

    def flush(self) -> None:
        """Install partial tiles (filled with synthetic rows)."""
        for nb, pend in self._pending.items():
            if pend:
                self._install(nb, pend)
                pend.clear()

    def admit_packed(self, hashes: List[bytes], rows,
                     lengths: Optional[List[int]] = None,
                     exact: bool = False) -> None:
        """Bulk admit of one size class, N a multiple of 1024: the
        vectorized ingest of snapshot verify and bulk loaders. ``rows``
        is u8[N, width], numpy or a tensor (a snapshot generated on the
        card stays there).

        ``exact`` True: ``rows`` are RAW uniform-length encodings (length
        a multiple of 4) stored unpadded in an exact-length class.
        Otherwise ``rows`` are already multi-rate padded."""
        n, width = rows.shape
        if n % TILE:
            raise ValueError("admit_packed wants whole 1024-row tiles")
        if exact:
            cm = self._class(width // RATE + 1, exact_len=width)
        else:
            if width % RATE:
                raise ValueError("padded rows must span whole blocks")
            cm = self._class(width // RATE)
        for start in range(0, n, TILE):
            cm.admit_tile(
                hashes[start:start + TILE],
                rows[start:start + TILE],
                (lengths[start:start + TILE] if lengths
                 else [width] * TILE),
            )

    def _install(self, nb: int, batch: List[Tuple[bytes, bytes]]) -> None:
        cm = self._class(nb)
        padded = np.broadcast_to(cm._filler_row_u8(), (TILE, cm.width)).copy()
        hashes: List[bytes] = []
        lengths: List[int] = []
        for r, (h, enc) in enumerate(batch):
            padded[r, :] = 0
            padded[r, :len(enc)] = np.frombuffer(enc, dtype=np.uint8)
            padded[r, len(enc)] ^= 0x01
            padded[r, cm.width - 1] ^= 0x80
            hashes.append(h)
            lengths.append(len(enc))
        cm.admit_tile(hashes, padded, lengths)

    # ----------------------------------------------- device-side admit

    def admit_device(self, nblocks: int, keys: List[Optional[bytes]],
                     enc_dev: torch.Tensor, claim_dev: torch.Tensor,
                     lengths: List[int], alias: bool = True) -> None:
        """Admit rows whose padded encodings (u8[N, nblocks*136]) and
        claimed digests (u8[N, 32]) already live on the mirror's device,
        N a multiple of 1024 — ``FusedJob.admit_tiles`` feed straight in.
        ``alias`` keys land in the placeholder namespace until
        :meth:`rekey` publishes them."""
        n = enc_dev.shape[0]
        if n % TILE:
            raise ValueError("admit_device wants whole 1024-row tiles")
        cm = self._class(nblocks)
        for start in range(0, n, TILE):
            cm.admit_tile_device(
                keys[start:start + TILE],
                enc_dev[start:start + TILE],
                claim_dev[start:start + TILE],
                lengths[start:start + TILE],
                alias=alias,
            )

    def rekey(self, mapping: Mapping[bytes, bytes]) -> int:
        """Promote alias-admitted rows to their real content addresses.
        Returns rows promoted across all classes."""
        moved = 0
        for cm in list(self._classes.values()):
            if cm.alias_rows:
                moved += cm.rekey(mapping)
        return moved

    def alias_keys(self) -> List[bytes]:
        """Every placeholder still keying a row (windows admitted but not
        yet rekeyed)."""
        return [k for cm in list(self._classes.values())
                for k in list(cm.alias_rows)]

    def drop_aliases(self, aliases) -> None:
        """Forget un-published alias rows (torn/abandoned window)."""
        for cm in list(self._classes.values()):
            if cm.alias_rows:
                cm.drop_aliases(aliases)

    def spill_rows(self, keys) -> Dict[bytes, bytes]:
        """Bulk-tile read-back of resident rows for the persist spill.
        Missing keys (evicted, never admitted) are absent."""
        out: Dict[bytes, bytes] = {}
        remaining = list(keys)
        with _span("mirror.spill", rows=len(remaining)):
            for cm in list(self._classes.values()):
                if not remaining:
                    break
                got = cm.spill_rows(remaining)
                if got:
                    out.update(got)
                    remaining = [k for k in remaining if k not in out]
        return out

    @property
    def unspilled_count(self) -> int:
        return sum(len(cm.unspilled) for cm in list(self._classes.values()))

    # ------------------------------------------------------------ reads

    def contains(self, h: bytes) -> bool:
        for cm in list(self._classes.values()):
            if h in cm.rows:
                return True
        return any(h == ph for pend in self._pending.values()
                   for ph, _ in pend)

    def get(self, h: bytes) -> Optional[bytes]:
        """Read a node back (unpadded via the stored exact length); staged
        nodes are served from the host staging."""
        for cm in list(self._classes.values()):
            enc = cm.fetch_row(h)
            if enc is not None:
                return enc
        for pend in self._pending.values():
            for ph, enc in pend:
                if ph == h:
                    return enc
        return None

    # ------------------------------------------------------------ stats

    @property
    def resident_count(self) -> int:
        return sum(cm.count for cm in list(self._classes.values()))

    def verify(self) -> int:
        """Re-hash EVERY resident node and count content-address
        mismatches — one K4 launch per size class, no layout work."""
        return sum(cm.verify() for cm in list(self._classes.values()))
