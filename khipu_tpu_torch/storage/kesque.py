"""Kesque reborn: the log-structured append-only storage engine.

The port's counterpart of ``khipu_tpu.storage.kesque``: the same record
codec, segment files and sidecar index, byte for byte, so either
package opens the other's directory. Parity: khipu-eth's Kesque
(kafka.kesque) engine — the paper's SECOND research claim: a Kafka-log
store tuned for blockchain access patterns, where writes are
sequential appends of whole batches and reads are one positional fetch
through an in-memory hash -> (segment, offset) index
(KesqueDataSource.scala, KesqueNodeDataSource.scala:61-63 — node topics
store VALUES only and recompute keys by keccak on rebuild). The engine
is host code: content addresses are recomputed by the native host
batch hash (``native/keccak.py``), one call per segment scan or
shipped chunk.

Layout: ``<data_dir>/kesque/<topic>/<topic>-<seq>.kseg`` segment files
of CRC-framed records (storage/segment.py) plus a ``<topic>.kidx``
sidecar index checkpoint. Record payloads:

* node topics (content-addressed): ``0x4E ("N") + value`` — the key IS
  keccak256(value), never stored.
* kv/block topics: ``0x50 ("P") + u32 klen + key + value`` for a put,
  ``0x44 ("D") + u32 klen + key`` for a tombstone.

Why this wins for the persist stage: ``NodeStorage.update([], nodes)``
lands here as ONE ``append_batch`` — the whole mirror-tile spill of a
window (``DeviceNodeMirror.spill_rows``) becomes one sequential write
instead of per-node random puts.

Crash contract (docs/kesque.md): segment opens scan back over torn
tails (segment.py); the sidecar index is CRC-framed and validated
against the repaired segment sizes — stale-optimistic sidecars (they
cover bytes the scan-back truncated) force a full rebuild, valid ones
are extended by scanning only the post-checkpoint tail. The chaos
seams ``kesque.append`` / ``kesque.roll`` / ``kesque.index`` /
``kesque.compact`` let the 120-seed kill sweep tear every one of those
steps; journal recovery (sync/journal.py) then proves the chain
recovers bit-exact.

Compaction (KesqueCompactor.scala role): ``KesqueEngine.compact``
reuses storage/compactor.py's reachability walk (``verify_hashes``)
to rewrite the live records of a pivot state root into fresh
segments, then swaps them in and unlinks the frozen generation.
Lock discipline (KL004): each store has ONE ``_lock`` guarding index
+ segment-table mutations and framed reads; the engine's
``_compact_lock`` serializes compactions and is always acquired
BEFORE any store ``_lock`` (``KesqueEngine._compact_lock ->
KesqueStore._lock``); nothing acquires them in reverse, and the
walk/copy phase holds neither continuously, so reads serve
throughout. A crash anywhere in compaction is safe by construction:
staged segments hold only duplicate content-addressed records until
the index swap, and the swap's effects (index entries, then file
unlinks) only ever drop bytes that were garbage or duplicated.
"""

from __future__ import annotations

import os
import time
import struct
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.native.keccak import keccak256_batch
from khipu_tpu_torch.observability.profiler import HOST, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.storage.datasource import (
    BlockDataSource,
    KeyValueDataSource,
    NodeDataSource,
)
from khipu_tpu_torch.storage.segment import (
    FRAME_HEADER,
    Segment,
    frame,
    scan_frames,
)

TAG_NODE = 0x4E  # "N": content-addressed, key recomputed on rebuild
TAG_PUT = 0x50  # "P": keyed put
TAG_DEL = 0x44  # "D": tombstone

NODE_TOPICS = ("account", "storage", "evmcode")

_U32 = struct.Struct(">I")
_IDX_MAGIC = b"KIDX2"
_IDX_SEG = struct.Struct(">IQQ")  # seq, end, garbage
_IDX_ENT = struct.Struct(">HIQI")  # klen, seq, off, rec_bytes

DEFAULT_SEGMENT_BYTES = 64 << 20


def encode_node_record(value: bytes) -> bytes:
    return bytes([TAG_NODE]) + value


def encode_put_record(key: bytes, value: bytes) -> bytes:
    return bytes([TAG_PUT]) + _U32.pack(len(key)) + key + value


def encode_del_record(key: bytes) -> bytes:
    return bytes([TAG_DEL]) + _U32.pack(len(key)) + key


def decode_record(payload: bytes) -> Tuple[int, Optional[bytes], bytes]:
    """``(tag, key_or_None, value)`` — node records return key=None
    (the caller recomputes it by content address when rebuilding)."""
    tag = payload[0]
    if tag == TAG_NODE:
        return tag, None, payload[1:]
    klen = _U32.unpack_from(payload, 1)[0]
    key = payload[5 : 5 + klen]
    if tag == TAG_DEL:
        return tag, key, b""
    return tag, key, payload[5 + klen :]


class KesqueStore:
    """One topic's segment log + in-memory index. Thread-safe: every
    index/segment-table mutation and framed read runs under ``_lock``
    (one lock, no nesting — KL004)."""

    def __init__(self, data_dir: str, topic: str,
                 content_addressed: bool,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.topic = topic
        self.content_addressed = content_addressed
        self.segment_bytes = max(1 << 12, segment_bytes)
        self.dir = os.path.join(data_dir, "kesque", topic)
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        # key -> (seq, offset, frame_bytes)
        self._index: Dict[bytes, Tuple[int, int, int]] = {}
        self._segments: Dict[int, Segment] = {}
        self._garbage: Dict[int, int] = {}  # seq -> superseded bytes
        self._next_seq = 0
        # open-time repair + rebuild provenance (crash-contract report)
        self.torn_bytes = 0
        self.rebuilt_index = False
        # stats (registry families + read-amplification)
        self.appended_bytes = 0
        self.appended_records = 0
        self.reclaimed_bytes = 0
        self.disk_read_bytes = 0
        self.value_bytes_returned = 0
        self._open_all()

    # --------------------------------------------------------- open/load

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{self.topic}-{seq:08d}.kseg")

    def _open_all(self) -> None:
        seqs = []
        for name in os.listdir(self.dir):
            if name.endswith(".kseg") and name.startswith(self.topic + "-"):
                try:
                    seqs.append(int(name[len(self.topic) + 1 : -5]))
                except ValueError:
                    continue
        for seq in sorted(seqs):
            seg, torn = Segment.open(self._seg_path(seq), seq)
            self.torn_bytes += torn
            self._segments[seq] = seg
            self._garbage.setdefault(seq, 0)
        self._next_seq = max(self._segments, default=-1) + 1
        if not self._load_sidecar():
            self.rebuilt_index = True
            self._index.clear()
            self._garbage = {seq: 0 for seq in self._segments}
            for seq in sorted(self._segments):
                self._apply_segment(self._segments[seq], 0)
        if not self._segments:
            self._roll_locked()

    def _apply_segment(self, seg: Segment, from_off: int) -> None:
        """Fold a segment's records (from ``from_off``) into the index,
        in append order — the rebuild-on-open path."""
        if from_off >= seg.end:
            return
        data = os.pread(seg._fd, seg.end - from_off, from_off)
        frames, _ = scan_frames(data, base=from_off)
        decoded = []
        node_values = []
        for off, payload in frames:
            tag, key, value = decode_record(payload)
            if tag == TAG_NODE:
                node_values.append(value)
            decoded.append((off, len(payload), tag, key, value))
        # content addresses recomputed in one native batch (one FFI
        # crossing for the whole segment, not one per record)
        node_keys = iter(keccak256_batch(node_values))
        for off, plen, tag, key, value in decoded:
            rec_bytes = FRAME_HEADER + plen
            if tag == TAG_NODE:
                key = next(node_keys)  # KesqueNodeDataSource.scala:61
            if tag == TAG_DEL:
                old = self._index.pop(key, None)
                if old is not None:
                    self._garbage[old[0]] = (
                        self._garbage.get(old[0], 0) + old[2]
                    )
                self._garbage[seg.seq] = (
                    self._garbage.get(seg.seq, 0) + rec_bytes
                )
                continue
            old = self._index.get(key)
            if old is not None:
                self._garbage[old[0]] = (
                    self._garbage.get(old[0], 0) + old[2]
                )
            self._index[key] = (seg.seq, off, rec_bytes)

    # ------------------------------------------------------ sidecar index

    @property
    def _sidecar_path(self) -> str:
        return os.path.join(self.dir, f"{self.topic}.kidx")

    def checkpoint(self) -> None:
        """Write the sidecar index: a CRC-framed snapshot of the index
        plus per-segment watermarks, atomically renamed into place.
        The ``kesque.index`` chaos seam sits before the rename — a
        death there leaves the previous sidecar intact."""
        with self._lock:
            parts = [_IDX_MAGIC, _U32.pack(len(self._segments))]
            for seq in sorted(self._segments):
                seg = self._segments[seq]
                parts.append(_IDX_SEG.pack(
                    seq, seg.end, self._garbage.get(seq, 0)
                ))
            parts.append(struct.pack(">Q", len(self._index)))
            for key, (seq, off, rec) in self._index.items():
                parts.append(_IDX_ENT.pack(len(key), seq, off, rec))
                parts.append(key)
            payload = b"".join(parts)
        tmp = self._sidecar_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame(payload))
            f.flush()
            os.fsync(f.fileno())
        fault_point("kesque.index")
        os.replace(tmp, self._sidecar_path)

    def _load_sidecar(self) -> bool:
        """Load the sidecar if it is valid against the REPAIRED
        segments on disk; scan only post-checkpoint tails. Returns
        False (caller full-rebuilds) when the sidecar is absent,
        corrupt, stale-optimistic (covers truncated bytes) or refers
        to segments compaction has since unlinked."""
        try:
            with open(self._sidecar_path, "rb") as f:
                raw = f.read()
        except OSError:
            return False
        frames, _ = scan_frames(raw)
        if len(frames) != 1:
            return False
        payload = frames[0][1]
        if not payload.startswith(_IDX_MAGIC):
            return False
        try:
            pos = len(_IDX_MAGIC)
            nsegs = _U32.unpack_from(payload, pos)[0]
            pos += 4
            watermarks: Dict[int, int] = {}
            garbage: Dict[int, int] = {}
            for _ in range(nsegs):
                seq, end, garb = _IDX_SEG.unpack_from(payload, pos)
                pos += _IDX_SEG.size
                watermarks[seq] = end
                garbage[seq] = garb
            for seq, end in watermarks.items():
                seg = self._segments.get(seq)
                if seg is None or seg.end < end:
                    return False  # truncated/unlinked past the sidecar
            nent = struct.unpack_from(">Q", payload, pos)[0]
            pos += 8
            index: Dict[bytes, Tuple[int, int, int]] = {}
            for _ in range(nent):
                klen, seq, off, rec = _IDX_ENT.unpack_from(payload, pos)
                pos += _IDX_ENT.size
                key = payload[pos : pos + klen]
                pos += klen
                if seq not in watermarks or off + rec > watermarks[seq]:
                    return False
                index[key] = (seq, off, rec)
        except struct.error:
            return False
        self._index = index
        self._garbage = {seq: garbage.get(seq, 0) for seq in self._segments}
        # fold records appended after the checkpoint: covered-segment
        # tails, then whole segments the sidecar never saw, ascending
        # seq == append order (appends only ever hit the active seq)
        for seq in sorted(self._segments):
            self._apply_segment(
                self._segments[seq], watermarks.get(seq, 0)
            )
        return True

    # ----------------------------------------------------------- append

    def _roll_locked(self) -> Segment:
        """Open a fresh active segment (caller holds ``_lock`` or is
        init). The ``kesque.roll`` seam models a death between closing
        one segment and the first append of the next."""
        fault_point("kesque.roll")
        seq = self._next_seq
        self._next_seq += 1
        seg = Segment(self._seg_path(seq), seq)
        self._segments[seq] = seg
        self._garbage.setdefault(seq, 0)
        return seg

    def _active_locked(self) -> Segment:
        seq = max(self._segments)
        seg = self._segments[seq]
        if seg.end >= self.segment_bytes:
            seg = self._roll_locked()
        return seg

    def append_batch(self, to_remove: Iterable[bytes],
                     to_upsert: Mapping[bytes, bytes]) -> int:
        """THE write path: the whole batch — a window's entire
        mirror-tile spill — lands as one sequential run of back-to-back
        frames (``Segment.append_many``: chunked pwrites of the joined
        buffer, not one syscall per node). Returns bytes appended."""
        # (is_delete, key, payload) in append order: tombstones first,
        # matching the (removes, upserts) SPI argument order
        entries: List[Tuple[bool, bytes, bytes]] = []
        for key in to_remove:
            key = bytes(key)
            entries.append((True, key, encode_del_record(key)))
        for key, value in to_upsert.items():
            key, value = bytes(key), bytes(value)
            if self.content_addressed:
                payload = encode_node_record(value)
            else:
                payload = encode_put_record(key, value)
            entries.append((False, key, payload))
        if not entries:
            return 0
        nbytes = 0
        t0 = time.perf_counter()
        with self._lock:
            i = 0
            while i < len(entries):
                seg = self._active_locked()
                room = self.segment_bytes - seg.end
                group: List[Tuple[bool, bytes, bytes]] = []
                size = 0
                while i < len(entries):
                    fb = FRAME_HEADER + len(entries[i][2])
                    if group and size + fb > room:
                        break  # next group after a roll
                    group.append(entries[i])
                    size += fb
                    i += 1
                locs = seg.append_many([p for _, _, p in group])
                for (is_del, key, _p), (off, rec) in zip(group, locs):
                    nbytes += rec
                    if is_del:
                        self._garbage[seg.seq] = (
                            self._garbage.get(seg.seq, 0) + rec
                        )
                        old = self._index.pop(key, None)
                    else:
                        old = self._index.get(key)
                        self._index[key] = (seg.seq, off, rec)
                    if old is not None:
                        self._garbage[old[0]] = (
                            self._garbage.get(old[0], 0) + old[2]
                        )
            self.appended_bytes += nbytes
            self.appended_records += len(entries)
        # host-side store traffic: classification only in the ledger
        LEDGER.record("kesque.append", HOST, nbytes,
                      duration=time.perf_counter() - t0)
        return nbytes

    def append_raw(self, raw: bytes,
                   entries: List[Tuple[bytes, int, int]]) -> None:
        """Splice a VERIFIED run of already-framed records into the
        log verbatim — the segment-streamed ingest fast path. ``raw``
        must be whole valid frames (the caller has scanned, decoded
        and content-addressed every one); ``entries`` is
        ``[(key, rel_off, rec_bytes), ...]`` addressing them relative
        to the chunk start. Shipping is byte-identical, so the frames
        are reused as written instead of being re-encoded and
        re-CRC'd one record at a time."""
        if not raw:
            return
        t0 = time.perf_counter()
        with self._lock:
            seg = self._active_locked()
            if seg.end and seg.end + len(raw) > self.segment_bytes:
                seg = self._roll_locked()
            base = seg.append_raw(raw)
            for key, rel, rec in entries:
                old = self._index.get(key)
                if old is not None:
                    self._garbage[old[0]] = (
                        self._garbage.get(old[0], 0) + old[2]
                    )
                self._index[key] = (seg.seq, base + rel, rec)
            self.appended_bytes += len(raw)
            self.appended_records += len(entries)
        LEDGER.record("kesque.append", HOST, len(raw),
                      duration=time.perf_counter() - t0)

    # ------------------------------------------------------------- reads

    def get(self, key: bytes) -> Optional[bytes]:
        key = bytes(key)
        with self._lock:
            loc = self._index.get(key)
            if loc is None:
                return None
            seq, off, rec = loc
            payload = self._segments[seq].read(off)
            self.disk_read_bytes += rec
        _tag, _k, value = decode_record(payload)
        self.value_bytes_returned += len(value)
        return value

    def keys(self) -> List[bytes]:
        with self._lock:
            return sorted(self._index)

    def max_key8(self) -> int:
        with self._lock:
            best = -1
            for k in self._index:
                if len(k) == 8:
                    n = int.from_bytes(k, "big")
                    if n > best:
                        best = n
            return best

    @property
    def count(self) -> int:
        return len(self._index)

    @property
    def read_amplification(self) -> float:
        """Disk bytes fetched per value byte served — the serving-load
        number ``chip_smoke.py``'s kesque replay reports (frame headers +
        record tags are the only overhead of a positional Kesque read)."""
        if self.value_bytes_returned == 0:
            return 0.0
        return self.disk_read_bytes / self.value_bytes_returned

    # --------------------------------------------------------- streaming

    def segments(self) -> List[Tuple[int, int]]:
        """``[(seq, committed_size), ...]`` ascending — the shipping
        manifest (bridge ``EngineInfo``)."""
        with self._lock:
            return [
                (seq, self._segments[seq].end)
                for seq in sorted(self._segments)
            ]

    def read_chunk(self, seq: int, offset: int,
                   max_bytes: int) -> Tuple[bytes, int, bool]:
        """Raw whole-frame chunk of one segment (segment-ship unit)."""
        with self._lock:
            seg = self._segments.get(seq)
            if seg is None:
                # compacted away mid-stream: the puller restarts from
                # the fresh manifest (idempotent, content-addressed)
                raise KeyError(f"{self.topic} segment {seq} is gone")
            return seg.read_chunk(offset, max_bytes)

    # -------------------------------------------------------- compaction

    def freeze_for_compaction(self) -> Tuple[Tuple[int, ...], int]:
        """Roll the active segment and return the frozen generation:
        ``(seqs, total_bytes)``. Every record appended after this call
        lands in segments OUTSIDE the frozen set, so the swap can
        never drop concurrent writes."""
        with self._lock:
            frozen = tuple(sorted(self._segments))
            total = sum(self._segments[s].end for s in frozen)
            self._roll_locked()
            return frozen, total

    def new_compaction_segment(self) -> Segment:
        """A fresh, index-invisible segment for the compaction sink
        (unique seq from the same counter, so it can be adopted
        wholesale at swap time)."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        return Segment(self._seg_path(seq), seq)

    def swap_compacted(self, frozen: Tuple[int, ...],
                       staged: List[Segment],
                       staged_index: Dict[bytes, Tuple[int, int, int]],
                       ) -> int:
        """Adopt the staged generation and unlink the frozen one.
        Returns reclaimed bytes. Index rules: a staged entry wins only
        over a frozen location (a concurrent append into the post-
        freeze active segment is newer and kept); any key still
        pointing into the frozen set afterwards was unreachable from
        the pivot — dropped with its bytes."""
        frozen_set = set(frozen)
        with self._lock:
            for seg in staged:
                self._segments[seg.seq] = seg
                self._garbage.setdefault(seg.seq, 0)
            for key, loc in staged_index.items():
                cur = self._index.get(key)
                if cur is None or cur[0] in frozen_set:
                    self._index[key] = loc
            dropped = [
                k for k, loc in self._index.items()
                if loc[0] in frozen_set
            ]
            for k in dropped:
                del self._index[k]
            reclaimed = 0
            for seq in frozen:
                seg = self._segments.pop(seq, None)
                if seg is not None:
                    reclaimed += seg.end
                    seg.unlink()
                self._garbage.pop(seq, None)
            reclaimed -= sum(s.end for s in staged)
            self.reclaimed_bytes += max(0, reclaimed)
            return max(0, reclaimed)

    # ------------------------------------------------------------- stats

    def segment_stats(self) -> List[dict]:
        """Per-segment live/garbage split — the compaction report and
        ``khipu_kesque_*`` family source."""
        with self._lock:
            out = []
            for seq in sorted(self._segments):
                size = self._segments[seq].end
                garbage = min(size, self._garbage.get(seq, 0))
                out.append({
                    "seq": seq,
                    "bytes": size,
                    "garbage_bytes": garbage,
                    "live_bytes": size - garbage,
                })
            return out

    # --------------------------------------------------------- lifecycle

    def flush(self) -> None:
        """fsync the active segment — the durability barrier the
        window journal's flush-after-intent contract relies on."""
        with self._lock:
            if self._segments:
                self._segments[max(self._segments)].flush()

    def stop(self) -> None:
        self.checkpoint()
        with self._lock:
            for seg in self._segments.values():
                seg.close()


# --------------------------------------------------------------------
# DataSource adapters (the SPI Storages assembles)


class KesqueKeyValueDataSource(KeyValueDataSource):
    def __init__(self, store: KesqueStore):
        super().__init__()
        self._store = store

    def get(self, key: bytes) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            return self._store.get(key)
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        self._store.append_batch(to_remove, to_upsert)

    @property
    def count(self) -> int:
        return self._store.count

    def keys(self) -> List[bytes]:
        return self._store.keys()

    def flush(self) -> None:
        self._store.flush()

    def stop(self) -> None:
        self._store.stop()


class KesqueNodeDataSource(KesqueKeyValueDataSource, NodeDataSource):
    """Content-addressed node store over the segment log. Removes are
    swallowed (archive semantics, NodeStorage.scala:16-19); keys are
    never stored — rebuild recomputes them from values
    (KesqueNodeDataSource.scala:61-63)."""

    def update(self, to_remove, to_upsert) -> None:
        self._store.append_batch([], to_upsert)


class KesqueBlockDataSource(BlockDataSource):
    def __init__(self, store: KesqueStore):
        super().__init__()
        self._store = store
        self._best = store.max_key8()
        self._lock = threading.Lock()

    @staticmethod
    def _key(number: int) -> bytes:
        return int(number).to_bytes(8, "big")

    def get(self, number: int) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            return self._store.get(self._key(number))
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        with self._lock:
            self._store.append_batch(
                [self._key(n) for n in to_remove],
                {self._key(n): v for n, v in to_upsert.items()},
            )
            for n in to_upsert:
                if int(n) > self._best:
                    self._best = int(n)
            if to_remove:
                self._best = self._store.max_key8()

    @property
    def best_block_number(self) -> int:
        return self._best

    @property
    def count(self) -> int:
        return self._store.count

    def flush(self) -> None:
        self._store.flush()

    def stop(self) -> None:
        self._store.stop()


# --------------------------------------------------------------------
# Engine


class _CompactionSink:
    """The NodeWriter role: collects the reachability walk's live
    records into staged (index-invisible) segments of the target
    store. No store lock is held while writing — the files are private
    until ``swap_compacted`` adopts them."""

    def __init__(self, store: KesqueStore):
        self.store = store
        self.segments: List[Segment] = []
        self.index: Dict[bytes, Tuple[int, int, int]] = {}
        self.copied_bytes = 0

    def _active(self) -> Segment:
        if (not self.segments
                or self.segments[-1].end >= self.store.segment_bytes):
            self.segments.append(self.store.new_compaction_segment())
        return self.segments[-1]

    def update(self, to_remove, to_upsert) -> None:
        for key, value in to_upsert.items():
            seg = self._active()
            if self.store.content_addressed:
                payload = encode_node_record(value)
            else:
                payload = encode_put_record(bytes(key), value)
            off, rec = seg.append(payload)
            self.index[bytes(key)] = (seg.seq, off, rec)
            self.copied_bytes += rec


class KesqueEngine:
    """All of one node's Kesque topic stores + the compaction driver +
    the segment-shipping surface (fast-sync ingest, rebalance)."""

    name = "kesque"

    def __init__(self, data_dir: str,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.data_dir = data_dir
        self.segment_bytes = segment_bytes
        self._stores: Dict[str, KesqueStore] = {}
        self._stores_lock = threading.Lock()
        self._compact_lock = threading.Lock()
        self.compactions = 0
        self.last_report: Optional[object] = None
        # one collector per name: the newest engine's samples win
        REGISTRY.register_collector("kesque", self._registry_samples)

    # ----------------------------------------------------------- stores

    def store(self, topic: str) -> KesqueStore:
        with self._stores_lock:
            st = self._stores.get(topic)
            if st is None:
                st = KesqueStore(
                    self.data_dir, topic,
                    content_addressed=topic in NODE_TOPICS,
                    segment_bytes=self.segment_bytes,
                )
                self._stores[topic] = st
            return st

    def node_source(self, topic: str) -> KesqueNodeDataSource:
        return KesqueNodeDataSource(self.store(topic))

    def kv_source(self, topic: str) -> KesqueKeyValueDataSource:
        return KesqueKeyValueDataSource(self.store(topic))

    def block_source(self, topic: str) -> KesqueBlockDataSource:
        return KesqueBlockDataSource(self.store(topic))

    # ---------------------------------------------------- crash contract

    def repair_lines(self) -> List[str]:
        """Open-time torn-tail repairs + index rebuilds, one line per
        store — surfaced into the journal RecoveryReport so the crash
        contract's scan-back is visible in ``recover:`` output."""
        out = []
        for topic in sorted(self._stores):
            st = self._stores[topic]
            if st.torn_bytes:
                out.append(
                    f"kesque[{topic}]: torn segment tail truncated "
                    f"({st.torn_bytes} bytes scanned back)"
                )
            if st.rebuilt_index:
                out.append(
                    f"kesque[{topic}]: index rebuilt from segment scan "
                    f"({st.count} records)"
                )
        return out

    # -------------------------------------------------------- compaction

    def compact(self, state_root: bytes, batch: int = 1000) -> object:
        """Background-safe mark-and-sweep: rewrite the records
        reachable from ``state_root`` (hash-verified — a corrupt
        record is counted, never copied) into fresh segments of the
        three node topics, swap them in, unlink the frozen generation.
        Reads serve throughout: the walk holds no lock across reads
        and the swap is one short critical section per store."""
        from khipu_tpu_torch.storage.compactor import compact as _compact

        with self._compact_lock:
            fault_point("kesque.compact")
            t0 = time.perf_counter()
            stores = {t: self.store(t) for t in NODE_TOPICS}
            frozen = {
                t: stores[t].freeze_for_compaction() for t in NODE_TOPICS
            }
            sinks = {t: _CompactionSink(stores[t]) for t in NODE_TOPICS}
            report = _compact(
                KesqueNodeDataSource(stores["account"]),
                KesqueNodeDataSource(stores["storage"]),
                KesqueNodeDataSource(stores["evmcode"]),
                state_root,
                sinks["account"], sinks["storage"], sinks["evmcode"],
                batch=batch, verify_hashes=True,
            )
            reclaimed = 0
            for t in NODE_TOPICS:
                reclaimed += stores[t].swap_compacted(
                    frozen[t][0], sinks[t].segments, sinks[t].index
                )
                stores[t].checkpoint()
            report.reclaimed_bytes = reclaimed
            report.segment_stats = self.segment_stats()
            self.compactions += 1
            self.last_report = report
            copied = sum(s.copied_bytes for s in sinks.values())
            LEDGER.record("kesque.compact", HOST, copied,
                          duration=time.perf_counter() - t0)
            return report

    # --------------------------------------------------------- streaming

    def list_segments(self, topics: Optional[Iterable[str]] = None
                      ) -> List[Tuple[str, int, int]]:
        """The shipping manifest: ``[(topic, seq, size), ...]`` over
        the node topics (the unit of bulk movement)."""
        out: List[Tuple[str, int, int]] = []
        for topic in (topics or NODE_TOPICS):
            for seq, size in self.store(topic).segments():
                out.append((topic, seq, size))
        return out

    def read_chunk(self, topic: str, seq: int, offset: int,
                   max_bytes: int) -> Tuple[bytes, int, bool]:
        return self.store(topic).read_chunk(seq, offset, max_bytes)

    def ingest_chunk(self, topic: str, raw: bytes) -> Tuple[int, int]:
        """Parse a shipped chunk and bulk-append its VERIFIED records:
        node records are admitted under their recomputed content
        address (a corrupt frame cannot forge a key — hashing IS the
        verification), anything else in a node topic is rejected.
        Returns ``(records, corrupt)``."""
        frames, end = scan_frames(raw)
        values: List[bytes] = []
        metas: List[Tuple[int, int]] = []
        corrupt = 0
        for off, payload in frames:
            if not payload:
                corrupt += 1
                continue
            tag, _key, value = decode_record(payload)
            if tag != TAG_NODE or not value:
                corrupt += 1  # only content-addressed records ship
                continue
            values.append(value)
            metas.append((off, FRAME_HEADER + len(payload)))
        # one native batch hash per chunk — the admission check IS the
        # content addressing, so this is the ingest hot loop
        keys = keccak256_batch(values)
        store = self.store(topic)
        if values and not corrupt and end == len(raw):
            # every frame verified as a node record: splice the chunk
            # into the log verbatim (no re-framing, no re-CRC)
            store.append_raw(raw, [
                (k, off, rec) for k, (off, rec) in zip(keys, metas)
            ])
        elif values:
            # mixed or short-scanned chunk: re-encode just the
            # verified records through the framing write path
            store.append_batch([], dict(zip(keys, values)))
        return len(values), corrupt

    # ------------------------------------------------------------- stats

    def segment_stats(self) -> Dict[str, List[dict]]:
        return {
            topic: self._stores[topic].segment_stats()
            for topic in sorted(self._stores)
        }

    def read_amplification(self) -> float:
        disk = sum(s.disk_read_bytes for s in self._stores.values())
        served = sum(
            s.value_bytes_returned for s in self._stores.values()
        )
        return disk / served if served else 0.0

    def _registry_samples(self) -> list:
        samples = []
        n_segs = 0
        live = garbage = appended = reclaimed = torn = entries = 0
        for st in list(self._stores.values()):
            for row in st.segment_stats():
                n_segs += 1
                live += row["live_bytes"]
                garbage += row["garbage_bytes"]
            appended += st.appended_bytes
            reclaimed += st.reclaimed_bytes
            torn += st.torn_bytes
            entries += st.count
        samples.extend([
            ("khipu_kesque_segments", "gauge", {}, n_segs),
            ("khipu_kesque_live_bytes", "gauge", {}, live),
            ("khipu_kesque_garbage_bytes", "gauge", {}, garbage),
            ("khipu_kesque_index_entries", "gauge", {}, entries),
            ("khipu_kesque_appended_bytes_total", "counter", {},
             appended),
            ("khipu_kesque_reclaimed_bytes_total", "counter", {},
             reclaimed),
            ("khipu_kesque_torn_bytes_total", "counter", {}, torn),
            ("khipu_kesque_compactions_total", "counter", {},
             self.compactions),
            ("khipu_kesque_read_amplification", "gauge", {},
             round(self.read_amplification(), 4)),
        ])
        return samples

    # --------------------------------------------------------- lifecycle

    def checkpoint(self) -> None:
        for st in list(self._stores.values()):
            st.checkpoint()

    def stop(self) -> None:
        for st in list(self._stores.values()):
            st.stop()
