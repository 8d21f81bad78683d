"""Fast sync: typed node-hash queues, crash-resumable state download,
and batched content-address verification.

The port's counterpart of ``khipu_tpu.sync.fast_sync``. The default
hasher is the batched sponge on ``device`` (kernel K1r on the card), not
the host scalar hash, and the final mirror verify runs kernel K4 per
size class. ``segment_snapshot_ingest`` streams a Kesque engine's
segments into another (``storage/kesque.py``).

Parity: blockchain/sync/FastSyncService.scala:100 (SyncState :65-82
seeds the queue with StateMptNodeHash(target.stateRoot) :252; received
nodes are parsed and their children enqueued by type,
sync/package.scala:21-42; batched saves :898-918; periodic state
persist) and storage/FastSyncStateStorage.scala:24 (putSyncState :76 /
getSyncState :84 / purge :140 — crash-resume).

Networking is a callback: ``fetch(hashes) -> {hash: bytes}`` — a peer
pool in production, another store in tests. Every received batch is
content-address-verified through the batched device hasher, replacing
the per-node JVM kec256 at KesqueNodeDataSource.scala:61-63.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

from khipu_tpu_torch.base.nibbles import hp_decode
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.domain.account import (
    EMPTY_CODE_HASH,
    EMPTY_STORAGE_ROOT,
    Account,
)
from khipu_tpu_torch.observability.profiler import HOST, LEDGER
from khipu_tpu_torch.observability.trace import span
from khipu_tpu_torch.trie.bulk import resolve_hasher

# Typed node hashes (sync/package.scala:21-42).
STATE_NODE = 0  # account-trie MPT node
STORAGE_NODE = 1  # contract-storage-trie MPT node
EVMCODE = 2  # code blob by code hash


@dataclass
class SyncState:
    """FastSyncService.SyncState (:65-82): resumable download state."""

    target_root: bytes
    pending: List[Tuple[int, bytes]] = field(default_factory=list)
    downloaded_nodes: int = 0

    def encode(self) -> bytes:
        return rlp_encode(
            [
                self.target_root,
                [[bytes([t]), h] for t, h in self.pending],
                self.downloaded_nodes.to_bytes(8, "big"),
            ]
        )

    @staticmethod
    def decode(data: bytes) -> "SyncState":
        root, pending, count = rlp_decode(data)
        return SyncState(
            target_root=root,
            pending=[(t[0], h) for t, h in pending],
            downloaded_nodes=int.from_bytes(count, "big"),
        )


class FastSyncStateStorage:
    """Persist/restore/purge the SyncState
    (FastSyncStateStorage.scala:24)."""

    KEY = b"fast-sync-state"

    def __init__(self, source):
        self.source = source

    def put_sync_state(self, state: SyncState) -> None:
        self.source.put(self.KEY, state.encode())

    def get_sync_state(self) -> Optional[SyncState]:
        raw = self.source.get(self.KEY)
        return SyncState.decode(raw) if raw is not None else None

    def purge(self) -> None:
        self.source.remove(self.KEY)


def _children_of(kind: int, encoded: bytes) -> List[Tuple[int, bytes]]:
    """Parse an MPT node and emit typed child work items
    (NodeDatasRequest.processResponse role)."""
    if kind == EVMCODE:
        return []
    node = rlp_decode(encoded)
    out: List[Tuple[int, bytes]] = []

    def ref_children(ref):
        if isinstance(ref, bytes) and len(ref) == 32:
            out.append((kind, ref))
        elif isinstance(ref, list):
            walk_node(ref)  # inline (<32B) child

    def walk_node(n):
        if len(n) == 17:  # branch
            for i in range(16):
                if n[i] != b"":
                    ref_children(n[i])
            if kind == STATE_NODE and n[16] != b"":
                leaf_value(n[16])
        elif len(n) == 2:
            _, is_leaf = hp_decode(n[0])
            if is_leaf:
                if kind == STATE_NODE:
                    leaf_value(n[1])
            else:
                ref_children(n[1])
        return out

    def leaf_value(value: bytes):
        # account leaves reference a storage root + code hash
        acc = Account.decode(value)
        if acc.storage_root != EMPTY_STORAGE_ROOT:
            out.append((STORAGE_NODE, acc.storage_root))
        if acc.code_hash != EMPTY_CODE_HASH:
            out.append((EVMCODE, acc.code_hash))

    walk_node(node)
    return out


class StateSyncer:
    """Download a state trie to local storages via a fetch callback,
    with checkpoint/resume (SyncingHandler role, peers abstracted).

    Received batches are verified with the batched hasher before being
    saved; a corrupt node is rejected and stays pending. ``hasher=None``
    batches on ``device``: ``device=None`` means the card (raising where
    there is none), ``device="cpu"`` the plain sponge.
    """

    def __init__(
        self,
        storages,
        state_storage: FastSyncStateStorage,
        fetch: Callable[[List[bytes]], Mapping[bytes, bytes]],
        batch_size: int = 100,  # nodes-per-request (application.conf)
        hasher=None,  # batch content-address check; None = on device
        checkpoint_every: int = 10,
        mirror=None,  # DeviceNodeMirror: admits verified state nodes
        device=None,
    ):
        _, hasher = resolve_hasher(hasher, device)
        self.storages = storages
        self.state_storage = state_storage
        self.fetch = fetch
        self.batch_size = batch_size
        self.hasher = hasher
        self.checkpoint_every = checkpoint_every
        # device mirror (storage/device_mirror.py): verified nodes are
        # admitted in the kernels' word-major layout at download time,
        # so the post-sync whole-snapshot re-verification (config #5)
        # runs on resident rows with zero layout work
        self.mirror = mirror

    def _verify(self, hashes: List[bytes], values: List[bytes]) -> List[bool]:
        with span("fastsync.verify", nodes=len(hashes), device=True):
            digests = self.hasher(values)
            return [d == h for d, h in zip(digests, hashes)]

    def start(self, target_root: bytes) -> SyncState:
        """Begin (or resume) syncing toward target_root; runs to
        completion (the peer-request loop is the fetch callback's
        concern). Returns the final state."""
        state = self.state_storage.get_sync_state()
        if state is None or state.target_root != target_root:
            state = SyncState(
                target_root=target_root,
                pending=[(STATE_NODE, target_root)],
            )
        batches_done = 0
        seen: Set[bytes] = set()
        while state.pending:
            batch = state.pending[: self.batch_size]
            state.pending = state.pending[self.batch_size :]
            want = [h for _, h in batch]
            with span("fastsync.fetch", batch=batches_done,
                      nodes=len(want)):
                got = self.fetch(want)
            missing: List[Tuple[int, bytes]] = []
            hashes, values, kinds = [], [], []
            for kind, h in batch:
                v = got.get(h)
                if v is None:
                    missing.append((kind, h))
                else:
                    hashes.append(h)
                    values.append(v)
                    kinds.append(kind)
            ok = self._verify(hashes, values) if hashes else []
            node_batch: Dict[bytes, bytes] = {}
            storage_batch: Dict[bytes, bytes] = {}
            code_batch: Dict[bytes, bytes] = {}
            for kind, h, v, good in zip(kinds, hashes, values, ok):
                if not good:
                    missing.append((kind, h))  # corrupt: retry later
                    continue
                if kind == STATE_NODE:
                    node_batch[h] = v
                elif kind == STORAGE_NODE:
                    storage_batch[h] = v
                else:
                    code_batch[h] = v
                for child in _children_of(kind, v):
                    if child[1] not in seen:
                        seen.add(child[1])
                        state.pending.append(child)
                state.downloaded_nodes += 1
            # batched saves (saveAccountNodes :898-918)
            if node_batch:
                self.storages.account_node_storage.update([], node_batch)
            if storage_batch:
                self.storages.storage_node_storage.update([], storage_batch)
            if code_batch:
                self.storages.evmcode_storage.update([], code_batch)
            if self.mirror is not None:
                if node_batch:
                    self.mirror.admit(node_batch)
                if storage_batch:
                    self.mirror.admit(storage_batch)
            state.pending.extend(missing)
            if missing and not (node_batch or storage_batch or code_batch):
                raise RuntimeError(
                    f"no progress: {len(missing)} nodes unavailable"
                )
            batches_done += 1
            if batches_done % self.checkpoint_every == 0:
                self.state_storage.put_sync_state(state)
        if self.mirror is not None:
            # re-verification of every RESIDENT node on word-major
            # rows: one K4 launch per size class, zero layout work.
            # Covers the whole snapshot when the mirror's per-class
            # capacity >= the snapshot's node count (chip_smoke.py sizes it
            # so); a smaller mirror ring-evicts and this verifies the
            # retained tail — per-batch download verification above
            # covered every node either way. BEFORE purge: a failure
            # must leave the resumable checkpoint intact, not force a
            # full re-download.
            self.mirror.flush()
            bad = self.mirror.verify()
            if bad:
                raise RuntimeError(
                    f"device-mirror verify: {bad} of "
                    f"{self.mirror.resident_count} resident nodes "
                    "failed content-address check"
                )
        self.state_storage.purge()
        self.storages.app_state.mark_fast_sync_done()
        return state


@dataclass
class SegmentIngestReport:
    """What the segment-streamed ingest moved and proved."""

    segments: int = 0
    records: int = 0
    bytes: int = 0
    corrupt_frames: int = 0
    verified_nodes: int = 0  # post-ingest reachability walk
    missing: int = 0
    corrupt_nodes: int = 0


def segment_snapshot_ingest(
    storages,
    list_segments: Callable[[], List[Tuple[str, int, int]]],
    fetch_chunk: Callable[[str, int, int, int], Tuple[bytes, int, bool]],
    target_root: Optional[bytes] = None,
    workers: int = 4,
    chunk_bytes: int = 1 << 20,
) -> SegmentIngestReport:
    """The Kesque bulk-ingest path: stream whole VERIFIED segments in
    parallel instead of walking the trie node-by-node (StateSyncer).

    Why it is faster: the per-node loop pays one fetch round-trip per
    ``batch_size`` nodes AND must parse every node to discover its
    children before it can even request them — the trie walk serializes
    discovery. Segment streaming needs zero discovery (the source's
    segment manifest IS the work list), ships megabyte chunks, and
    lands each chunk as one sequential ``append_batch``. Verification
    is not skipped — it is free: every shipped record is admitted under
    its recomputed keccak, so a corrupt frame simply cannot land under
    a valid key (the same content-address argument as
    KesqueNodeDataSource.scala:61-63), and the optional
    ``target_root`` walk re-proves reachability exactly like crash
    recovery does.

    ``list_segments() -> [(topic, seq, size), ...]`` and
    ``fetch_chunk(topic, seq, offset, max_bytes) -> (raw, next, done)``
    abstract the wire (a peer's segment-serving surface, or a local
    engine's ``list_segments`` / ``read_chunk``). The admission hash is
    the native host batch hash inside ``KesqueEngine.ingest_chunk``,
    whose C call releases the GIL, so the ``workers`` threads hash at
    once. Requires a kesque-backed ``storages`` (segments are the unit
    of movement — there is nothing to bulk-append into otherwise)."""
    from concurrent.futures import ThreadPoolExecutor

    from khipu_tpu_torch.chaos import fault_point

    engine = getattr(storages, "kesque_engine", None)
    if engine is None:
        raise RuntimeError(
            "segment ingest requires Storages(engine='kesque')"
        )
    report = SegmentIngestReport()
    manifest = list_segments()

    def pull(item: Tuple[str, int, int]) -> Tuple[int, int, int]:
        topic, seq, _size = item
        records = nbytes = corrupt = 0
        offset, done = 0, False
        while not done:
            fault_point("kesque.ingest")
            t0 = time.perf_counter()
            raw, offset, done = fetch_chunk(topic, seq, offset,
                                            chunk_bytes)
            if not raw:
                break
            n, bad = engine.ingest_chunk(topic, raw)
            records += n
            corrupt += bad
            nbytes += len(raw)
            LEDGER.record("kesque.ingest", HOST, len(raw),
                          duration=time.perf_counter() - t0)
        return records, nbytes, corrupt

    with span("fastsync.segment_ingest", segments=len(manifest),
              workers=workers):
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            for records, nbytes, corrupt in pool.map(pull, manifest):
                report.segments += 1
                report.records += records
                report.bytes += nbytes
                report.corrupt_frames += corrupt

    if target_root is not None:
        from khipu_tpu_torch.storage.compactor import verify_reachable

        walk = verify_reachable(
            storages.account_node_storage,
            storages.storage_node_storage,
            storages.evmcode_storage,
            target_root, verify_hashes=True,
        )
        report.verified_nodes = walk.total
        report.missing = walk.missing
        report.corrupt_nodes = walk.corrupt
        if walk.missing or walk.corrupt:
            raise RuntimeError(
                f"segment ingest incomplete: {walk.missing} missing / "
                f"{walk.corrupt} corrupt nodes reachable from target "
                "root"
            )
        storages.app_state.mark_fast_sync_done()
    return report
