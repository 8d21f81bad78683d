"""Write-ahead window-commit journal + crash recovery.

The deep pipeline (sync/replay.py) moved root checks, node/code
persistence and block saves onto a background collector thread. A
process death mid-job leaves node storage, block storage and
``AppStateStorage.best_block_number`` mutually inconsistent — and
before this module nothing on startup detected or repaired that.

Protocol (two records per window, over the ``journal`` KV topic):

* INTENT — written and flushed BEFORE the background job's first
  mutation (the driver writes it at submit, the job runs strictly
  after): ``[b"I", seq, lo, hi, parent_root, [expected_root, ...]]``
  under key ``b"J" + seq``. The expected roots are the header state
  roots the collector will verify — recovery re-verifies against the
  same values.
* COMMIT — ``b"\\x01"`` under key ``b"C" + seq``, written after the
  window's last ``save_block`` advanced ``best_block_number``.

A crash between the two leaves a pending intent. ``recover()`` scans
them in order and, per window, either REPAIRS (every block present
with the expected root, td/body/receipts stored, and the state trie at
the window's last root fully reachable with every node's bytes
matching its content address — node puts are content-addressed and
idempotent, so a partially re-persisted window that verifies is simply
complete) or ROLLS BACK (removes the window's partial block records
and resets ``best_block_number`` to the last fully-committed window;
orphaned trie nodes are harmless — content-addressed, unreferenced,
reclaimed by the compactor). Once one window rolls back every later
pending window rolls back too: its parent chain is gone.

A chain REORG (sync/reorg.py) journals a third record shape in the
same seq stream:

* REORG-INTENT — ``[b"R", seq, ancestor_number, ancestor_hash,
  [old_hash, ...], [adopted_hash, ...], [orphan_tx_rlp, ...]]`` under
  ``b"J" + seq``, with the adopted branch's FULL block RLP staged
  under ``b"RB" + seq + number`` and flushed BEFORE the intent.
  Staging first makes the switch atomic: once the intent is durable,
  recovery can always re-execute the adopted branch from the (still
  durable) ancestor state, so a kill anywhere inside the switch
  resolves to exactly the old chain (abandon: nothing was removed
  yet) or exactly the new one (roll forward: strip everything above
  the ancestor, re-execute the staged blocks). The orphan txs — mined
  on the losing branch only — ride in the record because the rollback
  removes their bodies: an in-process recovery handed a txpool can
  still recycle them after a mid-switch death.

Crash points and their outcomes are enumerated in docs/recovery.md;
tests/test_torch_chaos.py and tests/test_torch_reorg.py provoke them
with the chaos harness, against the JAX package's ``recover`` on the
same chains. The port's copy of ``khipu_tpu.sync.journal``: the same
record format, readable by either package, with the transaction
passport's ``journal.rollback`` stamps. A torn switch rolls forward on the
``device`` ``recover`` is given (None: the card).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY

_INTENT_PREFIX = b"J"
_COMMIT_PREFIX = b"C"
_REORG_BLOCK_PREFIX = b"RB"  # staged adopted-branch block RLP
_HEAD_KEY = b"head"  # next seq to assign
_TAIL_KEY = b"tail"  # lowest seq not yet pruned


def _seq_key(prefix: bytes, seq: int) -> bytes:
    return prefix + int(seq).to_bytes(8, "big")


def _int_bytes(n: int) -> bytes:
    return int(n).to_bytes(8, "big").lstrip(b"\x00") or b"\x00"


def _block_key(seq: int, number: int) -> bytes:
    return (_REORG_BLOCK_PREFIX + int(seq).to_bytes(8, "big")
            + int(number).to_bytes(8, "big"))


@dataclass
class IntentRecord:
    seq: int
    lo: int
    hi: int
    parent_root: bytes
    roots: List[bytes]  # expected header state roots, lo..hi


@dataclass
class ReorgRecord:
    seq: int
    ancestor_number: int
    ancestor_hash: bytes
    old_hashes: List[bytes]  # ancestor+1 .. old tip (the chain we leave)
    adopted_hashes: List[bytes]  # ancestor+1 .. new tip (staged branch)
    # txs mined ONLY on the losing branch (their bodies do not survive
    # the rollback): recovery recycles these into a provided txpool
    orphan_tx_rlp: List[bytes] = field(default_factory=list)

    @property
    def old_top(self) -> int:
        return self.ancestor_number + len(self.old_hashes)

    @property
    def new_top(self) -> int:
        return self.ancestor_number + len(self.adopted_hashes)

    def orphan_txs(self) -> list:
        from khipu_tpu_torch.domain.transaction import SignedTransaction

        out = []
        for raw in self.orphan_tx_rlp:
            try:
                out.append(SignedTransaction.decode(raw))
            except Exception:
                pass  # a torn tx row loses one orphan, not the switch
        return out


class WindowJournal:
    """The WAL over one KeyValueDataSource (``Storages.journal_source``
    — every engine gives it the same durability as the block stores;
    ``flush`` after the intent is the fsync barrier where the engine
    has one)."""

    def __init__(self, source, barrier=None):
        self.source = source
        # makes every topic's writes so far durable before a commit mark
        # (``Storages.flush_writes``); None for a bare journal
        self._barrier = barrier
        self._lock = threading.Lock()
        # recovery passes run over this journal (``recover``): a bridge
        # that tore a batch refuses more until this count moves
        self.recoveries = 0
        # registry pull collector, replace-by-key: the newest journal
        # (tests build hundreds) owns the khipu_journal_depth sample
        REGISTRY.register_collector(
            "journal",
            lambda: [("khipu_journal_depth", "gauge", {}, self.depth)],
        )

    # ----------------------------------------------------------- pointers

    def _get_int(self, key: bytes, default: int = 0) -> int:
        v = self.source.get(key)
        return int.from_bytes(v, "big") if v else default

    def _flush(self) -> None:
        fl = getattr(self.source, "flush", None)
        if fl:
            fl()

    # ------------------------------------------------------------ writing

    def log_intent(self, lo: int, hi: int, parent_root: bytes,
                   expected_roots: List[bytes]) -> int:
        """Durable BEFORE the caller mutates anything; returns the seq
        for the matching ``log_commit``. Record first, head second: a
        crash between the two orphans a record whose job never started
        — recovery's tail..head scan correctly ignores it."""
        if len(expected_roots) != hi - lo + 1:
            raise ValueError("one expected root per block of the window")
        with self._lock:
            seq = self._get_int(_HEAD_KEY)
            self.source.put(
                _seq_key(_INTENT_PREFIX, seq),
                rlp_encode([
                    b"I", _int_bytes(seq), _int_bytes(lo), _int_bytes(hi),
                    bytes(parent_root),
                    [bytes(r) for r in expected_roots],
                ]),
            )
            self.source.put(_HEAD_KEY, int(seq + 1).to_bytes(8, "big"))
            self._flush()
        return seq

    def log_reorg_intent(self, ancestor_number: int, ancestor_hash: bytes,
                         old_hashes: List[bytes], adopted_blocks,
                         orphan_txs=()) -> int:
        """Stage the adopted branch + fsync the reorg intent; durable
        BEFORE the switch removes anything. Staging goes first (own
        flush barrier): an intent that promises a branch recovery
        cannot read would be a torn switch with no winning side. A
        crash between the two leaves orphan staged rows under a seq
        the head never covered — bounded garbage, ignored by the scan
        and overwritten when the seq is eventually assigned."""
        if len(adopted_blocks) == 0:
            raise ValueError("a reorg adopts at least one block")
        first = adopted_blocks[0].number
        if first != ancestor_number + 1:
            raise ValueError(
                f"adopted branch starts at #{first}, expected "
                f"#{ancestor_number + 1}"
            )
        with self._lock:
            seq = self._get_int(_HEAD_KEY)
            for b in adopted_blocks:
                self.source.put(_block_key(seq, b.number), b.encode())
            self._flush()
            self.source.put(
                _seq_key(_INTENT_PREFIX, seq),
                rlp_encode([
                    b"R", _int_bytes(seq), _int_bytes(ancestor_number),
                    bytes(ancestor_hash),
                    [bytes(h) for h in old_hashes],
                    [bytes(b.hash) for b in adopted_blocks],
                    [stx.encode() for stx in orphan_txs],
                ]),
            )
            self.source.put(_HEAD_KEY, int(seq + 1).to_bytes(8, "big"))
            self._flush()
        return seq

    def staged_blocks(self, rec: "ReorgRecord"):
        """Decode the adopted branch staged for ``rec`` (roll-forward
        input). None if any staged row is missing — impossible after a
        durable intent (staging flushes first) but recovery treats it
        as roll-back-only rather than crash."""
        from khipu_tpu_torch.domain.block import Block

        out = []
        with self._lock:
            for i in range(len(rec.adopted_hashes)):
                raw = self.source.get(
                    _block_key(rec.seq, rec.ancestor_number + 1 + i)
                )
                if raw is None:
                    return None
                out.append(Block.decode(raw))
        return out

    def log_commit(self, seq: int) -> None:
        """The window's blocks are saved and best advanced — or
        recovery settled the intent (repair OR rollback); either way
        the intent needs no further attention. The blocks, state
        nodes and app state the window wrote reach the OS first: a
        commit mark must never outlive what it marks."""
        if self._barrier is not None:
            self._barrier()
        with self._lock:
            self.source.put(_seq_key(_COMMIT_PREFIX, seq), b"\x01")
            self._flush()

    # ------------------------------------------------------------ reading

    def pending(self) -> List[Union[IntentRecord, "ReorgRecord"]]:
        """Intents without a commit mark, ascending — the windows (or
        chain switches) a crash may have left half-persisted."""
        out: List[Union[IntentRecord, ReorgRecord]] = []
        with self._lock:
            tail = self._get_int(_TAIL_KEY)
            head = self._get_int(_HEAD_KEY)
            for seq in range(tail, head):
                raw = self.source.get(_seq_key(_INTENT_PREFIX, seq))
                if raw is None:
                    continue
                if self.source.get(_seq_key(_COMMIT_PREFIX, seq)):
                    continue
                out.append(self._decode(raw))
        return out

    @staticmethod
    def _decode(raw: bytes) -> Union[IntentRecord, "ReorgRecord"]:
        fields = rlp_decode(raw)
        tag = fields[0]
        if tag == b"I":
            _, seq, lo, hi, parent_root, roots = fields
            return IntentRecord(
                seq=int.from_bytes(seq, "big"),
                lo=int.from_bytes(lo, "big"),
                hi=int.from_bytes(hi, "big"),
                parent_root=parent_root,
                roots=list(roots),
            )
        if tag == b"R":
            _, seq, anc_n, anc_h, old, adopted = fields[:6]
            orphans = list(fields[6]) if len(fields) > 6 else []
            return ReorgRecord(
                seq=int.from_bytes(seq, "big"),
                ancestor_number=int.from_bytes(anc_n, "big"),
                ancestor_hash=anc_h,
                old_hashes=list(old),
                adopted_hashes=list(adopted),
                orphan_tx_rlp=orphans,
            )
        raise ValueError(f"bad journal record tag {tag!r}")

    def prune(self) -> int:
        """Drop the settled prefix (intent+commit pairs below the first
        pending intent); returns records removed. Bounds the journal to
        O(in-flight windows)."""
        removed = 0
        with self._lock:
            tail = self._get_int(_TAIL_KEY)
            head = self._get_int(_HEAD_KEY)
            seq = tail
            while seq < head:
                ik = _seq_key(_INTENT_PREFIX, seq)
                raw = self.source.get(ik)
                if (raw is not None
                        and not self.source.get(
                            _seq_key(_COMMIT_PREFIX, seq))):
                    break  # first pending — stop
                if raw is not None:
                    try:
                        rec = self._decode(raw)
                    except ValueError:
                        rec = None
                    if isinstance(rec, ReorgRecord):
                        # a settled switch's staged branch goes with it
                        for i in range(len(rec.adopted_hashes)):
                            self.source.remove(_block_key(
                                seq, rec.ancestor_number + 1 + i
                            ))
                self.source.remove(ik)
                self.source.remove(_seq_key(_COMMIT_PREFIX, seq))
                removed += 1
                seq += 1
            if seq != tail:
                self.source.put(_TAIL_KEY, int(seq).to_bytes(8, "big"))
        return removed

    @property
    def depth(self) -> int:
        """Live record span (head - tail) — a journal-health gauge."""
        with self._lock:
            return self._get_int(_HEAD_KEY) - self._get_int(_TAIL_KEY)


# ------------------------------------------------------------- recovery


@dataclass
class RecoveryReport:
    scanned: int = 0  # pending intents found
    repaired: int = 0  # windows verified complete; mark restored
    rolled_back: int = 0  # windows undone
    blocks_removed: int = 0
    missing_nodes: int = 0  # state-walk misses across failed verifies
    corrupt_nodes: int = 0  # content-address mismatches found
    reorgs_completed: int = 0  # torn switches rolled FORWARD to new tip
    reorgs_abandoned: int = 0  # switches killed before any removal
    best_before: int = 0
    best_after: int = 0
    actions: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return self.scanned == 0


def recover(blockchain, log: Optional[Callable[[str], None]] = None,
            config=None, txpool=None, device=None) -> RecoveryReport:
    """The startup pass (ReplayDriver.recover / ServiceBoard.__init__):
    settle every pending intent — repair complete windows, roll back
    partial ones, complete or abandon torn chain switches, leave
    ``best_block_number`` on the last block whose state fully verifies.
    Idempotent: a crash DURING recovery re-enters the same scan.

    ``config`` (a KhipuConfig) enables reorg roll-forward: a torn
    switch re-executes its staged branch from the ancestor state, on
    ``device`` (None: the card; ``"cpu"`` for the plain versions).
    Without a config the node settles at the ancestor — still a
    consistent chain prefix, finished on the next start.

    ``txpool`` (in-process recovery, e.g. ReorgManager's mid-switch
    failure path): orphan txs staged in a settled reorg intent are
    recycled into it through the pool's replacement rules. Boot-time
    recovery passes None — a restarted process has no pool to
    protect.

    Torn segment tails (kesque engine, docs/kesque.md): the storage
    layer's OWN open-time repair runs before this pass ever sees the
    stores — ``Segment.open`` scans back over any frame torn by a
    death inside ``kesque.append``/``kesque.roll`` and truncates to
    the last valid boundary, and a sidecar index that covers the
    truncated bytes (a ``kesque.index`` death) is discarded for a
    full rebuild. What recovery sees is therefore a PREFIX of the
    appended records; ``_verify_window``'s hash-verified reachability
    walk then classifies any record lost off the tail as ``missing``
    and rolls the torn window back — the same verdict a torn sqlite
    write would get. The repairs themselves are surfaced as
    ``storage:`` action lines via ``storages.storage_repair_report``
    (none for the memory, native and sqlite engines), so the
    scan-back is visible in recovery output."""
    storages = blockchain.storages
    # the device mirror is volatile: recovery verification must see
    # exactly what a real restart would see — host-durable state only.
    # (In-process crash tests would otherwise "recover" through HBM.)
    detach = getattr(storages, "detach_mirror", None)
    if detach is not None:
        detach()
    journal = storages.window_journal
    report = RecoveryReport(best_before=storages.app_state.best_block_number)
    # open-time storage repairs (kesque torn-tail scan-back / index
    # rebuild) happened when the engine opened; put them on the record
    repairs = getattr(storages, "storage_repair_report", None)
    if repairs is not None:
        for line in repairs():
            report.actions.append(f"storage: {line}")
    pending = journal.pending()
    report.scanned = len(pending)
    emit = log or (lambda s: None)
    rollback_floor: Optional[int] = None  # first rolled-back lo

    for rec in pending:
        if isinstance(rec, ReorgRecord):
            outcome = _settle_reorg(
                blockchain, rec, journal, report, config, rollback_floor,
                txpool=txpool, device=device,
            )
            journal.log_commit(rec.seq)
            if outcome == "rolled_forward":
                # the chain was rebuilt through the adopted branch:
                # later pending window intents (journaled by the
                # crashed windowed adoption) verify against the
                # re-executed blocks
                rollback_floor = None
            continue
        verified = False
        if rollback_floor is None:
            verified = _verify_window(blockchain, rec, report)
        if verified:
            journal.log_commit(rec.seq)
            report.repaired += 1
            report.actions.append(
                f"window [{rec.lo}..{rec.hi}] verified complete; "
                "commit mark restored"
            )
        else:
            removed = _rollback_window(blockchain, rec)
            journal.log_commit(rec.seq)  # settled by rollback
            report.rolled_back += 1
            report.blocks_removed += removed
            if rollback_floor is None:
                rollback_floor = rec.lo
            report.actions.append(
                f"window [{rec.lo}..{rec.hi}] rolled back "
                f"({removed} partial block records removed)"
            )

    if rollback_floor is not None:
        # best falls back to the last fully-committed window; the block
        # sources already recomputed their best on remove
        app_best = storages.app_state.best_block_number
        new_best = min(app_best, rollback_floor - 1,
                       max(0, storages.best_block_number))
        storages.app_state.best_block_number = max(0, new_best)
        report.actions.append(
            f"best block rolled back {app_best} -> "
            f"{storages.app_state.best_block_number}"
        )
    journal.prune()
    journal.recoveries += 1
    report.best_after = storages.app_state.best_block_number
    for line in report.actions:
        emit(f"recover: {line}")
    return report


def _verify_window(blockchain, rec: IntentRecord,
                   report: RecoveryReport) -> bool:
    """Is the window FULLY persisted? Every block record present under
    its expected root, and the state trie at the window's last root
    reachable end-to-end with every node content-address clean."""
    from khipu_tpu_torch.storage.compactor import verify_reachable

    s = blockchain.storages
    for i, n in enumerate(range(rec.lo, rec.hi + 1)):
        header = blockchain.get_header_by_number(n)
        if header is None or header.state_root != rec.roots[i]:
            return False
        if (s.block_body_storage.get(n) is None
                or s.receipts_storage.get(n) is None
                or s.total_difficulty_storage.get(n) is None
                or s.block_numbers.hash_of(n) != header.hash):
            return False
    walk = verify_reachable(
        s.account_node_storage, s.storage_node_storage,
        s.evmcode_storage, rec.roots[-1], verify_hashes=True,
    )
    report.missing_nodes += walk.missing
    report.corrupt_nodes += walk.corrupt
    return walk.missing == 0 and walk.corrupt == 0


def _rollback_window(blockchain, rec: IntentRecord) -> int:
    """Remove whatever block records the dead job managed to write.
    Deliberately NOT Blockchain.remove_block: that needs a decodable
    header+body pair, and a torn window may have either half missing."""
    from khipu_tpu_torch.domain.block import BlockBody

    s = blockchain.storages
    removed = 0
    for n in range(rec.lo, rec.hi + 1):
        header_raw = s.block_header_storage.get(n)
        body_raw = s.block_body_storage.get(n)
        if header_raw is None and body_raw is None \
                and s.receipts_storage.get(n) is None:
            continue
        removed += 1
        if body_raw is not None:
            try:
                for tx in BlockBody.decode(body_raw).transactions:
                    s.transaction_storage.source.remove(tx.hash)
                    if JOURNEY.enabled:
                        # recovery truth on the passport: the tx's
                        # half-committed window never reached the commit
                        # mark — its journey ends before durable and
                        # resumes when the re-import stamps fresh pages
                        JOURNEY.record(tx.hash, "journal.rollback",
                                       block=n)
            except Exception:
                pass  # a torn body still gets its by-number records cut
        if header_raw is not None:
            h = s.block_numbers.hash_of(n)
            if h is not None:
                s.block_numbers.remove(h)
        s.block_header_storage.source.remove(n)
        s.block_body_storage.source.remove(n)
        s.receipts_storage.source.remove(n)
        s.total_difficulty_storage.source.remove(n)
    return removed


def _recycle_orphans(txpool, rec: ReorgRecord, report) -> None:
    """Re-enter the losing branch's orphan txs through the pool's
    standard replacement rules (a pooled higher-bid same-slot tx keeps
    its place)."""
    if txpool is None or not rec.orphan_tx_rlp:
        return
    recycled = 0
    for stx in rec.orphan_txs():
        if stx.sender is None:
            continue
        try:
            if txpool.add(stx):
                recycled += 1
        except ValueError:
            pass
    if recycled:
        report.actions.append(
            f"reorg at #{rec.ancestor_number}: {recycled} orphaned "
            f"txs recycled into the pool"
        )


def _settle_reorg(blockchain, rec: ReorgRecord, journal, report,
                  config, rollback_floor, txpool=None, device=None) -> str:
    """Resolve one pending reorg intent to a whole chain.

    ABANDON when the old chain is untouched (the kill hit after the
    intent fsync but before the rollback removed anything): the node
    is already at exactly the old chain — nothing to do.

    ROLL FORWARD otherwise: the switch is torn (old blocks partially
    removed, adopted blocks partially saved, or any mix). Strip
    everything above the ancestor and re-execute the staged branch
    from the durable ancestor state — the node lands at exactly the
    new chain. Re-execution goes through the same validated import
    path as live sync, so the recovered chain is bit-exact vs a fresh
    replay of the winning branch."""
    s = blockchain.storages
    anc = rec.ancestor_number

    # intactness is judged by block PRESENCE, not the best pointer:
    # the switch drops best to the ancestor before it removes anything
    # (serving safety — sync/reorg.py _rollback), so a kill there
    # leaves best low with the old chain untouched. Restore best.
    intact = s.app_state.best_block_number in (rec.old_top, anc)
    if intact:
        for i, h in enumerate(rec.old_hashes):
            n = anc + 1 + i
            if (s.block_numbers.hash_of(n) != h
                    or s.block_header_storage.get(n) is None
                    or s.block_body_storage.get(n) is None):
                intact = False
                break
    if intact:
        s.app_state.best_block_number = rec.old_top
        report.reorgs_abandoned += 1
        report.actions.append(
            f"reorg at #{anc} abandoned: old chain intact through "
            f"#{rec.old_top}"
        )
        return "abandoned"

    # mirror-image fast path: the kill hit AFTER adoption finished
    # (pre-finalize) — if the new chain is fully present and its tip
    # state verifies end-to-end, completing is just the commit mark
    if _new_chain_complete(blockchain, rec, report):
        report.reorgs_completed += 1
        report.actions.append(
            f"reorg at #{anc} completed in place: adopted chain "
            f"verified through #{rec.new_top}"
        )
        _recycle_orphans(txpool, rec, report)
        return "rolled_forward"

    top = max(rec.old_top, rec.new_top,
              s.app_state.best_block_number,
              max(0, s.best_block_number))
    removed = _remove_above(blockchain, anc, top)
    s.app_state.best_block_number = anc
    report.blocks_removed += removed

    blocks = journal.staged_blocks(rec)
    # roll-forward needs a config (gas schedule, chain id) and an
    # ancestor whose state a prior window rollback did not take out;
    # failing either, the ancestor prefix is the consistent stop
    if (config is None or blocks is None
            or (rollback_floor is not None and rollback_floor <= anc)):
        report.rolled_back += 1
        report.actions.append(
            f"reorg at #{anc} rolled back to ancestor "
            f"({removed} block records removed; no roll-forward "
            f"{'config' if config is None else 'state'})"
        )
        # at the ancestor NEITHER branch's txs are mined
        _recycle_orphans(txpool, rec, report)
        return "rolled_back"

    from khipu_tpu_torch.sync.replay import PHASES, ReplayDriver, ReplayStats

    # the same commit as the switch's per-block adoption: every trie
    # level through K1r on ``device`` (the plain sponge on ``"cpu"``)
    driver = ReplayDriver(blockchain, config, device_commit=True,
                          device=device)
    stats = ReplayStats(phases={k: 0.0 for k in PHASES})
    for b in blocks:
        driver._execute_and_insert(b, stats)
    report.reorgs_completed += 1
    report.actions.append(
        f"reorg at #{anc} rolled forward: {removed} torn block records "
        f"removed, {len(blocks)} adopted blocks re-executed to "
        f"#{rec.new_top}"
    )
    _recycle_orphans(txpool, rec, report)
    return "rolled_forward"


def _new_chain_complete(blockchain, rec: ReorgRecord, report) -> bool:
    """Every adopted block at its number with full records, best at
    the new tip, and the tip state reachable with clean content
    addresses — same bar _verify_window holds torn windows to."""
    from khipu_tpu_torch.storage.compactor import verify_reachable

    s = blockchain.storages
    if s.app_state.best_block_number != rec.new_top:
        return False
    for i, h in enumerate(rec.adopted_hashes):
        n = rec.ancestor_number + 1 + i
        if (s.block_numbers.hash_of(n) != h
                or s.block_header_storage.get(n) is None
                or s.block_body_storage.get(n) is None
                or s.receipts_storage.get(n) is None
                or s.total_difficulty_storage.get(n) is None):
            return False
    tip = blockchain.get_header_by_number(rec.new_top)
    walk = verify_reachable(
        s.account_node_storage, s.storage_node_storage,
        s.evmcode_storage, tip.state_root, verify_hashes=True,
    )
    report.missing_nodes += walk.missing
    report.corrupt_nodes += walk.corrupt
    return walk.missing == 0 and walk.corrupt == 0


def _remove_above(blockchain, ancestor: int, top: int) -> int:
    """Raw by-number removal of every block record in
    (ancestor, top] — old-chain remnants and partially-adopted blocks
    alike. NOT Blockchain.remove_block: a torn switch may have either
    half of any record missing."""
    from khipu_tpu_torch.domain.block import BlockBody

    s = blockchain.storages
    removed = 0
    for n in range(ancestor + 1, top + 1):
        header_raw = s.block_header_storage.get(n)
        body_raw = s.block_body_storage.get(n)
        if (header_raw is None and body_raw is None
                and s.receipts_storage.get(n) is None):
            continue
        removed += 1
        if body_raw is not None:
            try:
                for tx in BlockBody.decode(body_raw).transactions:
                    s.transaction_storage.source.remove(tx.hash)
                    if JOURNEY.enabled:
                        JOURNEY.record(tx.hash, "journal.rollback",
                                       block=n)
            except Exception:
                pass  # a torn body still gets its by-number records cut
        h = s.block_numbers.hash_of(n)
        if h is not None:
            s.block_numbers.remove(h)
        s.block_header_storage.source.remove(n)
        s.block_body_storage.source.remove(n)
        s.receipts_storage.source.remove(n)
        s.total_difficulty_storage.source.remove(n)
    return removed
