"""Write-ahead window-commit journal.

The port's counterpart of ``khipu_tpu.sync.journal``, in the same record
format over the ``journal`` KV topic. The windowed pipeline
(sync/replay.py) moves root checks, node and code persistence and block
saves onto background stage threads; a process death mid-job leaves node
storage, block storage and ``AppStateStorage.best_block_number``
mutually inconsistent. The journal records what a recovery pass needs to
settle that:

* INTENT — written and flushed BEFORE the background job's first
  mutation (the driver writes it at seal, the job runs strictly after):
  ``[b"I", seq, lo, hi, parent_root, [expected_root, ...]]`` under key
  ``b"J" + seq``. The expected roots are the header state roots the
  collector will verify.
* COMMIT — ``b"\\x01"`` under key ``b"C" + seq``, written after the
  window's last ``save_block`` advanced ``best_block_number``.

A chain reorg journals a third record shape in the same seq stream,
``[b"R", seq, ancestor_number, ancestor_hash, [old_hash, ...],
[adopted_hash, ...], [orphan_tx_rlp, ...]]``, with the adopted branch's
block RLP staged under ``b"RB" + seq + number``. The port writes no such
record yet (the reorg writer and ``recover``, which repairs or rolls back
pending windows, come with crash recovery), but ``pending`` and
``prune`` read and settle any record the reference writes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Union

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode

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
    # txs mined ONLY on the losing branch
    orphan_tx_rlp: List[bytes] = field(default_factory=list)


class WindowJournal:
    """The WAL over one KeyValueDataSource (``Storages.journal_source``;
    ``flush`` after the intent is the fsync barrier where the source has
    one)."""

    def __init__(self, source):
        self.source = source
        self._lock = threading.Lock()

    def _get_int(self, key: bytes, default: int = 0) -> int:
        v = self.source.get(key)
        return int.from_bytes(v, "big") if v else default

    def _flush(self) -> None:
        fl = getattr(self.source, "flush", None)
        if fl:
            fl()

    def log_intent(self, lo: int, hi: int, parent_root: bytes,
                   expected_roots: List[bytes]) -> int:
        """Durable BEFORE the caller mutates anything; returns the seq
        for the matching ``log_commit``. Record first, head second: a
        crash between the two orphans a record whose job never started,
        which a tail..head scan ignores."""
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

    def log_commit(self, seq: int) -> None:
        """The window's blocks are saved and best advanced: the intent
        needs no further attention."""
        with self._lock:
            self.source.put(_seq_key(_COMMIT_PREFIX, seq), b"\x01")
            self._flush()

    def pending(self) -> List[Union[IntentRecord, ReorgRecord]]:
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
    def _decode(raw: bytes) -> Union[IntentRecord, ReorgRecord]:
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
