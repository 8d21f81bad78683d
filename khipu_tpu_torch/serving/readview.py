"""Read-your-writes consistency over the pipelined window state.

The deep pipeline (sync/replay.py) creates a serving-visible gap: a
block's transactions have EXECUTED (the driver committed them into the
open window session) up to ``pipeline_depth`` windows before its nodes
persist and ``best_block_number`` advances (the background collector's
job). A bare ``eth_getBalance`` in that gap reads the committed store —
state from several blocks ago — and worse, two polls can straddle a
collect and observe state move BACKWARDS relative to what a block
explorer already showed.

``ReadView`` closes the gap with an overlay of executed-but-not-yet-
durable account records on top of the committed store:

* the window committer PUBLISHES each block's materialized account
  diff at ``commit_block`` (driver thread, one dict update under the
  view lock — atomic per block, so no read ever sees half a block);
* reads at ``latest``/``pending`` resolve overlay-first, store-second,
  each answer tagged with the block number it reflects;
* once the collector has made a window durable (root-checked,
  persisted, best advanced) the overlay RETIRES those blocks — the
  store now serves the same-or-newer state, so per-key reads are
  monotonic across the handoff;
* a pipeline abort (WindowMismatch / collector death) INVALIDATES
  everything above the committed best — un-durable state must never
  outlive the windows that produced it (the torn-window guarantee the
  chaos suite pins).

The contract covers account nonce/balance — the two fields the window
session materializes exactly (storage roots are still placeholder refs
mid-window). ``eth_getTransactionByHash`` read-your-writes for pooled
txs comes from the txpool itself; this view makes the STATE side hold.

The port's copy of ``khipu_tpu.serving.readview``. The port's windowed
device commit feeds it: ``WindowCommitter(on_block_committed=)``
publishes at ``commit_block`` (a host dict of the block's materialized
accounts — no device read), the replay's save stage retires a window
after its commit mark, and every abort exit of ``replay_windowed``
(an error at ``fused.dispatch`` or in a kernel wrapper among them: the
port stops where the reference degrades) invalidates above best.

One difference from the reference: a windowed chain stores each
window's last state only, and the save stage advances best block by
block through a window before the retirement. A read that falls
through to the committed store therefore goes to ``committed_header()``
— the highest header at or below best whose state root the store
holds — where the reference reads best's state root and can meet a
missing node mid-window (ROADMAP §C). The store alone decides: blocks
saved one by one (a switch's adoption, a pushed block) store every
state and retire nothing from the view.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from khipu_tpu_torch.base import EMPTY_TRIE_HASH
from khipu_tpu_torch.domain.account import Account
from khipu_tpu_torch.observability.journey import JOURNEY

# distinguishes "address not covered by the overlay" from "address
# deleted by an overlaid block" (which must read as absent)
_MISS = object()


class ReadView:
    def __init__(self, blockchain):
        self.blockchain = blockchain
        self._lock = threading.Lock()
        # addr -> (block_number, Account | None); newest publication wins
        self._overlay: Dict[bytes, Tuple[int, Optional[Account]]] = {}
        # number -> {addr: (number, Account | None)} for retire/rollback
        self._blocks: Dict[int, Dict[bytes, tuple]] = {}
        self._head = blockchain.best_block_number
        self.published = 0
        self.retired = 0
        self.invalidated = 0

    # ----------------------------------------------------- pipeline side

    def publish_block(self, header, accounts: Dict[bytes, Optional[Account]],
                      txs: Optional[list] = None) -> None:
        """One executed block's account diff becomes visible ATOMICALLY
        (driver thread, at window-session commit). ``txs`` — the
        block's tx hashes, threaded from WindowCommitter.commit_block —
        stamps the read-your-writes page of each tx's passport; None
        (the default) when the journey plane is off."""
        number = header.number
        entries = {
            addr: (number, acc) for addr, acc in accounts.items()
        }
        with self._lock:
            self._overlay.update(entries)
            self._blocks[number] = entries
            if number > self._head:
                self._head = number
            self.published += 1
        if txs and JOURNEY.enabled:
            for tx_hash in txs:
                JOURNEY.record(tx_hash, "readview.publish",
                               height=number)

    def retire_through(self, number: int) -> None:
        """Drop overlay entries the committed store now serves (the
        collector calls this AFTER save_block advanced best). An
        address overwritten by a newer un-durable block keeps its
        newer entry — the identity check below frees only records this
        retired block still owns."""
        with self._lock:
            for n in [n for n in self._blocks if n <= number]:
                for addr, entry in self._blocks.pop(n).items():
                    if self._overlay.get(addr) is entry:
                        del self._overlay[addr]
                self.retired += 1

    def invalidate_above(self, number: int) -> None:
        """Roll the overlay back to the durable chain (pipeline abort:
        the windows above ``number`` never became real)."""
        with self._lock:
            dropped = [n for n in self._blocks if n > number]
            for n in dropped:
                del self._blocks[n]
            if dropped:
                self.invalidated += len(dropped)
                # rebuild: surviving blocks re-assert their entries in
                # ascending order so the newest surviving write wins
                self._overlay = {}
                for n in sorted(self._blocks):
                    self._overlay.update(self._blocks[n])
            self._head = max(
                (number, *self._blocks.keys())
            ) if self._blocks else number

    # ------------------------------------------------------- read side

    def head_number(self) -> int:
        """Highest block whose state this view serves (>= store best
        while windows are in flight)."""
        with self._lock:
            head = self._head
        return max(head, self.blockchain.best_block_number)

    def committed_header(self):
        """The header whose state the committed store serves at the
        head: the highest at or below best whose state root is stored.
        That is best, unless the save stage is inside a window (a
        windowed chain stores each window's last state only); then the
        blocks above it are un-retired, so the overlay holds every
        address they changed. The scan is bounded by one window."""
        bc = self.blockchain
        nodes = bc.storages.account_node_storage
        number = bc.best_block_number
        header = bc.get_header_by_number(number)
        while (number > 0 and header.state_root != EMPTY_TRIE_HASH
               and nodes.get(header.state_root) is None):
            number -= 1
            header = bc.get_header_by_number(number)
        return header

    def get_account(self, addr: bytes):
        """(block_number, Account | None) — overlay-first, committed
        store second. ``Account is None`` means the address does not
        exist at that block."""
        with self._lock:
            entry = self._overlay.get(addr, _MISS)
        if entry is not _MISS:
            return entry
        bc = self.blockchain
        best = bc.best_block_number
        header = self.committed_header()
        return best, bc.get_account(addr, header.state_root)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "head": self._head,
                "overlayAddrs": len(self._overlay),
                "overlayBlocks": len(self._blocks),
                "published": self.published,
                "retired": self.retired,
                "invalidated": self.invalidated,
            }
