"""Crash-safe, serving-safe chain reorganization.

Every deep-pipeline PR widened the window between "executed" and
"durable" — a 4-stage collector, a device mirror of placeholder
aliases, a ReadView overlay serving executed-but-not-yet-durable
reads — and all of it assumed a monotonic chain. The ReorgManager is
where a TD-winning side branch crosses that machinery: one journaled,
fenced, atomic switch instead of regular_sync's old unjournaled
block-at-a-time rewind.

The switch runs five phases (chaos seams in parentheses; see
docs/recovery.md for the crash-point table):

1. FENCE — invalidate the serving overlay above the fork point
   (``ReadView.invalidate_above``), settle any in-flight window
   intents a dead collector left behind (journal recovery pass, which
   also detaches the volatile device mirror), and drop unpublished
   placeholder aliases from the mirror. After the fence, nothing
   above the ancestor is visible to readers or half-owned by a
   background stage.
2. INTENT (``reorg.intent``) — stage the adopted branch's full block
   RLP in the window-commit journal and fsync a reorg-intent record
   (sync/journal.py). From here a kill anywhere resolves to exactly
   the old chain or exactly the new one.
3. ROLLBACK (``reorg.rollback``, per block) — remove the old blocks
   tip-down, verifying the walk reaches the ancestor.
4. ADOPT (``reorg.adopt``, per block) — import the branch through the
   same validated paths live sync uses: the windowed pipeline for
   long branches, per-block (with the caller's heal hook) otherwise.
5. FINALIZE (``reorg.finalize``) — commit-mark the intent, emit
   ``removed: true`` filter entries for logs in orphaned blocks,
   drop adopted txs from the pool, and recycle orphaned-only txs
   back into it through the standard replacement rules (geth parity).

A reorg deeper than ``db.unconfirmed_depth`` is refused
(``ReorgTooDeep`` — regular_sync demotes the peer) instead of walking
off the pruned unconfirmed ring.

The port's copy of ``khipu_tpu.sync.reorg``. A long branch adopts
through the windowed pipeline (one K5 launch a window on the card), a
short one block by block through the driver's commit (K1r on the card
with ``device_commit``). The transaction passport stamps
``reorg.retract`` and ``reorg.reinclude``. The retracted logs are the
filters' ``LogHit`` records (jsonrpc/filters.py), delivered to
``FilterManager.note_reorg`` at finalize.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.jsonrpc.filters import LogHit
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import span


class ReorgTooDeep(RuntimeError):
    """The branch forks below the unconfirmed ring — refuse it."""


class ReorgManager:
    """Owns the atomic chain switch; one per sync service/driver.

    ``driver=None`` builds ``ReplayDriver(blockchain, config,
    device_commit=True, device=device)``: both adoption paths commit on
    ``device`` (K5 a window, K1r a block); ``device=None`` means the
    card, and raises without one."""

    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        driver=None,
        txpool=None,
        read_view=None,
        log: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        self.blockchain = blockchain
        self.config = config
        if driver is None:
            from khipu_tpu_torch.sync.replay import ReplayDriver

            driver = ReplayDriver(blockchain, config, device_commit=True,
                                  device=device)
        self.driver = driver
        self.txpool = txpool
        self.read_view = read_view
        self.log = log or (lambda s: None)
        # counters are read by scrape/watchdog threads while the
        # switch mutates them on the import thread
        self._lock = threading.Lock()
        self.switches = 0
        self.refused = 0
        self.last_depth = 0
        # blocks the last switch re-executed to rebuild its ancestor's
        # state (an ancestor inside a committed window)
        self.regenerated_blocks = 0
        self.orphaned_blocks = 0
        self.recycled_txs = 0
        # reorg observers: fn(ancestor_number, removed_hits) — the
        # filter manager's note_reorg hangs here (jsonrpc/filters.py)
        self._listeners: List[Callable] = []
        REGISTRY.register_collector("reorg", self._registry_samples)

    # -------------------------------------------------------- observability

    def _registry_samples(self) -> list:
        with self._lock:
            return [
                ("khipu_reorg_total", "counter", {}, self.switches),
                ("khipu_reorg_refused_total", "counter", {},
                 self.refused),
                ("khipu_reorg_depth", "gauge", {}, self.last_depth),
                ("khipu_reorg_orphaned_blocks_total", "counter", {},
                 self.orphaned_blocks),
                ("khipu_reorg_recycled_txs_total", "counter", {},
                 self.recycled_txs),
            ]

    def add_listener(self, fn: Callable) -> None:
        """Register ``fn(ancestor_number, removed_hits)`` to run at
        finalize (after the chain is switched, before control returns
        to the import loop)."""
        self._listeners.append(fn)

    # -------------------------------------------------------------- switch

    def switch(self, ancestor_number: int, blocks: List[Block],
               import_fn: Optional[Callable[[Block], None]] = None) -> int:
        """Atomically replace (ancestor, best] with ``blocks``.

        The caller has already decided the branch wins (TD rule) and
        validated its headers; the caller holds whatever lock excludes
        concurrent imports. ``import_fn`` overrides the per-block
        import (regular_sync passes its node-healing wrapper).
        Returns the number of adopted blocks."""
        bc = self.blockchain
        best = bc.best_block_number
        depth = best - ancestor_number
        max_depth = self.config.db.unconfirmed_depth
        if depth > max_depth:
            with self._lock:
                self.refused += 1
            raise ReorgTooDeep(
                f"reorg depth {depth} exceeds unconfirmed_depth "
                f"{max_depth}: refusing to walk off the pruned ring"
            )
        blocks = list(blocks)
        if not blocks or blocks[0].header.number != ancestor_number + 1:
            raise ValueError("adopted branch must start at ancestor+1")
        anc_header = bc.get_header_by_number(ancestor_number)
        if (anc_header is None
                or anc_header.hash != blocks[0].header.parent_hash):
            raise ValueError(
                "adopted branch does not attach to the ancestor"
            )

        with span("reorg.switch", ancestor=ancestor_number, depth=depth,
                  adopted=len(blocks)):
            self._fence(ancestor_number)
            with span("reorg.regenerate", ancestor=ancestor_number):
                self.regenerated_blocks = self._ensure_ancestor_state(
                    ancestor_number)
            old_blocks = self._collect_old(ancestor_number, best)
            # orphaned log hits and orphaned-only txs BEFORE removal,
            # while bodies/receipts are still readable; the hits go to
            # listeners at finalize (built only when one is registered),
            # the txs ride in the intent record so a mid-switch death
            # can still recycle them
            removed_hits = (self._removed_hits(old_blocks)
                            if self._listeners else [])
            orphans = self._orphan_txs(old_blocks, blocks)
            if JOURNEY.enabled:
                # every tx on the losing branch gets its retraction page
                # (PINNED — tail retention outlives the ring);
                # re-inclusion is stamped at finalize once the branch
                # actually won
                for b in old_blocks:
                    for stx in b.body.transactions:
                        JOURNEY.record(stx.hash, "reorg.retract",
                                       ancestor=ancestor_number,
                                       block=b.header.number)

            journal = bc.storages.window_journal
            fault_point("reorg.intent")
            seq = journal.log_reorg_intent(
                ancestor_number, anc_header.hash,
                [b.hash for b in old_blocks], blocks,
                orphan_txs=orphans,
            )
            try:
                with span("reorg.rollback", blocks=len(old_blocks)):
                    self._rollback(ancestor_number, old_blocks)
                with span("reorg.adopt", blocks=len(blocks)):
                    self._adopt(blocks, import_fn)
                fault_point("reorg.finalize")
            except Exception:
                # a LOCAL failure mid-switch (InjectedDeath is a
                # BaseException and falls through raw, like SIGKILL):
                # the intent is durable, so settle the torn switch the
                # same way a restart would — the node lands at exactly
                # the old chain or the new one — then surface the error
                from khipu_tpu_torch.sync.journal import recover

                recover(bc, log=self.log, config=self.config,
                        txpool=self.txpool, device=self.driver.device)
                raise
            journal.log_commit(seq)
            journal.prune()
            self._finalize(ancestor_number, old_blocks, orphans,
                           blocks, removed_hits)
        return len(blocks)

    # -------------------------------------------------------------- phases

    def _fence(self, ancestor_number: int) -> None:
        """Nothing above the ancestor stays visible to readers or
        half-owned by a background stage."""
        if self.read_view is not None:
            self.read_view.invalidate_above(ancestor_number)
        s = self.blockchain.storages
        journal = s.window_journal
        journal.prune()
        if journal.pending():
            # in-flight windows left by a dead/aborted collector:
            # settle them through the standard recovery pass (which
            # also detaches the volatile device mirror)
            from khipu_tpu_torch.sync.journal import recover

            recover(self.blockchain, log=self.log, config=self.config,
                    device=self.driver.device)
        else:
            # committed windows have rekeyed their aliases; anything
            # still alias-keyed belongs to a window that will never
            # publish — forget those rows rather than let a stale
            # placeholder satisfy a read-through
            mirror = s.account_node_storage.mirror
            if mirror is not None:
                aliases = mirror.alias_keys()
                if aliases:
                    mirror.drop_aliases(aliases)

    def _ensure_ancestor_state(self, ancestor_number: int) -> int:
        """A chain committed in windows stores each window's last state
        only: an ancestor inside a window has its header and body but no
        state, and neither the adoption nor a recovery's roll-forward
        could execute from it (the JAX package's switch fails there
        after removing the old blocks). Rebuild it before the intent:
        re-execute the canonical blocks from the nearest one whose state
        root is stored, persisting each state (content-addressed node
        puts; no block record or pointer changes). Returns the number of
        blocks re-executed."""
        from khipu_tpu_torch.ledger.ledger import execute_block

        bc = self.blockchain
        s = bc.storages

        def stored(n: int) -> bool:
            header = bc.get_header_by_number(n)
            return (header is not None and s.account_node_storage.get(
                header.state_root) is not None)

        n = ancestor_number
        while n > 0 and not stored(n):
            n -= 1
        hasher = self.driver.hasher
        for number in range(n + 1, ancestor_number + 1):
            block = bc.get_block_by_number(number)
            parent = bc.get_header_by_number(number - 1)
            result = execute_block(
                block, parent.state_root, bc.get_world_state, self.config,
                validate=True, hasher=hasher, device=self.driver.device,
            )
            root = result.world.persist(
                s.account_node_storage, s.storage_node_storage,
                s.evmcode_storage, hasher=hasher,
            )
            if root != block.header.state_root:
                raise ValueError(
                    f"rebuilt state of #{number} {root.hex()} != its "
                    f"header's {block.header.state_root.hex()}"
                )
        return ancestor_number - n

    def _collect_old(self, ancestor_number: int, best: int) -> List[Block]:
        out = []
        for n in range(ancestor_number + 1, best + 1):
            block = self.blockchain.get_block_by_number(n)
            if block is None:
                raise RuntimeError(
                    f"canonical chain has no block at #{n} below best "
                    f"#{best}: refusing to reorg across a hole"
                )
            out.append(block)
        return out

    def _removed_hits(self, old_blocks: List[Block]) -> list:
        """Every log in the orphaned blocks as a ``removed: true``
        LogHit (filter parity: clients un-apply state they derived
        from logs the reorg retracted)."""
        hits = []
        for block in old_blocks:
            receipts = self.blockchain.get_receipts(block.number)
            if receipts is None:
                continue
            log_index = 0
            for tx_index, receipt in enumerate(receipts):
                for log in receipt.logs:
                    hits.append(LogHit(
                        address=log.address,
                        topics=tuple(log.topics),
                        data=log.data,
                        block_number=block.number,
                        block_hash=block.hash,
                        tx_hash=block.body.transactions[tx_index].hash,
                        tx_index=tx_index,
                        log_index=log_index,
                        removed=True,
                    ))
                    log_index += 1
        return hits

    def _rollback(self, ancestor_number: int,
                  old_blocks: List[Block]) -> None:
        """Remove the old blocks tip-down. The walk is hash-exact
        (every block was just read from the canonical chain) and must
        reach the ancestor — a hole would strand best above it.

        The best pointer drops to the ancestor BEFORE any removal:
        concurrent readers resolve state through the best header, and
        the ancestor's is the one header guaranteed present throughout
        the rollback. (Recovery reads the intent record, not the best
        pointer, to find the torn span — moving best first costs it
        nothing.)"""
        bc = self.blockchain
        bc.storages.app_state.best_block_number = ancestor_number
        for block in reversed(old_blocks):
            fault_point("reorg.rollback")
            bc.remove_block(block.hash)
            if bc.get_header_by_number(block.number) is not None:
                raise RuntimeError(
                    f"rollback failed to remove block #{block.number}"
                )

    def _adopt(self, blocks: List[Block],
               import_fn: Optional[Callable[[Block], None]]) -> None:
        """Import the branch through the validated live-sync paths: a
        long branch takes the windowed pipeline (the journal interleaves
        its window intents after the reorg intent — recovery settles
        them in seq order), the rest goes per-block."""
        bc = self.blockchain
        window = self.config.sync.commit_window_blocks
        done = 0
        if window > 1 and len(blocks) >= window:
            fault_point("reorg.adopt")
            before = bc.best_block_number
            self.driver.replay_windowed(iter(blocks), window)
            done = bc.best_block_number - before
        from khipu_tpu_torch.sync.replay import PHASES, ReplayStats

        stats = ReplayStats(phases={k: 0.0 for k in PHASES})
        for block in blocks[done:]:
            fault_point("reorg.adopt")
            if import_fn is not None:
                import_fn(block)
            else:
                self.driver._execute_and_insert(block, stats)

    def _orphan_txs(self, old_blocks: List[Block],
                    adopted: List[Block]) -> list:
        """Txs mined ONLY on the losing branch, senders recovered —
        the recycling candidates."""
        from khipu_tpu_torch.domain.transaction import recover_senders

        adopted_tx_hashes = {
            tx.hash for b in adopted for tx in b.body.transactions
        }
        orphans = [
            tx for b in old_blocks for tx in b.body.transactions
            if tx.hash not in adopted_tx_hashes
        ]
        recover_senders(orphans)
        return orphans

    def _finalize(self, ancestor_number: int, old_blocks: List[Block],
                  orphans: list, adopted: List[Block],
                  removed_hits: list) -> None:
        recycled = 0
        if JOURNEY.enabled:
            # re-inclusion pages: a retracted tx that was mined again on
            # the winning branch closes the retract->reinclude arc
            retracted = {
                stx.hash for b in old_blocks
                for stx in b.body.transactions
            }
            for b in adopted:
                for stx in b.body.transactions:
                    if stx.hash in retracted:
                        JOURNEY.record(stx.hash, "reorg.reinclude",
                                       via="mined",
                                       block=b.header.number)
        if self.txpool is not None:
            for b in adopted:
                # adopted-branch txs leave the pool, same as every
                # other import path
                self.txpool.remove_mined(b.body.transactions)
            # orphan recycling: txs mined only on the losing branch
            # re-enter through the pool's standard replacement rules —
            # a pooled same-(sender,nonce) tx with a higher gas price
            # keeps its slot
            for stx in orphans:
                if stx.sender is None:
                    continue
                try:
                    if self.txpool.add(stx):
                        recycled += 1
                        if JOURNEY.enabled:
                            # pool residence IS the re-inclusion state
                            # for orphaned-only txs (awaiting re-mining)
                            JOURNEY.record(stx.hash, "reorg.reinclude",
                                           via="pool")
                except ValueError:
                    pass
        for fn in list(self._listeners):
            try:
                fn(ancestor_number, removed_hits)
            except Exception as e:  # a broken observer can't undo a switch
                self.log(f"reorg listener failed: {e}")
        with self._lock:
            self.switches += 1
            self.last_depth = len(old_blocks)
            self.orphaned_blocks += len(old_blocks)
            self.recycled_txs += recycled
        self.log(
            f"reorg: ancestor #{ancestor_number}, orphaned "
            f"{len(old_blocks)} blocks, adopted {len(adopted)}, "
            f"recycled {recycled} txs"
        )
