"""Pending transaction pool.

Parity: transactions/PendingTransactionsService.scala:66 — capacity-
bounded (tx-pool-size = 1000) pending set keyed by tx hash; mined txs
are removed as blocks are saved (RegularSyncService.scala:419); oldest
entries evicted at capacity. Also the ommers pool counterpart
(ommers/OmmersPool.scala:19, size 30).

The port's copy of ``khipu_tpu.txpool``, with the transaction
passport's stamps (``pool.admit``, ``pool.evict``, ``pool.reject``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional

from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY


class PendingTransactionsPool:
    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        # insertion order IS the eviction order (oldest first)
        self._txs: "OrderedDict[bytes, SignedTransaction]" = OrderedDict()
        # (sender, nonce) -> tx hash: the replacement index — at most
        # ONE pooled tx per account slot (geth's price-bump rule,
        # tx_pool.go: a same-nonce resubmission must outbid the pooled
        # one or it is rejected as underpriced)
        self._by_sender_nonce = {}
        # monotonic arrival journal: pending-tx filters read deltas from
        # it, so a tx that enters AND leaves between polls still reports
        self._arrivals: List[bytes] = []
        self._arrival_base = 0  # journal offset after trims
        self._lock = threading.Lock()
        self.evictions = 0  # capacity evictions (oldest-first)
        self.replacements = 0  # same-slot higher-price replacements
        self.rejected_underpriced = 0  # same-slot non-outbidding adds
        REGISTRY.register_collector("txpool", self._registry_samples)

    def _registry_samples(self) -> list:
        with self._lock:
            return [
                ("khipu_txpool_size", "gauge", {}, len(self._txs)),
                ("khipu_txpool_capacity", "gauge", {}, self.capacity),
                ("khipu_txpool_evictions_total", "counter", {},
                 self.evictions),
                ("khipu_txpool_replacements_total", "counter", {},
                 self.replacements),
                ("khipu_txpool_rejected_underpriced_total", "counter",
                 {}, self.rejected_underpriced),
            ]

    def _drop(self, tx_hash: bytes) -> None:
        """Remove one entry + its slot index (caller holds the lock)."""
        stx = self._txs.pop(tx_hash, None)
        if stx is None:
            return
        slot = (stx.sender, stx.tx.nonce)
        if self._by_sender_nonce.get(slot) == tx_hash:
            del self._by_sender_nonce[slot]

    def add(self, stx: SignedTransaction) -> bool:
        """Add a signature-valid tx; returns False for duplicates and
        for same-sender same-nonce resubmissions that do not outbid
        the pooled tx's gas price (a strictly higher bid REPLACES it —
        geth's replacement rule, so a stuck tx can be repriced).
        Oldest entries are evicted at capacity."""
        if stx.sender is None:
            raise ValueError("unrecoverable signature")
        with self._lock:
            if stx.hash in self._txs:
                return False
            slot = (stx.sender, stx.tx.nonce)
            pooled_hash = self._by_sender_nonce.get(slot)
            replaced = False
            if pooled_hash is not None:
                pooled = self._txs[pooled_hash]
                if stx.tx.gas_price <= pooled.tx.gas_price:
                    self.rejected_underpriced += 1
                    if JOURNEY.enabled:
                        JOURNEY.record(stx.hash, "pool.reject",
                                       reason="underpriced")
                    return False
                del self._txs[pooled_hash]  # outbid: replace in place
                del self._by_sender_nonce[slot]
                self.replacements += 1
                replaced = True
                if JOURNEY.enabled:
                    JOURNEY.record(pooled_hash, "pool.evict",
                                   reason="replaced")
            while len(self._txs) >= self.capacity:
                oldest_hash, oldest = self._txs.popitem(last=False)
                oslot = (oldest.sender, oldest.tx.nonce)
                if self._by_sender_nonce.get(oslot) == oldest_hash:
                    del self._by_sender_nonce[oslot]
                self.evictions += 1
                if JOURNEY.enabled:
                    JOURNEY.record(oldest_hash, "pool.evict",
                                   reason="capacity")
            self._txs[stx.hash] = stx
            self._by_sender_nonce[slot] = stx.hash
            if JOURNEY.enabled:
                JOURNEY.record(stx.hash, "pool.admit", replaced=replaced)
            self._arrivals.append(stx.hash)
            # bound the journal: keep the most recent 4x capacity
            if len(self._arrivals) > 4 * self.capacity:
                trim = 2 * self.capacity
                del self._arrivals[:trim]
                self._arrival_base += trim
            return True

    def cursor(self) -> int:
        """Current end of the arrival journal (install point for
        pending-tx filters)."""
        with self._lock:
            return self._arrival_base + len(self._arrivals)

    def arrivals_since(self, cursor: int):
        """(new_hashes, new_cursor); cursors older than the retained
        journal yield what remains (bounded retention)."""
        with self._lock:
            start = max(cursor - self._arrival_base, 0)
            return (
                list(self._arrivals[start:]),
                self._arrival_base + len(self._arrivals),
            )

    def get(self, tx_hash: bytes) -> Optional[SignedTransaction]:
        with self._lock:
            return self._txs.get(tx_hash)

    def pending(self) -> List[SignedTransaction]:
        with self._lock:
            return list(self._txs.values())

    def remove_mined(self, txs) -> int:
        """Drop txs included in a saved block (:419)."""
        removed = 0
        with self._lock:
            for stx in txs:
                if stx.hash in self._txs:
                    self._drop(stx.hash)
                    removed += 1
        return removed

    def __len__(self) -> int:
        return len(self._txs)


class OmmersPool:
    """Candidate ommer headers for mining (OmmersPool.scala:19)."""

    def __init__(self, capacity: int = 30):
        self.capacity = capacity
        self._headers: "OrderedDict[bytes, BlockHeader]" = OrderedDict()
        self._lock = threading.Lock()

    def add(self, header: BlockHeader) -> None:
        with self._lock:
            self._headers[header.hash] = header
            while len(self._headers) > self.capacity:
                self._headers.popitem(last=False)

    def candidates(self, for_number: int) -> List[BlockHeader]:
        """Ommers must be within 6 generations of the including block."""
        with self._lock:
            return [
                h
                for h in self._headers.values()
                if 0 < for_number - h.number <= 6
            ]
