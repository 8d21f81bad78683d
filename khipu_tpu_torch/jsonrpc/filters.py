"""Log/block filters + eth_getLogs.

Parity: jsonrpc/FilterManager.scala:86 (log/block/pendingTx filters
with polling) and EthService.getLogs. Queries use each block's header
bloom as a pre-filter (ledger/BloomFilter role) before touching its
receipts — the same pruning real nodes rely on.

The port's copy of ``khipu_tpu.jsonrpc.filters``. ``LogHit`` lives here:
``sync/reorg.py`` builds its retractions from it for ``note_reorg``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from khipu_tpu_torch.domain.block import BlockBody
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.ledger.bloom import bloom_contains
from khipu_tpu_torch.observability.registry import REGISTRY


@dataclass
class LogQuery:
    from_block: int
    # None = moving head ("latest"): resolved at each evaluation, so an
    # installed filter keeps following the chain tip
    to_block: Optional[int]
    addresses: Sequence[bytes] = ()  # empty = any
    # topics[i] = tuple of alternatives for position i; empty tuple = any
    topics: Sequence[Sequence[bytes]] = ()


@dataclass
class LogHit:
    address: bytes
    topics: tuple
    data: bytes
    block_number: int
    block_hash: bytes
    tx_hash: bytes
    tx_index: int
    log_index: int
    # True on entries retracting a previously-delivered log whose
    # block a reorg orphaned (eth_getFilterChanges parity: clients
    # un-apply, then receive the adopted branch's logs fresh)
    removed: bool = False


def _matches(log, query: LogQuery) -> bool:
    if query.addresses and log.address not in query.addresses:
        return False
    for i, alternatives in enumerate(query.topics):
        if not alternatives:
            continue
        if i >= len(log.topics) or log.topics[i] not in alternatives:
            return False
    return True


def _bloom_may_match(bloom: bytes, query: LogQuery) -> bool:
    if query.addresses and not any(
        bloom_contains(bloom, a) for a in query.addresses
    ):
        return False
    for alternatives in query.topics:
        if alternatives and not any(
            bloom_contains(bloom, t) for t in alternatives
        ):
            return False
    return True


def get_logs(blockchain: Blockchain, query: LogQuery) -> List[LogHit]:
    hits: List[LogHit] = []
    to_block = (
        query.to_block
        if query.to_block is not None
        else blockchain.best_block_number
    )
    for number in range(query.from_block, to_block + 1):
        header = blockchain.get_header_by_number(number)
        if header is None:
            continue
        if not _bloom_may_match(header.logs_bloom, query):
            continue  # bloom prunes the receipt read entirely
        receipts = blockchain.get_receipts(number)
        if receipts is None:
            continue
        body = None  # fetched lazily: only blocks with a HIT pay it
        log_index = 0
        skip_block = False
        block_hits: List[LogHit] = []  # buffered: all-or-nothing per block
        for tx_index, receipt in enumerate(receipts):
            if skip_block:
                break
            for log in receipt.logs:
                if _matches(log, query):
                    if body is None:
                        raw = blockchain.storages.block_body_storage.get(
                            number
                        )
                        if raw is None:
                            # receipts without a body (partial store /
                            # mid-reorg): skip the whole block rather
                            # than index into an empty tx list
                            skip_block = True
                            break
                        body = BlockBody.decode(raw)
                    if tx_index >= len(body.transactions):
                        skip_block = True
                        break
                    block_hits.append(
                        LogHit(
                            address=log.address,
                            topics=tuple(log.topics),
                            data=log.data,
                            block_number=number,
                            block_hash=header.hash,
                            tx_hash=body.transactions[tx_index].hash,
                            tx_index=tx_index,
                            log_index=log_index,
                        )
                    )
                log_index += 1
        if not skip_block:
            hits.extend(block_hits)
    return hits


class FilterManager:
    """Installed filters with poll semantics (eth_newFilter /
    eth_getFilterChanges / eth_uninstallFilter).

    Filters a client stops polling are EVICTED after ``ttl`` seconds
    (geth's 5-minute filter deadline): every installed filter holds
    server-side state — a log filter's cursor pins incremental scans,
    a pending-tx filter's cursor pins the pool's arrival journal — so
    an abandoned one is a slow leak an open endpoint accumulates
    forever. The sweep is lazy (piggybacked on install/poll under the
    manager lock): no timer thread, and a filter polled within its TTL
    is never touched."""

    def __init__(self, blockchain: Blockchain, ttl: float = 300.0):
        self.blockchain = blockchain
        self.ttl = ttl
        self._ids = itertools.count(1)
        self._filters = {}
        self._last_poll = {}  # fid -> monotonic time of last touch
        # fid -> queued ``removed: true`` retractions a reorg produced
        # for logs this filter already delivered (drained by changes())
        self._removed = {}
        self._lock = threading.Lock()
        self.evictions = 0
        self.reorgs_seen = 0
        REGISTRY.register_collector("filters", self._registry_samples)

    def _registry_samples(self) -> list:
        with self._lock:
            active = len(self._filters)
            evicted = self.evictions
        return [
            ("khipu_filters_active", "gauge", {}, active),
            ("khipu_filter_evictions_total", "counter", {}, evicted),
        ]

    def _now(self) -> float:
        return time.monotonic()

    def _sweep(self) -> None:
        """Evict TTL-expired filters (caller holds the lock)."""
        deadline = self._now() - self.ttl
        for fid in [
            f for f, t in self._last_poll.items() if t < deadline
        ]:
            self._filters.pop(fid, None)
            self._last_poll.pop(fid, None)
            self._removed.pop(fid, None)
            self.evictions += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "active": len(self._filters),
                "evictions": self.evictions,
                "ttlSeconds": self.ttl,
            }

    def new_log_filter(self, query: LogQuery) -> int:
        with self._lock:
            self._sweep()
            fid = next(self._ids)
            # first poll catches up from the query's fromBlock (geth
            # semantics); later polls return only the delta
            self._filters[fid] = ("logs", query, query.from_block - 1)
            self._last_poll[fid] = self._now()
            return fid

    def new_block_filter(self) -> int:
        with self._lock:
            self._sweep()
            fid = next(self._ids)
            self._filters[fid] = (
                "blocks", None, self.blockchain.best_block_number
            )
            self._last_poll[fid] = self._now()
            return fid

    def new_pending_tx_filter(self, tx_pool) -> int:
        """Reports hashes of txs that ENTERED the pool since last poll
        — read from the pool's arrival journal, so a tx that enters and
        is mined/evicted between polls is still reported."""
        with self._lock:
            self._sweep()
            fid = next(self._ids)
            self._filters[fid] = ("pending", tx_pool, tx_pool.cursor())
            self._last_poll[fid] = self._now()
            return fid

    def get_log_query(self, fid: int):
        """The installed log filter's query, or None (locked access —
        eth_getFilterLogs must not poke at internals)."""
        with self._lock:
            entry = self._filters.get(fid)
            if entry is not None:
                self._last_poll[fid] = self._now()  # a poll, TTL-wise
        if entry is None or entry[0] != "logs":
            return None
        return entry[1]

    def uninstall(self, fid: int) -> bool:
        with self._lock:
            self._last_poll.pop(fid, None)
            self._removed.pop(fid, None)
            return self._filters.pop(fid, None) is not None

    def note_reorg(self, ancestor_number: int,
                   removed_hits: Sequence[LogHit]) -> None:
        """A reorg orphaned every block above ``ancestor_number``
        (ReorgManager listener — sync/reorg.py). Per installed filter:
        queue ``removed: true`` retractions for logs it already
        delivered, then rewind its cursor to the fork point so the
        adopted branch's results deliver fresh on the next poll.
        Filters whose cursor never crossed the fork are untouched."""
        with self._lock:
            self.reorgs_seen += 1
            for fid, entry in list(self._filters.items()):
                kind, query, last_seen = entry
                if kind == "pending" or last_seen <= ancestor_number:
                    continue  # never delivered anything above the fork
                if kind == "blocks":
                    self._filters[fid] = (kind, query, ancestor_number)
                    continue
                mine = [
                    h for h in removed_hits
                    if query.from_block <= h.block_number <= last_seen
                    and (query.to_block is None
                         or h.block_number <= query.to_block)
                    and _matches(h, query)
                ]
                if mine:
                    self._removed.setdefault(fid, []).extend(mine)
                self._filters[fid] = (
                    kind, query,
                    max(ancestor_number, query.from_block - 1),
                )

    # one poll never scans more than this many blocks; the cursor
    # advances by at most the same amount, so a huge catch-up range is
    # paid down incrementally instead of in one unbounded scan
    MAX_BLOCKS_PER_POLL = 10_000

    def changes(self, fid: int):
        """New results since the last poll."""
        with self._lock:
            # the whole read-advance is atomic under the manager lock:
            # concurrent polls of one filter must neither double-deliver
            # nor rewind the cursor (the pool lock nests inside and
            # nothing takes them in the reverse order)
            self._sweep()
            entry = self._filters.get(fid)
            if entry is None:
                return None
            self._last_poll[fid] = self._now()
            kind, query, last_seen = entry
            if kind == "pending":
                tx_pool = query
                new_hashes, new_cursor = tx_pool.arrivals_since(last_seen)
                self._filters[fid] = ("pending", tx_pool, new_cursor)
                return new_hashes
            best = self.blockchain.best_block_number
            horizon = min(best, last_seen + self.MAX_BLOCKS_PER_POLL)
            if kind == "blocks":
                # a header can vanish mid-scan (reorg shortened the
                # chain after the best_block_number read): stop at the
                # last contiguous header so the cursor never skips past
                # blocks that were never delivered
                out = []
                n = last_seen + 1
                while n <= horizon:
                    header = self.blockchain.get_header_by_number(n)
                    if header is None:
                        break
                    out.append(header.hash)
                    n += 1
                horizon = n - 1
            else:
                upper = (
                    query.to_block if query.to_block is not None else best
                )
                window = dataclasses.replace(
                    query,
                    from_block=max(query.from_block, last_seen + 1),
                    to_block=min(upper, horizon),
                )
                out = (
                    get_logs(self.blockchain, window)
                    if window.from_block <= window.to_block
                    else []
                )
                # retractions first: a client un-applies the orphaned
                # logs before applying the adopted branch's
                out = self._removed.pop(fid, []) + out
            self._filters[fid] = (kind, query, horizon)
            return out
