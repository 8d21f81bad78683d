"""Fast-sync orchestration: pivot choice + multi-peer download scheduler.

Parity: blockchain/sync/FastSyncService.scala —
  pivot selection: ask every handshaked peer for its best header, take
  the MEDIAN best number minus ``pivot_block_offset`` (requires
  ``min_peers_to_choose_pivot`` peers)                    :184-273
  download scheduler: bounded-concurrency node requests spread across
  the peer pool; a stalling/failing peer is blacklisted and its
  work is redistributed                                   :537-667
  block-data backfill to the pivot (headers/bodies/receipts stored
  WITHOUT execution — the state arrives as the downloaded trie)

The queue/verify/persist half lives in sync/fast_sync.py (StateSyncer);
this module supplies its ``fetch`` callback from real peers and drives
the whole flow end to end.

The port's copy of ``khipu_tpu.sync.fast_sync_service``. ``device=None``
means the card: the StateSyncer's content check of every received batch
runs the batched sponge there (K1r).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Mapping, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.block import BlockBody
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.domain.receipt import Receipt, encode_receipts
from khipu_tpu_torch.network.messages import (
    BLOCK_BODIES,
    BLOCK_HEADERS,
    ETH_OFFSET,
    GET_BLOCK_BODIES,
    GET_BLOCK_HEADERS,
    GET_NODE_DATA,
    GET_RECEIPTS,
    NODE_DATA,
    RECEIPTS,
    GetBlockHeaders,
    decode_bodies,
    decode_headers,
)
from khipu_tpu_torch.network.peer import Peer, PeerError, PeerManager
from khipu_tpu_torch.sync.fast_sync import FastSyncStateStorage, StateSyncer, SyncState
from khipu_tpu_torch.validators.roots import (
    ommers_hash,
    receipts_root,
    transactions_root,
)


class FastSyncError(Exception):
    pass


class PeerFetchPool:
    """Spread node-data requests across live peers with bounded
    concurrency; timeout -> blacklist + redistribute
    (processDownload:537-667 role)."""

    def __init__(
        self,
        manager: PeerManager,
        nodes_per_request: int = 50,
        timeout: float = 5.0,
        max_rounds: int = 5,
        log: Optional[Callable[[str], None]] = None,
        cluster=None,
    ):
        self.manager = manager
        self.per_request = nodes_per_request
        self.timeout = timeout
        self.max_rounds = max_rounds
        self.log = log or (lambda s: None)
        self.blacklisted = 0
        self._rr = 0  # rotating start so small fetches still spread
        # sharded node-cache cluster: consulted before the peer pool —
        # a shard read is one verified RPC vs. a devp2p round-trip, and
        # the client's replica failover/breakers absorb dead shards
        self.cluster = cluster
        self.cluster_served = 0

    def _live_peers(self) -> List[Peer]:
        return [
            p for p in self.manager.peers
            if p.alive
            and not self.manager.blacklist.is_blacklisted(p.remote_pub)
        ]

    def fetch_nodes(self, hashes: List[bytes]) -> Mapping[bytes, bytes]:
        """StateSyncer fetch callback: every returned value is keyed by
        its CONTENT hash (NodeData replies carry no correlation)."""
        results: Dict[bytes, bytes] = {}
        pending = list(hashes)
        if self.cluster is not None and pending:
            try:
                got = self.cluster.fetch(pending)
            except Exception:
                got = {}
            results.update(got)  # values verified by the client
            self.cluster_served += len(got)
            pending = [h for h in pending if h not in results]
        for _ in range(self.max_rounds):
            if not pending:
                break
            peers = self._live_peers()
            if not peers:
                raise FastSyncError("no live peers for node download")
            start = self._rr % len(peers)
            self._rr += 1
            peers = peers[start:] + peers[:start]
            chunks = [
                pending[i : i + self.per_request]
                for i in range(0, len(pending), self.per_request)
            ]
            lock = threading.Lock()
            got_any = [False]

            def worker(peer: Peer, mine: List[List[bytes]]) -> None:
                for chunk in mine:
                    try:
                        body = peer.request(
                            ETH_OFFSET + GET_NODE_DATA,
                            list(chunk),
                            ETH_OFFSET + NODE_DATA,
                            timeout=self.timeout,
                        )
                    except PeerError:
                        # stalling / dead peer: blacklist, abandon its
                        # remaining chunks (requeued by the outer round)
                        self.manager.blacklist.add(
                            peer.remote_pub, duration=600.0
                        )
                        peer.disconnect()
                        self.blacklisted += 1
                        self.log(
                            "blacklisted stalling peer "
                            f"{peer.remote_pub[:4].hex()}"
                        )
                        return
                    with lock:
                        for blob in body:
                            results[keccak256(bytes(blob))] = bytes(blob)
                            got_any[0] = True

            # round-robin chunk assignment across the live pool
            assign: Dict[int, List[List[bytes]]] = {
                i: [] for i in range(len(peers))
            }
            for i, chunk in enumerate(chunks):
                assign[i % len(peers)].append(chunk)
            threads = [
                threading.Thread(
                    target=worker, args=(peers[i], assign[i]), daemon=True
                )
                for i in range(len(peers))
                if assign[i]
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            pending = [h for h in pending if h not in results]
            if pending and not got_any[0] and not self._live_peers():
                break
        return results


class FastSyncService:
    """choose pivot -> download state via the peer pool -> backfill
    block data -> hand off at the pivot."""

    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        manager: PeerManager,
        hasher=None,
        log: Optional[Callable[[str], None]] = None,
        cluster=None,
        device=None,
    ):
        # device=None means the card (raises without one)
        self.device = resolve_device(device)
        self.blockchain = blockchain
        self.config = config
        self.manager = manager
        self.hasher = hasher
        self.log = log or (lambda s: None)
        sync = config.sync
        self.min_peers = sync.min_peers_to_choose_pivot
        self.pivot_offset = sync.pivot_block_offset
        self.pool = PeerFetchPool(
            manager,
            nodes_per_request=sync.nodes_per_request,
            timeout=sync.peer_request_timeout,
            log=self.log,
            cluster=cluster,
        )

    # -------------------------------------------------------------- pivot

    def _best_header_of(self, peer: Peer) -> Optional[BlockHeader]:
        try:
            body = peer.request(
                ETH_OFFSET + GET_BLOCK_HEADERS,
                GetBlockHeaders(peer.status.best_hash, 1).body(),
                ETH_OFFSET + BLOCK_HEADERS,
                timeout=self.pool.timeout,
            )
            headers = decode_headers(body)
            return headers[0] if headers else None
        except PeerError:
            return None

    def choose_pivot(self) -> BlockHeader:
        """Median best number over >= min_peers peers, minus the offset
        (FastSyncService.scala:184-273)."""
        peers = [p for p in self.pool._live_peers() if p.status is not None]
        if len(peers) < self.min_peers:
            raise FastSyncError(
                f"need {self.min_peers} peers to choose a pivot, "
                f"have {len(peers)}"
            )
        bests: List[int] = []
        for p in peers:
            h = self._best_header_of(p)
            if h is not None:
                bests.append(h.number)
        if len(bests) < self.min_peers:
            raise FastSyncError(
                f"only {len(bests)}/{self.min_peers} peers answered the "
                "pivot probe"
            )
        bests.sort()
        median = bests[len(bests) // 2]
        pivot_number = max(1, median - self.pivot_offset)
        header = self._fetch_header_by_number(pivot_number)
        if header is None:
            raise FastSyncError(f"no peer served pivot header {pivot_number}")
        self.log(
            f"pivot = #{pivot_number} (median best {median} - "
            f"{self.pivot_offset}), root {header.state_root.hex()[:16]}"
        )
        return header

    def _fetch_header_by_number(self, n: int) -> Optional[BlockHeader]:
        for peer in self.pool._live_peers():
            try:
                body = peer.request(
                    ETH_OFFSET + GET_BLOCK_HEADERS,
                    GetBlockHeaders(n, 1).body(),
                    ETH_OFFSET + BLOCK_HEADERS,
                    timeout=self.pool.timeout,
                )
                headers = decode_headers(body)
                if headers and headers[0].number == n:
                    return headers[0]
            except PeerError:
                continue
        return None

    # ----------------------------------------------------------- backfill

    def _backfill_blocks(self, pivot: BlockHeader) -> None:
        """Headers/bodies/receipts genesis..pivot, stored WITHOUT
        execution (the state trie arrived separately); every link is
        validated: parent hashes, tx/ommers roots, receipts roots."""
        s = self.blockchain.storages
        expected_parent = self.blockchain.get_hash_by_number(0)
        td = self.blockchain.get_total_difficulty(0) or 0
        n = 1
        batch = 20
        while n <= pivot.number:
            count = min(batch, pivot.number - n + 1)
            headers = self._headers_range(n, count)
            hashes = [h.hash for h in headers]
            bodies = self._bodies_of(hashes)
            receipts = self._receipts_of(hashes)
            for h, body, rcpts in zip(headers, bodies, receipts):
                if h.parent_hash != expected_parent:
                    raise FastSyncError(
                        f"backfill: broken parent link at #{h.number}"
                    )
                if transactions_root(body.transactions) != h.transactions_root:
                    raise FastSyncError(f"backfill: bad txRoot at #{h.number}")
                if ommers_hash(body.ommers) != h.ommers_hash:
                    raise FastSyncError(
                        f"backfill: bad ommersHash at #{h.number}"
                    )
                if receipts_root(rcpts) != h.receipts_root:
                    raise FastSyncError(
                        f"backfill: bad receiptsRoot at #{h.number}"
                    )
                td += h.difficulty
                s.block_header_storage.put(h.number, h.encode())
                s.block_body_storage.put(h.number, body.encode())
                s.receipts_storage.put(h.number, encode_receipts(rcpts))
                s.total_difficulty_storage.put_td(h.number, td)
                s.block_numbers.put(h.hash, h.number)
                for i, tx in enumerate(body.transactions):
                    s.transaction_storage.put(tx.hash, h.number, i)
                expected_parent = h.hash
            n += count
        s.app_state.best_block_number = pivot.number

    def _headers_range(self, start: int, count: int) -> List[BlockHeader]:
        for peer in self.pool._live_peers():
            try:
                body = peer.request(
                    ETH_OFFSET + GET_BLOCK_HEADERS,
                    GetBlockHeaders(start, count).body(),
                    ETH_OFFSET + BLOCK_HEADERS,
                    timeout=self.pool.timeout,
                )
                headers = decode_headers(body)
                if len(headers) == count:
                    return headers
            except PeerError:
                continue
        raise FastSyncError(f"no peer served headers [{start}..+{count})")

    def _bodies_of(self, hashes: List[bytes]) -> List[BlockBody]:
        # EXACT counts only: replies carry no correlation and servers
        # skip unknown hashes, so a short reply would silently shift
        # every later header/body pair — try the next peer instead
        out: List[BlockBody] = []
        want = list(hashes)
        while want:
            chunk = want[:20]
            served = False
            for peer in self.pool._live_peers():
                try:
                    body = peer.request(
                        ETH_OFFSET + GET_BLOCK_BODIES,
                        chunk,
                        ETH_OFFSET + BLOCK_BODIES,
                        timeout=self.pool.timeout,
                    )
                except PeerError:
                    continue
                got = decode_bodies(body)
                if len(got) == len(chunk):
                    out.extend(got)
                    want = want[len(chunk) :]
                    served = True
                    break
            if not served:
                raise FastSyncError("no peer served the full body chunk")
        return out

    def _receipts_of(self, hashes: List[bytes]) -> List[List[Receipt]]:
        from khipu_tpu_torch.domain.receipt import decode_receipts
        from khipu_tpu_torch.base.rlp import rlp_encode

        out: List[List[Receipt]] = []
        want = list(hashes)
        while want:
            chunk = want[:5]
            served = False
            for peer in self.pool._live_peers():
                try:
                    body = peer.request(
                        ETH_OFFSET + GET_RECEIPTS,
                        chunk,
                        ETH_OFFSET + RECEIPTS,
                        timeout=self.pool.timeout,
                    )
                except PeerError:
                    continue
                if len(body) == len(chunk):
                    out.extend(
                        decode_receipts(rlp_encode(item)) for item in body
                    )
                    want = want[len(chunk) :]
                    served = True
                    break
            if not served:
                raise FastSyncError("no peer served the full receipt chunk")
        return out

    # ------------------------------------------------------------- driver

    def run(self) -> SyncState:
        """Full fast sync: pivot -> state download -> block backfill.
        After this, regular sync takes over from the pivot."""
        pivot = self.choose_pivot()
        syncer = StateSyncer(
            self.blockchain.storages,
            FastSyncStateStorage(self.blockchain.storages.app_state.source),
            self.pool.fetch_nodes,
            batch_size=self.config.sync.nodes_per_request,
            hasher=self.hasher,
            device=self.device,
        )
        state = syncer.start(pivot.state_root)
        self.log(
            f"state download complete: {state.downloaded_nodes} nodes "
            f"({self.pool.blacklisted} peers blacklisted)"
        )
        self._backfill_blocks(pivot)
        self.log(f"backfilled block data to pivot #{pivot.number}")
        return state
