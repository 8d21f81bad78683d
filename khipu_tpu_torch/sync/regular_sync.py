"""Live regular sync: tip-following block import over real peers.

Parity: blockchain/sync/RegularSyncService.scala —
  bestPeer selection by total difficulty        :448-479
  requestHeaders / requestBodies batch fetch    :103-170
  branch resolution with backward header fetch,
  TD-compared reorg                             :171-269, 336-345
  missing-node retry inside the import loop     (kesque self-heal role)

The Akka actor round (one message per state transition) becomes an
explicit ``sync_once()`` step — callers loop it (``run(until)``), tests
drive it deterministically. Execution and persistence reuse the replay
driver's validated import path (ReplayDriver._execute_and_insert), so a
live-synced block passes exactly the gates a replayed one does.

The port's copy of ``khipu_tpu.sync.regular_sync``. ``device=None``
means the card: the driver commits on the device (a full fetched batch
through the windowed pipeline, K5 and the device mirror; a single block
through the batched sponge, K1r). Nothing hides a device error: the
windowed import catches only the cases it has a per-block answer for,
and an error of the device path escapes ``sync_once`` and ``run`` —
also one raised by a pushed block's import on a peer's reader thread,
which is kept and raised by the next ``sync_once`` — so startup
recovery (``ReplayDriver.recover``) settles a torn window. With
``read_view=`` (the serving plane's ReadView) the windowed import
publishes into it, and every exception that leaves the import
invalidates it above best (the replay driver's abort path), so an RPC
reader never sees a window that did not become durable.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional

import torch

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.rlp import RLPError
from khipu_tpu_torch.base.secp256k1 import SignatureError
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.network.messages import (
    BLOCK_BODIES,
    BLOCK_HEADERS,
    ETH_OFFSET,
    GET_BLOCK_BODIES,
    GET_BLOCK_HEADERS,
    GET_NODE_DATA,
    NEW_BLOCK,
    NEW_BLOCK_HASHES,
    NODE_DATA,
    TRANSACTIONS,
    GetBlockHeaders,
    decode_bodies,
    decode_headers,
    decode_new_block,
    decode_new_block_hashes,
    decode_transactions,
    encode_new_block,
    encode_new_block_hashes,
    encode_transactions,
)
from khipu_tpu_torch.network.peer import Peer, PeerError, PeerManager
from khipu_tpu_torch.observability.trace import span
from khipu_tpu_torch.ledger.ledger import BlockExecutionError
from khipu_tpu_torch.sync.replay import (
    PHASES,
    CollectorDied,
    ReplayDriver,
    ReplayStats,
    WindowNeedsByzantium,
)
from khipu_tpu_torch.sync.reorg import ReorgManager, ReorgTooDeep
from khipu_tpu_torch.trie.mpt import MPTException, MPTNodeMissingException
from khipu_tpu_torch.validators.roots import ommers_hash, transactions_root
from khipu_tpu_torch.validators.validators import ValidationError


class SyncAborted(Exception):
    pass


# a block the import REFUSES (invalid header, body, execution or root, a
# state node it cannot reach, an undecodable payload): the peer's data
# is at fault, not this node. Any other error — a failed kernel launch,
# a wrapper refusing a tensor (ValueError), a sticky CUDA error, an
# injected fault at a device seam — is a local device-path failure and
# escapes the sync loop. A plain ValueError is never a refusal here: the
# one the windowed path raises for peer data has its own type
# (WindowNeedsByzantium, caught in _import_windowed)
_BLOCK_REFUSED = (
    ValidationError, BlockExecutionError, MPTException, RLPError,
    SignatureError, SyncAborted,
)


class RegularSyncService:
    """Pull loop: find the best-TD peer, fetch headers+bodies from our
    tip, import; resolve side branches by backward fetch + TD compare."""

    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        manager: PeerManager,
        batch_size: int = 10,
        request_timeout: float = 5.0,
        log: Optional[Callable[[str], None]] = None,
        txpool=None,
        cluster=None,
        read_view=None,
        device=None,
    ):
        self.blockchain = blockchain
        self.config = config
        self.manager = manager
        self.batch_size = batch_size
        self.timeout = request_timeout
        self.log = log or (lambda s: None)
        # device=None means the card: every import commits there
        self._driver = ReplayDriver(
            blockchain, config, device_commit=True, device=device,
            read_view=read_view,
        )
        self.device = self._driver.device
        # journaled atomic chain switch (sync/reorg.py): TD-winning
        # side branches route through it instead of the old
        # unjournaled block-at-a-time rewind
        self.reorg = ReorgManager(
            blockchain, config, driver=self._driver, txpool=txpool,
            read_view=read_view, log=log,
        )
        # serializes chain mutation between the pull loop and the
        # NewBlock push handler (which runs on peer reader threads)
        self._import_lock = threading.Lock()
        self.imported = 0
        self.reorgs = 0
        self.healed_nodes = 0
        # pending-tx pool: every successful import removes the block's
        # txs (RegularSyncService.scala:419); gossiped txs land here
        self.txpool = txpool
        # NewBlockHashes announces, drained by sync_once (fetching from
        # inside the announcing peer's reader thread would deadlock on
        # its own reply)
        self._announced: List[tuple] = []
        self._announce_lock = threading.Lock()
        # a device-path error from a pushed block's import on a reader
        # thread, raised by the next sync_once (never logged away)
        self._push_error: Optional[BaseException] = None
        # sharded node-cache cluster (cluster/client.py): when set, the
        # heal path asks the replica shards BEFORE burning a peer
        # round-trip — the DistributedNodeStorage read the reference
        # does first (SURVEY §5.3)
        self.cluster = cluster
        self.cluster_healed = 0

    def _on_device(self):
        """The driver's card as this thread's current device: a peer's
        reader thread launches kernels on the same ``cuda:<index>``."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------------------ fetches

    def _request_headers(
        self, peer: Peer, start, max_headers: int, reverse: bool = False
    ) -> List[BlockHeader]:
        # client-side span around the peer round-trip (no wire-format
        # change): fetch latency lands on the requesting thread's track
        with span("sync.fetch.headers", peer=peer.remote_pub[:8],
                  max_headers=max_headers):
            body = peer.request(
                ETH_OFFSET + GET_BLOCK_HEADERS,
                GetBlockHeaders(start, max_headers, 0, reverse).body(),
                ETH_OFFSET + BLOCK_HEADERS,
                timeout=self.timeout,
            )
        try:
            return decode_headers(body)
        except Exception as e:  # malformed reply IS the peer's fault
            raise PeerError(f"undecodable headers: {e}")

    def _request_bodies(
        self, peer: Peer, hashes: List[bytes]
    ) -> List[BlockBody]:
        with span("sync.fetch.bodies", peer=peer.remote_pub[:8],
                  count=len(hashes)):
            body = peer.request(
                ETH_OFFSET + GET_BLOCK_BODIES,
                list(hashes),
                ETH_OFFSET + BLOCK_BODIES,
                timeout=self.timeout,
            )
        try:
            return decode_bodies(body)
        except Exception as e:  # malformed reply IS the peer's fault
            raise PeerError(f"undecodable bodies: {e}")

    def _fetch_blocks(
        self, peer: Peer, headers: List[BlockHeader]
    ) -> List[Block]:
        """Bodies for ``headers``; every body is checked against its
        header's txRoot/ommersHash before assembly (a peer cannot hand
        us a mismatched body)."""
        blocks: List[Block] = []
        want = list(headers)
        while want:
            batch = want[: self.batch_size]
            bodies = self._request_bodies(peer, [h.hash for h in batch])
            if len(bodies) != len(batch):
                # BlockBodies carries no correlation and the serving
                # side silently SKIPS unknown hashes — a short reply
                # would shift every later header/body pair, so a count
                # mismatch ends the round (next round refetches fresh
                # headers; an honest mid-reorg peer recovers there)
                raise PeerError(
                    f"peer served {len(bodies)}/{len(batch)} bodies"
                )
            for header, body in zip(batch, bodies):
                if transactions_root(body.transactions) != header.transactions_root:
                    raise PeerError("body txRoot mismatch")
                if ommers_hash(body.ommers) != header.ommers_hash:
                    raise PeerError("body ommersHash mismatch")
                blocks.append(Block(header, body))
            want = want[len(bodies) :]
        return blocks

    # ------------------------------------------------------- branch logic

    def _resolve_branch(
        self, peer: Peer, headers: List[BlockHeader]
    ) -> Optional[List[BlockHeader]]:
        """Headers don't attach to our chain tip: walk the peer's chain
        backward (block_resolving_depth cap) until a header's parent is
        known to us, then decide the reorg by total difficulty
        (RegularSyncService.scala:171-269)."""
        chain = list(headers)
        depth_left = self.config.sync.block_resolving_depth
        while depth_left > 0:
            ancestor = self.blockchain.get_header_by_hash(
                chain[0].parent_hash
            )
            if ancestor is not None:
                return self._maybe_reorg(chain, ancestor)
            fetch = min(self.batch_size, depth_left)
            older = self._request_headers(
                peer, chain[0].parent_hash, fetch, reverse=True
            )
            if not older:
                return None
            # reverse fetch returns newest-first starting AT parent_hash
            older = list(reversed(older))
            if older[-1].hash != chain[0].parent_hash:
                return None  # peer served garbage
            chain = older + chain
            depth_left -= len(older)
        return None

    def _maybe_reorg(
        self, branch: List[BlockHeader], ancestor: BlockHeader
    ) -> Optional[List[BlockHeader]]:
        """Accept the branch iff its cumulative TD beats ours AND every
        branch header passes full validation against its parent
        (appendNewBlock TD rule, RegularSyncService.scala:336-345).
        Validating BEFORE any rollback means a peer cannot knock us off
        our tip with invented difficulty fields — the rollback itself
        happens only after the branch's bodies are also in hand
        (_sync_round)."""
        ancestor_td = self.blockchain.get_total_difficulty(ancestor.number)
        if ancestor_td is None:
            return None
        branch_td = ancestor_td + sum(h.difficulty for h in branch)
        our_best = self.blockchain.best_block_number
        our_td = self.blockchain.get_total_difficulty(our_best) or 0
        if branch_td <= our_td:
            self.log(
                f"side branch at #{ancestor.number} loses TD "
                f"({branch_td} <= {our_td}); keeping our chain"
            )
            return None
        parent = ancestor
        for h in branch:
            try:
                self._driver.header_validator.validate(h, parent)
            except Exception as e:
                raise PeerError(f"branch header #{h.number} invalid: {e}")
            parent = h
        return branch

    def _rollback_to(self, ancestor_number: int) -> None:
        """Remove our blocks above the common ancestor. Unjournaled
        primitive — live reorgs go through ReorgManager.switch; this
        stays for callers that rewind a chain they fully own. The walk
        must REACH the ancestor: a missing header mid-walk means best
        points above a hole, and silently moving best there (the old
        behavior) would canonize the gap."""
        n = self.blockchain.best_block_number
        while n > ancestor_number:
            header = self.blockchain.get_header_by_number(n)
            if header is None:
                raise SyncAborted(
                    f"rollback found no header at #{n} (walking "
                    f"{self.blockchain.best_block_number} -> "
                    f"{ancestor_number}): chain store has a hole"
                )
            self.blockchain.remove_block(header.hash)
            n -= 1
        self.blockchain.storages.app_state.best_block_number = ancestor_number
        self.reorgs += 1

    # ----------------------------------------------------------- healing

    def _heal_missing_node(self, peer: Peer, node_hash: bytes) -> None:
        """Fetch one trie node by hash and admit it (content-address
        verified) into the node stores — the read-through self-heal the
        kesque DistributedNodeStorage role performs (storage/remote.py),
        wired into the live import loop. The sharded cluster (replica
        failover + breakers, values pre-verified by the client) is
        consulted first; the announcing peer is the fallback when no
        shard holds the node."""
        with span("sync.heal", node=node_hash) as heal_sp:
            if self.cluster is not None:
                try:
                    got = self.cluster.fetch([node_hash])
                except Exception:
                    got = {}
                blob = got.get(node_hash)
                if blob is not None and keccak256(blob) == node_hash:
                    s = self.blockchain.storages
                    s.account_node_storage.put(node_hash, blob)
                    s.storage_node_storage.put(node_hash, blob)
                    self.healed_nodes += 1
                    self.cluster_healed += 1
                    heal_sp.set_tag("source", "cluster")
                    return
            body = peer.request(
                ETH_OFFSET + GET_NODE_DATA,
                [node_hash],
                ETH_OFFSET + NODE_DATA,
                timeout=self.timeout,
            )
            for blob in body:
                if keccak256(blob) == node_hash:
                    s = self.blockchain.storages
                    s.account_node_storage.put(node_hash, blob)
                    s.storage_node_storage.put(node_hash, blob)
                    self.healed_nodes += 1
                    heal_sp.set_tag("source", "peer")
                    return
            raise PeerError(
                f"peer could not heal node {node_hash.hex()[:16]}"
            )

    # -------------------------------------------------------------- steps

    def sync_once(self) -> int:
        """One pull round; returns the number of blocks imported. A
        device-path error (here, or kept from a pushed block's import)
        escapes."""
        err, self._push_error = self._push_error, None
        if err is not None:
            raise err
        peer = self.manager.best_peer()
        if peer is None or peer.status is None:
            return 0
        our_best = self.blockchain.best_block_number
        our_td = self.blockchain.get_total_difficulty(our_best) or 0
        # NOTE: no early TD gate — peer.status carries the HANDSHAKE-time
        # TD, stale the moment the peer advances. The reference keeps
        # asking its best peer on every resume tick and lets the header
        # response decide (RegularSyncService.ResumeRegularSyncTask);
        # TD only picks the peer and judges branches.
        try:
            # announce fetches share the round's PeerError handling: a
            # peer that times out answering its own announce gets
            # demoted, it must not kill the sync loop
            announced = self._drain_announces(peer)
            return announced + self._sync_round(peer, our_best, our_td)
        except PeerError as e:
            # wire/protocol failure (disconnect, timeout, mismatched
            # body, garbage headers): demote the peer; the loop carries
            # on with other peers
            self.log(f"peer failed mid-round: {e}")
            self.manager.blacklist.add(peer.remote_pub, duration=60.0)
            peer.disconnect()
            return 0
        except _BLOCK_REFUSED as e:
            # a block the import refused must not demote an honest peer
            # (it may be mid-reorg) nor kill the loop. A branch that
            # failed AFTER rollback leaves us at the ancestor; later
            # rounds sync forward again from there. Device-path errors
            # are not in this set: they escape
            self.log(f"round failed locally: {e}")
            return 0

    def _sync_round(self, peer: Peer, our_best: int, our_td: int) -> int:
        headers = self._request_headers(peer, our_best + 1, self.batch_size)
        if not headers:
            if peer.status.total_difficulty <= our_td:
                return 0  # nothing new and no TD claim: at the tip
            # the peer claims higher TD but serves nothing past our tip:
            # its (heavier) chain is SHORTER than ours. Probe DOWNWARD
            # one height at a time — an empty reply only proves the peer
            # lacks the START height (the serving side bails on the
            # first missing header), so a coarser step would skip the
            # heights where its best/branch actually lives. Bounded by
            # the branch-resolving depth.
            headers = []
            probe = our_best
            floor = max(1, our_best - self.config.sync.block_resolving_depth)
            while probe >= floor and not headers:
                headers = self._request_headers(
                    peer, probe, self.batch_size, reverse=True
                )
                probe -= 1
            if not headers:
                return 0
            headers = list(reversed(headers))
            if headers[-1].hash == self.blockchain.get_hash_by_number(
                headers[-1].number
            ):
                return 0  # same chain after all — nothing to adopt

        tip = self.blockchain.get_hash_by_number(our_best)
        is_reorg = False
        if headers[0].parent_hash != tip:
            resolved = self._resolve_branch(peer, headers)
            if resolved is None:
                return 0
            headers = resolved
            is_reorg = True

        # bodies BEFORE any rollback: a reorg only touches our chain
        # once the replacement blocks are fully fetched and checked
        blocks = self._fetch_blocks(peer, headers)
        imported = 0
        with self._import_lock:  # excludes the NewBlock push handler
            # the tip may have MOVED while we fetched (a pushed block
            # imported by the handler): re-check under the lock
            cur_best = self.blockchain.best_block_number
            if is_reorg:
                ancestor_number = headers[0].number - 1
                anc = self.blockchain.get_header_by_number(ancestor_number)
                if anc is None or anc.hash != headers[0].parent_hash:
                    return 0  # chain changed under us; resolve next round
                # journaled atomic switch: fence -> intent -> rollback
                # -> adopt (windowed for long branches) -> finalize
                # (sync/reorg.py). Depth refusal escalates as PeerError:
                # a peer whose branch forks below the unconfirmed ring
                # gets demoted, we keep our chain.
                try:
                    done = self.reorg.switch(
                        ancestor_number, blocks,
                        # khipu-lint: ok KL004 one-shot cached probe, no lock taken inside
                        import_fn=lambda b: self._import_healing(peer, b),
                    )
                except ReorgTooDeep as e:
                    raise PeerError(str(e))
                self.reorgs += 1
                imported += done
                self.imported += done
                self.log(
                    f"reorg: switched at #{ancestor_number}, adopted "
                    f"{done} peer blocks"
                )
                blocks = []  # fully consumed by the switch
            else:
                # drop blocks a concurrent push already covered; if the
                # remainder no longer attaches, defer to the next round
                # (the TD rule decides between the competing tips)
                blocks = [
                    b for b in blocks if b.header.number > cur_best
                ]
                if blocks and blocks[0].header.parent_hash != (
                    self.blockchain.get_hash_by_number(
                        blocks[0].header.number - 1
                    )
                ):
                    return 0
            # bulk catch-up: a full fetched batch on the canonical
            # chain routes through the PIPELINED windowed replay
            # (seal/collect overlap, sync/replay.replay_windowed)
            # instead of block-at-a-time import; anything it didn't
            # take falls through to the healing per-block path below
            window = self.config.sync.commit_window_blocks
            if window > 1 and len(blocks) >= window:
                # the adaptive backend probe it can reach is one-shot,
                # process-cached (~ms), and must finish before any
                # window commits anyway — holding _import_lock across
                # it cannot deadlock (the probe takes no locks)
                # khipu-lint: ok KL004 one-shot cached probe, no lock taken inside
                done = self._import_windowed(blocks)
                if done:
                    if self.txpool is not None:
                        for b in blocks[:done]:
                            self.txpool.remove_mined(
                                b.body.transactions
                            )
                    imported += done
                    self.imported += done
                    blocks = blocks[done:]
            for block in blocks:
                # khipu-lint: ok KL004 one-shot cached probe, no lock taken inside
                self._import_healing(peer, block)
                if self.txpool is not None:
                    self.txpool.remove_mined(block.body.transactions)
                imported += 1
                self.imported += 1
        if imported:
            self.log(
                f"imported {imported} blocks, best now "
                f"#{self.blockchain.best_block_number}"
            )
        return imported

    def _import_healing(self, peer: Peer, block: Block) -> None:
        """Single-block validated import with the missing-node heal
        loop — the per-block live path, also handed to
        ReorgManager.switch for per-block branch adoption."""
        with span("import", block=block.header.number,
                  txs=len(block.body.transactions)):
            for attempt in range(3):
                try:
                    with self._on_device():
                        self._driver._execute_and_insert(
                            block, _null_stats()
                        )
                    return
                except MPTNodeMissingException as e:
                    self._heal_missing_node(peer, e.hash)
            raise SyncAborted(
                f"block {block.header.number} kept failing after heals"
            )

    def _import_windowed(self, blocks: List[Block]) -> int:
        """Import a fetched batch through the windowed pipeline;
        returns how many LEADING blocks were persisted (windows commit
        front-to-back, so persisted blocks are always a prefix).

        Failure semantics: replay_windowed persists nothing of a window
        before its root checks pass, so where a case below hands the
        rest to the per-block path, it can redo the remaining blocks
        safely. A WindowMismatch is BAD PEER DATA (a header whose state
        root the re-execution refutes) and escalates as PeerError —
        sync_once demotes the peer; a missing trie node (fast-sync
        leftover state) or a pre-Byzantium batch falls back to the
        healing loop. Every other error (a failed launch, a device seam's
        fault, a dead collector under fail-stop) escapes: the window may
        be torn, and startup recovery settles it."""
        from khipu_tpu_torch.ledger.window import WindowMismatch

        before = self.blockchain.best_block_number
        try:
            self._driver.replay_windowed(
                iter(blocks), self.config.sync.commit_window_blocks
            )
        except WindowMismatch as e:
            raise PeerError(f"windowed import diverged: {e}")
        except MPTNodeMissingException as e:
            self.log(
                f"windowed import missing node {e.hash[:8].hex()}; "
                "healing per block"
            )
        except WindowNeedsByzantium as e:
            self.log(f"windowed import refused the batch ({e}); "
                     "importing per block")
        except CollectorDied:
            # with graceful degradation OFF the operator asked for
            # fail-stop semantics: a dead collector means a torn window
            # may be on disk, and the per-block healing path must NOT
            # paper over it — surface the death so the round aborts and
            # startup recovery (sync/journal.py) settles the intent
            if not self.config.sync.degrade_on_collector_death:
                raise
            self.log("windowed import lost its collector; "
                     "healing per block")
        return self.blockchain.best_block_number - before

    def run(self, until: Callable[[], bool], poll: float = 0.2,
            max_seconds: float = 60.0) -> None:
        """Loop sync_once until ``until()`` or timeout (test harness /
        node main-loop form)."""
        # monotonic: this deadline is pure elapsed-time bookkeeping —
        # wall-clock here would jump with NTP steps AND trip KL003
        deadline = time.monotonic() + max_seconds
        while not until():
            if time.monotonic() > deadline:
                raise SyncAborted("regular sync timed out")
            if self.sync_once() == 0:
                time.sleep(poll)

    # ------------------------------------------------------ propagation

    def install_new_block_handler(self) -> None:
        """Install the gossip consumers: peer-pushed NewBlock imports
        (handleNewBlockMsgs role), NewBlockHashes announces (queued —
        sync_once fetches them; fetching on the announcer's reader
        thread would deadlock on its own reply), and pending-tx gossip
        into the pool (SignedTransactions, CommonMessages.scala)."""
        installs = {
            ETH_OFFSET + NEW_BLOCK: self._on_new_block,
            # manager-level (future peers): announce without a source —
            # the drain falls back to the round's best peer
            ETH_OFFSET + NEW_BLOCK_HASHES: self._on_new_block_hashes,
            ETH_OFFSET + TRANSACTIONS: self._on_transactions,
        }
        self.manager.handlers.update(installs)
        for peer in self.manager.peers:
            peer.handlers.update(installs)
            # per-peer closure: record WHO announced, so the fetch goes
            # to the peer that actually has the block
            peer.handlers[ETH_OFFSET + NEW_BLOCK_HASHES] = (
                lambda body, p=peer: self._on_new_block_hashes(body, p)
            )

    def _on_transactions(self, body) -> None:
        if self.txpool is None:
            return None
        try:
            txs = decode_transactions(body)
        except Exception:
            return None
        from khipu_tpu_torch.domain.transaction import recover_senders

        recover_senders(txs)
        for stx in txs:
            if stx.sender is not None:
                self.txpool.add(stx)
        return None

    def _on_new_block_hashes(self, body, source: Peer = None) -> None:
        try:
            pairs = decode_new_block_hashes(body)
        except Exception:
            return None
        with self._announce_lock:
            self._announced.extend(
                (h, n, source) for h, n in pairs
            )
            del self._announced[:-64]  # bounded backlog
        return None

    def _drain_announces(self, peer: Peer) -> int:
        """Fetch + import announced blocks we don't have yet (PV62
        NewBlockHashes consumer). Runs on the pull thread; fetches from
        the ANNOUNCING peer when known (it provably has the block —
        the best-TD peer may not have imported it yet), else from the
        round's peer."""
        with self._announce_lock:
            pairs, self._announced = self._announced, []
        before = self.imported
        for idx, (block_hash, number, source) in enumerate(pairs):
            if self.blockchain.get_header_by_hash(block_hash) is not None:
                continue
            if number != self.blockchain.best_block_number + 1:
                continue  # the pull round handles gaps/branches
            src = source if source is not None and source.alive else peer
            with span("announce", block=number,
                      from_announcer=source is not None):
                headers = self._request_headers(src, number, 1)
                if not headers or headers[0].hash != block_hash:
                    continue
                blocks = self._fetch_blocks(src, headers)
            if not self._import_lock.acquire(blocking=False):
                # a push import holds the lock: give the unprocessed
                # tail (this announce included) back to the backlog so
                # the next round retries it instead of dropping it —
                # prepended to keep announce order ahead of anything
                # that arrived meanwhile, same bounded-backlog cap
                with self._announce_lock:
                    self._announced[:0] = pairs[idx:]
                    del self._announced[:-64]
                break
            try:
                for block in blocks:
                    # khipu-lint: ok KL004 one-shot cached probe, no lock taken inside
                    self._on_new_block_locked(block)
            finally:
                self._import_lock.release()
        return self.imported - before

    def _on_new_block(self, body) -> None:
        # Runs on the pushing peer's reader thread: chain checks and the
        # import must hold the pull loop's lock — but NON-BLOCKING. The
        # pull loop heals missing nodes via peer.request WHILE holding
        # the lock; if this handler parked the reader thread waiting on
        # it, the heal reply could never be read (deadlock-by-timeout).
        # A dropped push is harmless: the pull loop catches up.
        try:
            block, _td = decode_new_block(body)
        except Exception:
            return None
        if not self._import_lock.acquire(blocking=False):
            return None
        try:
            # khipu-lint: ok KL004 one-shot cached probe, no lock taken inside
            self._on_new_block_locked(block)
        except Exception as e:  # noqa: BLE001
            # a device-path failure has no caller on this thread: keep
            # it for the pull loop, whose next sync_once raises it
            self.log(f"pushed block #{block.header.number} hit a device "
                     f"error: {e!r}")
            self._push_error = e
        finally:
            self._import_lock.release()
        return None

    def _on_new_block_locked(self, block: Block) -> None:
        our_best = self.blockchain.best_block_number
        if block.header.number != our_best + 1:
            return  # ahead/behind: the pull loop catches up
        if block.header.parent_hash != (
            self.blockchain.get_hash_by_number(our_best)
        ):
            return  # side branch: the pull loop's TD rule decides
        try:
            with span("import", block=block.header.number, pushed=True), \
                    self._on_device():
                self._driver._execute_and_insert(block, _null_stats())
        except _BLOCK_REFUSED as e:  # invalid push: pull loop decides
            self.log(f"pushed block rejected: {e}")
            return
        self.imported += 1
        if self.txpool is not None:
            self.txpool.remove_mined(block.body.transactions)
        self.log(f"imported pushed block #{block.header.number}")


def broadcast_new_block(manager: PeerManager, block: Block, td: int) -> int:
    """Push a freshly sealed/imported block to every live peer
    (BroadcastNewBlocks role; miner + import tail call this). Returns
    the number of peers reached."""
    payload = encode_new_block(block, td)
    sent = 0
    for peer in list(manager.peers):
        if not peer.alive:
            continue
        try:
            peer.send(ETH_OFFSET + NEW_BLOCK, payload)
            sent += 1
        except Exception:
            pass
    return sent


def propagate_block(manager: PeerManager, block: Block, td: int) -> int:
    """Standard eth propagation split: the FULL block goes to
    ceil(sqrt(peers)) peers, the lightweight NewBlockHashes announce to
    the rest (they fetch on demand) — bandwidth-bounded flood, the
    shape the reference's BroadcastNewBlocks + NewBlockHashes pair
    implements. Returns peers reached."""
    import math

    peers = [p for p in list(manager.peers) if p.alive]
    if not peers:
        return 0
    n_full = max(1, math.isqrt(len(peers)))
    full_payload = encode_new_block(block, td)
    hash_payload = encode_new_block_hashes(
        [(block.hash, block.header.number)]
    )
    sent = 0
    for i, peer in enumerate(peers):
        try:
            if i < n_full:
                peer.send(ETH_OFFSET + NEW_BLOCK, full_payload)
            else:
                peer.send(ETH_OFFSET + NEW_BLOCK_HASHES, hash_payload)
            sent += 1
        except Exception:
            pass
    return sent


def broadcast_transactions(manager: PeerManager, stxs) -> int:
    """Gossip pending transactions to live peers (SignedTransactions,
    CommonMessages.scala; the reference's PendingTransactionsService
    pubsub role). A per-peer known-tx set (the reference's
    knownTransactions) suppresses re-sends: once T has been sent to P,
    later gossip ticks skip it, so a tx crosses each link a bounded
    number of times instead of re-flooding the mesh every hop."""
    stxs = list(stxs)
    if not stxs:
        return 0
    sent = 0
    for peer in list(manager.peers):
        if not peer.alive:
            continue
        # insertion-ordered dict: the trim really drops the OLDEST half
        known = peer.__dict__.setdefault("known_txs", {})
        fresh = [s for s in stxs if s.hash not in known]
        if not fresh:
            continue
        try:
            peer.send(ETH_OFFSET + TRANSACTIONS, encode_transactions(fresh))
            for s in fresh:
                known[s.hash] = None
            if len(known) > 16384:  # bounded memory per peer
                drop = len(known) - 8192
                for h in list(known)[:drop]:
                    del known[h]
            sent += 1
        except Exception:
            pass
    return sent


def gossip_pending(manager: PeerManager, pool, cursor: int) -> int:
    """Broadcast txs that arrived in the pool since ``cursor`` (the
    pool's arrival journal); returns the new cursor. The node main loop
    calls this each tick — local submissions (eth_sendRawTransaction /
    personal_sendTransaction) and peer-gossiped txs both propagate."""
    hashes, new_cursor = pool.arrivals_since(cursor)
    stxs = [pool.get(h) for h in hashes]
    broadcast_transactions(manager, [s for s in stxs if s is not None])
    return new_cursor


def _null_stats() -> ReplayStats:
    """A throwaway stats sink for one single-block import (its phase
    times and counts are dropped)."""
    return ReplayStats(phases={k: 0.0 for k in PHASES})
