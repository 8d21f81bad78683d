"""Read-replica driver: a read-only follower serving RPC at a known
block height.

The serving fleet (docs/serving.md "Replica fleet") splits the node
into one WRITE plane (the primary: txpool, execution, the windowed
pipeline) and N READ planes. Each :class:`ReplicaDriver` owns a full
store + ReadView + RPC service of its own and TAILS the primary's
committed chain through a :class:`PrimaryFeed`:

* the feed exposes only the primary's DURABLE surfaces —
  ``best_block_number`` advances when the background collector has
  persisted a window (root-checked, journal-committed), so a replica
  never sees executed-but-not-durable state and its height is always
  a prefix of what the primary would survive a crash with;
* blocks cross the feed as RLP round-trips (wire fidelity: the
  replica re-validates headers/bodies through the same
  ``ReplayDriver`` paths live sync uses — a corrupt feed read cannot
  silently poison the replica store);
* when the primary REORGS below the replica's tip, the tail mirrors
  the switch through the replica's own journaled ``ReorgManager`` —
  which is exactly what delivers ``removed: true`` retractions to the
  replica's FilterManager and rewinds its filter cursors (the filters'
  retraction contract, holding on every member of the fleet);
* ``replica.tail`` is a chaos seam: an injected death fail-stops the
  tail thread mid-batch (InjectedDeath is a BaseException — KL002),
  and tests/test_torch_fleet.py pins the invariant that a dead-anywhere
  replica chain is a hash-exact PREFIX of the primary's.

Health plugs into the existing cluster plane: a ReplicaDriver is a
valid ``ClusterTelemetry`` scrape client (``get_metrics``/``close``),
and a dead replica FAILS its scrape — ``khipu_shard_health`` drops to
0.0 within one scrape interval, which is what the FleetRouter's
pick-2 consumes. Staleness degrades admission instead: the
``replica_lag`` pressure signal (serving/admission.py) sheds reads
once the follower falls past ``ServingConfig.max_replica_lag_blocks``.

The port's copy of ``khipu_tpu.serving.replica``. A replica commits on
a device (``device=None`` means the card, and raises without one): its
genesis loads there and its per-block tail replay runs
``ReplayDriver(device_commit=True)``, so each block's trie commit
launches K1r once a level on the card, beside the primary in the same
process. The scrape surface answers in the port's metrics codec
(``observability/telemetry.py``); the telemetry poller that would
scrape it comes with the cluster (ROADMAP A11).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.observability.journey import JOURNEY, use_node
from khipu_tpu_torch.observability.registry import MetricsRegistry
from khipu_tpu_torch.observability.telemetry import (
    decode_metrics,
    encode_metrics,
)
from khipu_tpu_torch.storage.storages import Storages


class PrimaryFeed:
    """In-process follower feed over a primary's durable chain.

    Only committed surfaces: ``head_number`` is the primary's
    ``best_block_number`` (advanced by the collector after a window
    persists), blocks come back as independent RLP round-trip copies.
    The same three methods are what a socket-backed feed would carry,
    so replicas never know which transport they tail."""

    def __init__(self, blockchain: Blockchain):
        self.blockchain = blockchain

    def head_number(self) -> int:
        return self.blockchain.best_block_number

    def hash_of(self, number: int) -> Optional[bytes]:
        header = self.blockchain.get_header_by_number(number)
        return header.hash if header is not None else None

    def block(self, number: int) -> Optional[Block]:
        b = self.blockchain.get_block_by_number(number)
        if b is None:
            return None
        return Block.decode(b.encode())


class ReplicaDriver:
    """A read-only follower: own store, own ReadView, own RPC plane.

    ``genesis`` is configuration, not sync (as on real networks): the
    replica loads the same :class:`GenesisSpec` the primary did, then
    cross-checks the resulting genesis hash against the feed — a
    mismatched spec fails construction instead of diverging at
    block 1. ``device`` is where the replica's commits run (``None``
    means the card); a caller sharing a card with the primary passes
    the primary's device."""

    def __init__(
        self,
        name: str,
        feed: PrimaryFeed,
        config: KhipuConfig,
        genesis: GenesisSpec,
        log: Optional[Callable[[str], None]] = None,
        device=None,
    ):
        from khipu_tpu_torch.jsonrpc import EthService, JsonRpcServer
        from khipu_tpu_torch.serving import ServingPlane
        from khipu_tpu_torch.serving.admission import (
            AdmissionController,
            replica_lag_pressure,
        )
        from khipu_tpu_torch.serving.readview import ReadView
        from khipu_tpu_torch.sync.reorg import ReorgManager
        from khipu_tpu_torch.sync.replay import ReplayDriver

        self.name = name
        self.feed = feed
        self.config = config
        self.log = log or (lambda s: None)
        self.device = resolve_device(device)
        self.blockchain = Blockchain(Storages(), config)
        self.blockchain.load_genesis(genesis, on_device=True,
                                     device=self.device)
        feed_genesis = feed.hash_of(0)
        mine = self.blockchain.get_header_by_number(0).hash
        if feed_genesis is not None and feed_genesis != mine:
            raise ValueError(
                f"replica {name}: genesis spec does not match the "
                f"primary ({mine.hex()[:8]} vs {feed_genesis.hex()[:8]})"
            )
        self.read_view = ReadView(self.blockchain)
        self.driver = ReplayDriver(
            self.blockchain, config, device_commit=True,
            device=self.device, read_view=self.read_view,
        )
        # the replica's OWN journaled switch: mirroring a primary reorg
        # through it is what fires the FilterManager retraction listener
        # and keeps replica crash recovery identical to the primary's
        self.reorg = ReorgManager(
            self.blockchain, config, driver=self.driver,
            read_view=self.read_view,
        )
        serving_cfg = config.serving
        admission = AdmissionController(
            serving_cfg,
            signals=[replica_lag_pressure(self)],
        )
        self.plane = ServingPlane(
            serving_cfg, read_view=self.read_view, admission=admission
        )
        self.service = EthService(
            self.blockchain, config, read_view=self.read_view,
            serving=self.plane, reorg_manager=self.reorg,
        )
        self.server = JsonRpcServer(self.service, serving=self.plane)
        # batch bound per tail pass: a far-behind replica catches up in
        # bounded slices, so lag (and the pressure signal) stays honest
        # instead of one unbounded pass hiding it
        self.batch = serving_cfg.replica_batch_blocks
        self.poll_interval = serving_cfg.replica_poll_interval
        self._primary_head = self.blockchain.best_block_number
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self.tail_passes = 0
        self.blocks_applied = 0
        self.switches_mirrored = 0

    # ----------------------------------------------------------- tail

    def tail_once(self) -> int:
        """One follower pass: find the divergence point against the
        feed, then either mirror a primary reorg through our own
        journaled switch or import the next batch of committed blocks
        through the validated replay path. Returns blocks applied."""
        from khipu_tpu_torch.sync.replay import PHASES, ReplayStats

        fault_point("replica.tail")
        p_head = self.feed.head_number()
        self._primary_head = max(self._primary_head, p_head)
        bc = self.blockchain
        my = bc.best_block_number
        # walk back until our hash agrees with the feed's — block 0 was
        # hash-checked at construction, so the walk always terminates
        anc = min(my, p_head)
        while anc > 0:
            header = bc.get_header_by_number(anc)
            if (header is not None
                    and self.feed.hash_of(anc) == header.hash):
                break
            anc -= 1
        applied = 0
        # every stamp from this pass — re-execution lanes included —
        # carries this replica's node label; the visibility page below
        # feeds the replica_visible commit-latency histogram against
        # the PRIMARY's ingress stamp (one shared process board)
        with use_node(f"replica:{self.name}"):
            if anc < my:
                # the primary switched below our tip; a mid-switch feed
                # read can transiently show p_head == anc (best drops to
                # the ancestor before rollback) — wait for the adopted
                # branch to land rather than switch to an empty suffix
                if p_head > anc:
                    hi = min(p_head, anc + self.batch)
                    blocks = []
                    for n in range(anc + 1, hi + 1):
                        b = self.feed.block(n)
                        if b is None:
                            break
                        blocks.append(b)
                    if blocks:
                        self.reorg.switch(anc, blocks)
                        self.switches_mirrored += 1
                        applied = len(blocks)
                        if JOURNEY.enabled:
                            self._stamp_visible(blocks)
            elif p_head > my:
                stats = ReplayStats(phases={k: 0.0 for k in PHASES})
                hi = min(p_head, my + self.batch)
                for n in range(my + 1, hi + 1):
                    fault_point("replica.tail")
                    b = self.feed.block(n)
                    if b is None:
                        break  # feed mid-mutation: retry next pass
                    self.driver._execute_and_insert(b, stats)
                    applied += 1
                    if JOURNEY.enabled:
                        self._stamp_visible([b])
        self.tail_passes += 1
        self.blocks_applied += applied
        if applied:
            with self._cv:
                self._cv.notify_all()
        return applied

    def _stamp_visible(self, blocks) -> None:
        """The passport's per-replica visibility page: this replica's
        tail height passed the tx's block — reads served here now see
        it (the fleet token promise, measured per tx)."""
        for b in blocks:
            for stx in b.body.transactions:
                JOURNEY.record(stx.hash, "replica.visible",
                               replica=self.name,
                               height=b.header.number)

    def _run(self) -> None:
        while not self._stop.is_set():
            applied = self.tail_once()
            if applied == 0:
                self._stop.wait(self.poll_interval)

    def start(self) -> "ReplicaDriver":
        self._started = True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def kill(self) -> None:
        """Hard failover: stop tailing AND start failing health
        scrapes (``alive()`` False). The router drops the replica on
        its next pick; waiters inside ``ensure_height`` bail."""
        self._started = False
        self.stop()

    def alive(self) -> bool:
        if not self._started:
            return False
        t = self._thread
        # a thread killed by an InjectedDeath (fail-stop) is dead even
        # though nobody called stop()
        return t is not None and t.is_alive()

    # -------------------------------------------------------- read side

    def head_number(self) -> int:
        return self.read_view.head_number()

    def lag_blocks(self) -> int:
        """Committed-height distance behind the last primary head this
        replica has SEEN (a dead feed keeps the last observation — lag
        can only grow while wedged, never flatter itself back to 0)."""
        try:
            self._primary_head = max(
                self._primary_head, self.feed.head_number()
            )
        except Exception:
            pass
        return max(
            0, self._primary_head - self.blockchain.best_block_number
        )

    def has_block(self, number: int, block_hash: bytes) -> bool:
        header = self.blockchain.get_header_by_number(number)
        return header is not None and header.hash == block_hash

    def ensure_height(self, number: int, timeout: float) -> bool:
        """Wait-or-redirect half of the consistent-read token
        contract: block until this replica serves ``number`` (True) or
        the budget runs out / the tail dies (False — the router
        redirects to the primary and counts it)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.read_view.head_number() < number:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.alive():
                    return False
                self._cv.wait(remaining)
        return True

    # ------------------------------------------- telemetry scrape client

    def get_metrics(self) -> dict:
        """ClusterTelemetry scrape client surface: a dead replica
        RAISES, so its ``khipu_shard_health`` drops to 0.0 within one
        scrape interval (unreachable is unhealthy, regardless of
        history) and pick-2 routes around it."""
        if not self.alive():
            raise ConnectionError(f"replica {self.name} is down")
        reg = MetricsRegistry()
        reg.gauge("khipu_replica_lag_blocks").set(self.lag_blocks())
        reg.gauge("khipu_best_block_number").set(
            self.blockchain.best_block_number
        )
        return decode_metrics(encode_metrics(reg))

    def close(self) -> None:
        pass

    # ---------------------------------------------------------- surface

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "alive": self.alive(),
            "best": self.blockchain.best_block_number,
            "primaryHead": self._primary_head,
            "lagBlocks": self.lag_blocks(),
            "tailPasses": self.tail_passes,
            "blocksApplied": self.blocks_applied,
            "switchesMirrored": self.switches_mirrored,
        }
