"""ServiceBoard: the composition root wiring every subsystem from one
config, plus coordinated shutdown.

Parity: service/ServiceBoard.scala:64 (engine select :99-138, Blockchain
:141, Ledger wiring :154, PeerManager :172, EthService :193; node key
load/generate :217-242) and Khipu.scala:45 (main :56-88, coordinated
storage close :58-66). ``python -m khipu_tpu_torch`` boots it.

The port's copy of ``khipu_tpu.service_board``. The board commits on one
device (``device=None`` means the card, and raises without one): the
genesis loads there, the boot recovery pass settles pending intents
there, and the sync services it starts import there (K5 a window, K1r
a block), and so does the bridge's ``ExecuteBlocks``. ``start_serving``
builds the serving plane whose read view ``start_regular_sync`` hands to
the windowed import. ``start_cluster`` makes the node stores read
through the sharded node-cache cluster (with the health prober),
``join_shard`` / ``retire_shard`` rebalance it live, and
``start_telemetry`` federates the shards' metrics.
"""

from __future__ import annotations

import os
import secrets
from typing import Optional

from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.observability.trace import Tracer, apply_config
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.txpool import OmmersPool, PendingTransactionsPool


class ServiceBoard:
    def __init__(self, config: KhipuConfig,
                 genesis: Optional[GenesisSpec] = None, device=None):
        self.config = config
        # every commit this board starts runs here (None means the card)
        self.device = resolve_device(device)
        self.storages = Storages(
            engine=config.db.engine,
            data_dir=config.db.data_dir,
            unconfirmed_depth=config.db.unconfirmed_depth,
            cache_size=config.db.cache_size,
        )
        self.blockchain = Blockchain(self.storages, config)
        if self.blockchain.get_header_by_number(0) is None:
            self.blockchain.load_genesis(genesis or GenesisSpec(),
                                         on_device=True, device=self.device)
        # crash-recovery startup pass (sync/journal.py): settle any
        # window-commit intents a previous process death left pending —
        # repair complete windows, roll partial ones back, complete or
        # abandon torn chain switches. None when the journal is clean
        # (the overwhelmingly common boot).
        self.recovery_report = None
        if config.sync.commit_journal:
            if self.storages.window_journal.pending():
                from khipu_tpu_torch.sync.journal import recover

                self.recovery_report = recover(
                    self.blockchain, log=print, config=config,
                    device=self.device,
                )
        self.tx_pool = PendingTransactionsPool()
        self.ommers_pool = OmmersPool()
        # board-owned flight recorder: every service this board starts
        # (RPC, bridge) records into THIS ring, so two boards in one
        # process (tests, embedded shards) keep disjoint traces. The
        # module-global tracer stays the default for bare drivers.
        self.tracer = Tracer()
        apply_config(config.observability, self.tracer)
        self.node_key = self._load_or_create_node_key()
        self._rpc_server = None
        self._bridge_server = None
        self._peer_manager = None
        self._discovery = None
        self._regular_sync = None
        self._fast_sync = None
        self._serving = None
        self._cluster = None
        self._cluster_health = None
        self._rebalancer = None
        self._telemetry = None
        self._watchdog = None

    # ---------------------------------------------------------- node key

    def _load_or_create_node_key(self) -> bytes:
        """nodeKey load/generate (ServiceBoard.scala:217-242)."""
        data_dir = self.config.db.data_dir
        if data_dir is None:
            return secrets.token_bytes(32)
        path = os.path.join(data_dir, "nodekey")
        if os.path.exists(path):
            with open(path, "rb") as f:
                key = f.read()
            if len(key) != 32:
                raise ValueError(
                    f"corrupt nodekey at {path}: {len(key)} bytes "
                    "(expected 32) — refusing to boot with a mangled "
                    "node identity"
                )
            return key
        os.makedirs(data_dir, exist_ok=True)
        key = secrets.token_bytes(32)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        return key

    # ---------------------------------------------------------- services

    def start_rpc(self, host: str = "127.0.0.1", port: int = 8546,
                  key_dir: Optional[str] = None,
                  enable_personal: bool = False) -> int:
        """``enable_personal`` must be requested explicitly (geth's
        --rpcapi personal posture): exposing keystore signing on an
        HTTP endpoint is an operator decision, never a default."""
        from khipu_tpu_torch.jsonrpc import EthService, JsonRpcServer

        service = EthService(
            self.blockchain, self.config, self.tx_pool,
            cluster=self._cluster, tracer=self.tracer,
            read_view=(
                self._serving.read_view
                if self._serving is not None else None
            ),
            serving=self._serving,
            telemetry=self._telemetry,
            reorg_manager=(
                self._regular_sync.reorg
                if self._regular_sync is not None else None
            ),
        )
        extra = ()
        keystore_dir = key_dir or (
            os.path.join(self.config.db.data_dir, "keystore")
            if self.config.db.data_dir
            else None
        )
        if enable_personal and keystore_dir is not None:
            from khipu_tpu_torch.jsonrpc.personal_service import PersonalService
            from khipu_tpu_torch.keystore import KeyStore

            extra = (
                PersonalService(
                    KeyStore(keystore_dir), self.blockchain,
                    self.config, self.tx_pool,
                ),
            )
        self._rpc_server = JsonRpcServer(
            service, host, port, extra_services=extra,
            serving=self._serving,
        )
        return self._rpc_server.start()

    def start_bridge(self, host: str = "127.0.0.1",
                     port: int = 50051) -> int:
        """The bridge (bridge.py, HTTP transport): ``ExecuteBlocks``
        commits on the board's device (the plain versions on a CPU
        board), through the windowed commit at
        ``commit_window_blocks > 1``."""
        from khipu_tpu_torch.bridge import BridgeServer

        self._bridge_server = BridgeServer(
            self.blockchain, self.config, tracer=self.tracer,
            device=self.device,
        )
        return self._bridge_server.start(host, port)

    @property
    def bridge(self):
        return self._bridge_server

    def start_network(self, host: str = "127.0.0.1", port: int = 30303) -> int:
        from khipu_tpu_torch.network.host_service import HostService
        from khipu_tpu_torch.network.messages import Status
        from khipu_tpu_torch.network.peer import PeerManager

        def status_factory() -> Status:
            best = self.blockchain.best_block_number
            header = self.blockchain.get_header_by_number(best)
            genesis = self.blockchain.get_header_by_number(0)
            return Status(
                63,
                self.config.blockchain.chain_id,
                self.blockchain.get_total_difficulty(best) or 0,
                header.hash,
                genesis.hash,
            )

        self._peer_manager = PeerManager(
            self.node_key, "khipu-tpu-torch", status_factory
        )
        HostService(self.blockchain).install(self._peer_manager)
        return self._peer_manager.listen(host, port)

    def start_cluster(self, probe: bool = True):
        """Join the sharded node-cache cluster (cluster/ package; the
        P6 DistributedNodeStorage role scaled out): the account and
        storage node stores become cluster-backed read-throughs —
        every local miss consults the replica shards before giving up
        — and the health monitor keeps the ring honest. Requires
        ``config.cluster.endpoints``."""
        cc = self.config.cluster
        if not cc.endpoints:
            raise RuntimeError("config.cluster.endpoints is empty")
        from khipu_tpu_torch.cluster import HealthMonitor, ShardedNodeClient
        from khipu_tpu_torch.storage.remote import RemoteReadThroughNodeStorage

        # the cluster's last-resort fallback reads the LOCAL stores
        # only — captured before wrapping, so a total-cluster outage
        # cannot recurse back through the read-through wrappers
        inners = (
            self.storages.account_node_storage,
            self.storages.storage_node_storage,
            self.storages.evmcode_storage,
        )

        def local_only(h):
            for s in inners:
                v = s.get(h)
                if v is not None:
                    return v
            return None

        self._cluster = ShardedNodeClient(
            cc.endpoints,
            replication=cc.replication,
            vnodes=cc.vnodes,
            max_retries=cc.max_retries,
            backoff_base=cc.backoff_base,
            backoff_max=cc.backoff_max,
            breaker_failures=cc.breaker_failures,
            breaker_reset=cc.breaker_reset,
            local_get=local_only,
            rpc_deadline=cc.rpc_deadline,
            jitter_seed=cc.jitter_seed,
        )
        self.storages.account_node_storage = (
            RemoteReadThroughNodeStorage.from_cluster(
                self.storages.account_node_storage, self._cluster
            )
        )
        self.storages.storage_node_storage = (
            RemoteReadThroughNodeStorage.from_cluster(
                self.storages.storage_node_storage, self._cluster
            )
        )
        if probe:
            self._cluster_health = HealthMonitor(
                self._cluster,
                interval=cc.probe_interval,
                down_after=cc.down_after,
                up_after=cc.up_after,
            )
            self._cluster_health.start()
        return self._cluster

    @property
    def cluster(self):
        return self._cluster

    # -------------------------------------------------- elastic membership

    def _ensure_rebalancer(self):
        """Lazy rebalance driver (cluster/rebalance.py), wired into the
        watchdog (``rebalance_stuck``) and the admission plane
        (``rebalance_pressure``) when those exist."""
        if self._cluster is None:
            raise RuntimeError("start_cluster first")
        if self._rebalancer is None:
            from khipu_tpu_torch.cluster import Rebalancer

            cc = self.config.cluster
            self._rebalancer = Rebalancer(
                self._cluster,
                batch=cc.rebalance_batch,
                pressure=cc.rebalance_pressure,
                log=print,
            )
            if self._watchdog is not None:
                self._watchdog.attach_rebalance(
                    self._rebalancer.watch_source
                )
            if self._serving is not None:
                from khipu_tpu_torch.serving import rebalance_pressure

                self._serving.admission.add_signal(
                    rebalance_pressure(self._rebalancer)
                )
        return self._rebalancer

    @property
    def rebalancer(self):
        return self._rebalancer

    def join_shard(self, endpoint: str) -> int:
        """Live scale-out: stream the key ranges ``endpoint`` gains in
        the next ring epoch onto it, then cut the ring over atomically
        — reads keep flowing (and keep being correct) throughout.
        Returns the number of keys streamed. Crash-safe: an
        interrupted join leaves the committed epoch serving;
        ``board.rebalancer.recover()`` resumes or rolls back."""
        return self._ensure_rebalancer().join(endpoint)

    def retire_shard(self, endpoint: str) -> int:
        """Live scale-in: stream the retiring shard's owned ranges to
        the survivors, cut over, then drop it from the membership and
        the health prober. Returns the number of keys streamed."""
        return self._ensure_rebalancer().retire(endpoint)

    def start_serving(self, **kwargs):
        """Stand up the serving plane (serving/ package —
        docs/serving.md): the read-your-writes view + SLO-aware
        admission control the RPC server and sync drivers share. Call
        BEFORE start_rpc / start_regular_sync so both pick it up — the
        order mirrors how the pieces depend on each other (the plane
        needs only the blockchain and pool, the servers need the
        plane)."""
        from khipu_tpu_torch.serving import ServingPlane

        kwargs.setdefault("telemetry", self._telemetry)
        self._serving = ServingPlane.build(
            self.blockchain, self.config, tx_pool=self.tx_pool,
            **kwargs,
        )
        return self._serving

    @property
    def serving(self):
        return self._serving

    def start_telemetry(self, endpoints=None):
        """Stand up the cluster telemetry plane
        (observability/telemetry.py — docs/observability.md): a
        ``ClusterTelemetry`` poller scraping every shard's registry over
        the ``GetMetrics`` bridge RPC, plus the pipeline stall
        ``Watchdog``. Returns ``None`` when
        ``config.telemetry.enabled`` is False — the zero-cost contract:
        no threads, no RPCs, bit-exact replay.

        Call AFTER ``start_cluster`` (breaker state feeds the health
        score) and around ``start_serving`` in either order — an
        existing serving plane gains the cluster-pressure signal here;
        a later ``start_serving`` should pass
        ``telemetry=board.telemetry``."""
        tc = self.config.telemetry
        if not tc.enabled:
            return None
        from khipu_tpu_torch.observability.telemetry import (
            ClusterTelemetry,
            Watchdog,
        )

        eps = tuple(
            endpoints if endpoints is not None
            else self.config.cluster.endpoints
        )
        self._telemetry = ClusterTelemetry(
            eps, config=tc, cluster=self._cluster, tracer=self.tracer,
        )
        self._telemetry.start()
        if tc.watchdog:
            self._watchdog = Watchdog(
                config=tc,
                journal_depth=(
                    (lambda: self.storages.window_journal.depth)
                    if self.config.sync.commit_journal else None
                ),
                telemetry=self._telemetry,
                tracer=self.tracer,
                rebalance=(
                    self._rebalancer.watch_source
                    if self._rebalancer is not None else None
                ),
            )
            self._watchdog.start()
        if self._serving is not None:
            from khipu_tpu_torch.serving import cluster_pressure

            self._serving.admission.add_signal(
                cluster_pressure(self._telemetry)
            )
        return self._telemetry

    @property
    def telemetry(self):
        return self._telemetry

    def start_regular_sync(self, **kwargs):
        """Tip-following block import over the peer pool
        (RegularSyncService.scala role); requires start_network. The
        import commits on the board's device and, with the serving
        plane up, publishes into its read view."""
        from khipu_tpu_torch.sync.regular_sync import RegularSyncService

        if self._peer_manager is None:
            raise RuntimeError("start_network first")
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("cluster", self._cluster)
        if self._serving is not None:
            kwargs.setdefault("read_view", self._serving.read_view)
        self._regular_sync = RegularSyncService(
            self.blockchain, self.config, self._peer_manager, **kwargs
        )
        if self._watchdog is not None:
            # reorg-rate storm detector samples the switch counter
            self._watchdog.attach_reorg(
                self._regular_sync.reorg.watch_source
            )
        if self._rpc_server is not None:
            # RPC came up first: hang the filter manager's reorg hook
            # on the freshly-built switch path
            svc = getattr(self._rpc_server, "service", None)
            fm = getattr(svc, "_filter_manager", None)
            if fm is not None:
                self._regular_sync.reorg.add_listener(fm.note_reorg)
        return self._regular_sync

    def start_fast_sync(self, **kwargs):
        """Pivot choice + multi-peer state download
        (FastSyncService.scala role); requires start_network."""
        from khipu_tpu_torch.sync.fast_sync_service import FastSyncService

        if self._peer_manager is None:
            raise RuntimeError("start_network first")
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("cluster", self._cluster)
        self._fast_sync = FastSyncService(
            self.blockchain, self.config, self._peer_manager, **kwargs
        )
        return self._fast_sync

    def start_discovery(self, host: str = "127.0.0.1", port: int = 30303) -> int:
        from khipu_tpu_torch.network.discovery import DiscoveryService

        self._discovery = DiscoveryService(self.node_key, host, port)
        self._discovery.start()
        return self._discovery.port

    @property
    def peer_manager(self):
        return self._peer_manager

    # ---------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        """CoordinatedShutdown (Khipu.scala:58-66): services first,
        storages flushed+closed last."""
        for svc in (self._rpc_server, self._bridge_server,
                    self._peer_manager, self._discovery,
                    self._cluster_health, self._watchdog,
                    self._telemetry):
            if svc is not None:
                try:
                    svc.stop()
                except Exception:
                    pass
        if self._cluster is not None:
            try:
                self._cluster.close()
            except Exception:
                pass
        try:
            from khipu_tpu_torch.ledger.ledger import shutdown_exec_pool

            shutdown_exec_pool()
        except Exception:
            pass
        self.storages.stop()
