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
a block). ``start_serving`` builds the serving plane whose read view
``start_regular_sync`` hands to the windowed import. The gRPC bridge,
the sharded cluster, its telemetry and live rebalancing are not ported
(ROADMAP A11): ``start_bridge``, ``start_cluster``, ``start_telemetry``,
``join_shard`` and ``retire_shard`` raise ``NotImplementedError``.
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

_A11 = "is not ported (ROADMAP A11: the bridge and the sharded cluster)"


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
        self._peer_manager = None
        self._discovery = None
        self._regular_sync = None
        self._fast_sync = None
        self._serving = None

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
            tracer=self.tracer,
            read_view=(
                self._serving.read_view
                if self._serving is not None else None
            ),
            serving=self._serving,
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

    def start_bridge(self, host: str = "127.0.0.1", port: int = 50051,
                     device_commit: bool = False) -> int:
        """The gRPC bridge: not ported (ROADMAP A11). The machine with
        the card has no gRPC package, so its transport is A11's first
        decision."""
        raise NotImplementedError(f"the gRPC bridge {_A11}")

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
        """Join the sharded node-cache cluster: not ported (ROADMAP
        A11)."""
        raise NotImplementedError(f"the sharded node-cache cluster {_A11}")

    # -------------------------------------------------- elastic membership

    def join_shard(self, endpoint: str) -> int:
        """Live scale-out: not ported (ROADMAP A11)."""
        raise NotImplementedError(f"live rebalancing {_A11}")

    def retire_shard(self, endpoint: str) -> int:
        """Live scale-in: not ported (ROADMAP A11)."""
        raise NotImplementedError(f"live rebalancing {_A11}")

    def start_serving(self, **kwargs):
        """Stand up the serving plane (serving/ package —
        docs/serving.md): the read-your-writes view + SLO-aware
        admission control the RPC server and sync drivers share. Call
        BEFORE start_rpc / start_regular_sync so both pick it up — the
        order mirrors how the pieces depend on each other (the plane
        needs only the blockchain and pool, the servers need the
        plane)."""
        from khipu_tpu_torch.serving import ServingPlane

        self._serving = ServingPlane.build(
            self.blockchain, self.config, tx_pool=self.tx_pool,
            **kwargs,
        )
        return self._serving

    @property
    def serving(self):
        return self._serving

    def start_telemetry(self, endpoints=None):
        """The cluster telemetry plane: not ported (ROADMAP A11)."""
        raise NotImplementedError(f"the cluster telemetry plane {_A11}")

    def start_regular_sync(self, **kwargs):
        """Tip-following block import over the peer pool
        (RegularSyncService.scala role); requires start_network. The
        import commits on the board's device and, with the serving
        plane up, publishes into its read view."""
        from khipu_tpu_torch.sync.regular_sync import RegularSyncService

        if self._peer_manager is None:
            raise RuntimeError("start_network first")
        kwargs.setdefault("device", self.device)
        if self._serving is not None:
            kwargs.setdefault("read_view", self._serving.read_view)
        self._regular_sync = RegularSyncService(
            self.blockchain, self.config, self._peer_manager, **kwargs
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
        for svc in (self._rpc_server, self._peer_manager,
                    self._discovery):
            if svc is not None:
                try:
                    svc.stop()
                except Exception:
                    pass
        try:
            from khipu_tpu_torch.ledger.ledger import shutdown_exec_pool

            shutdown_exec_pool()
        except Exception:
            pass
        self.storages.stop()
