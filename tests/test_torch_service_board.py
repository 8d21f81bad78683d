"""The port's node front (service_board.py, __main__.py) and the read
view's wiring into live sync, against the JAX package's.

* Boot recovery: a windowed replay into the ``sqlite`` engine killed at
  ``collector.save`` mid-window, then a ``ServiceBoard`` opened on that
  directory in each package: equal recovery reports and tips, and the
  resume lands on the chain.
* The board wires the serving plane into the RPC service and the
  regular-sync service (read view, reorg listener). Every entry point
  of the bridge, the cluster and its telemetry is driven on loopback
  port bridges: ``start_bridge`` executes the chain over the bridge,
  ``start_cluster`` reads a state through three shards with one
  stopped, ``join_shard`` / ``retire_shard`` move the ring an epoch
  each, ``start_telemetry`` scrapes the shards; ``EthService(cluster=,
  telemetry=)``, ``ServingPlane.build(telemetry=)``,
  ``FleetRouter(telemetry=)``, the two pressure signals and the sync
  services' ``cluster=`` read them.
* ``RegularSyncService(read_view=)``: a windowed batch import publishes
  and retires the same blocks as the reference's; in the port an error
  at ``fused.dispatch`` escapes the import with the overlay invalidated.
* ``python -m khipu_tpu_torch --no-bridge --no-network --rpc-port 0
  --device cpu`` boots, answers, and stops cleanly on SIGTERM; without
  ``--no-bridge`` its bridge answers ``BestBlock`` and it stops cleanly,
  and its ``ExecuteBlocks`` commits through the windowed device commit
  (the plain versions at ``--device cpu``).

Chains: ``tests/test_torch_rpc.py``'s JAX-built ERC-20 chain.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import urllib.request

import pytest

from tests.test_torch_bridge import _StoresOnly
from tests.test_torch_chaos import _namespace, kill
from tests.test_torch_rpc import chain_wire, genesis_alloc, port_node
from tests.test_torch_serving import _blocks, _config, _node, _pkg, record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _board_pkg(name):
    if name == "port":
        from khipu_tpu_torch.config import DbConfig
        from khipu_tpu_torch.domain.blockchain import GenesisSpec
        from khipu_tpu_torch.service_board import ServiceBoard
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.regular_sync import RegularSyncService

        def board(cfg, genesis):
            return ServiceBoard(cfg, genesis, device="cpu")
    else:
        from khipu_tpu.config import DbConfig
        from khipu_tpu.domain.blockchain import GenesisSpec
        from khipu_tpu.service_board import ServiceBoard
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.regular_sync import RegularSyncService

        def board(cfg, genesis):
            return ServiceBoard(cfg, genesis)
    return dict(locals())


def test_boot_recovery_gives_the_same_report(tmp_path):
    base, _ = chain_wire()
    out = {}
    for name in ("port", "jax"):
        b = _board_pkg(name)
        ns = _namespace(name)
        cfg = _config(name, 2)
        data_dir = str(tmp_path / name)
        cfg = dataclasses.replace(cfg, db=b["DbConfig"](
            engine="sqlite", data_dir=data_dir))
        genesis = b["GenesisSpec"](alloc=genesis_alloc())
        bc = ns.Blockchain(b["Storages"]("sqlite", data_dir), cfg)
        if name == "port":
            bc.load_genesis(genesis, on_device=True, device="cpu")
        else:
            bc.load_genesis(genesis)
        blocks = _blocks(name, base)
        driver = (ns.ReplayDriver(bc, cfg, device_commit=True, device="cpu")
                  if name == "port" else ns.ReplayDriver(bc, cfg))
        kill(ns, blocks, cfg, "collector.save", 2, 2, "save",
             expect=ns.CollectorDied, bc=bc, driver=driver)
        bc.storages.stop()
        board = b["board"](cfg, genesis)
        try:
            report = board.recovery_report
            best = board.blockchain.best_block_number
            head = board.blockchain.get_header_by_number(best)
            tip = (best, head.hash, head.state_root)
            resume = (ns.ReplayDriver(board.blockchain, cfg,
                                      device_commit=True, device="cpu")
                      if name == "port"
                      else ns.ReplayDriver(board.blockchain, cfg))
            resume.replay(blocks[best:])
            top = board.blockchain.get_header_by_number(len(blocks))
            journal = board.storages.window_journal.pending()
        finally:
            board.shutdown()
        out[name] = (dataclasses.asdict(report), tip, top.hash, journal)
    assert out["port"] == out["jax"]
    report, tip, top, journal = out["port"]
    assert report["scanned"] >= 1 and report["rolled_back"] >= 1
    assert tip[0] == 2 and journal == []
    assert top == _blocks("port", base)[-1].hash


def test_board_wires_the_serving_plane():
    """start_serving, start_rpc, start_network and start_regular_sync in
    the documented order: the RPC service and the sync import share the
    plane's read view, the filter manager listens on the switch path,
    and the sync commits on the board's device."""
    from khipu_tpu_torch.config import KhipuConfig

    b = _board_pkg("port")
    board = b["board"](KhipuConfig(), b["GenesisSpec"](alloc=genesis_alloc()))
    try:
        plane = board.start_serving()
        port = board.start_rpc(port=0)
        board.start_network(port=0)
        sync = board.start_regular_sync()
        service = board._rpc_server.service
        assert service.read_view is plane.read_view
        assert service.serving is plane and board.serving is plane
        assert sync._driver.read_view is plane.read_view
        assert sync.reorg.read_view is plane.read_view
        assert service._filter_manager.note_reorg in sync.reorg._listeners
        assert str(sync.device) == "cpu"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}",
            json.dumps({"jsonrpc": "2.0", "id": 1,
                        "method": "khipu_metrics"}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            metrics = json.loads(resp.read())["result"]
        assert metrics["serving"]["readView"]["head"] == 0
    finally:
        board.shutdown()


class Shards:
    """Port bridges on loopback holding the base chain's state (every
    node of the port's own replay), stopped by ``close``."""

    def __init__(self, n=3, nodes=None):
        from khipu_tpu_torch.bridge import BridgeServer
        from khipu_tpu_torch.config import KhipuConfig
        from khipu_tpu_torch.storage.storages import Storages

        self._make = lambda: BridgeServer(
            _StoresOnly(Storages()), KhipuConfig(), device="cpu")
        self.servers, self.endpoints = [], []
        try:
            for _ in range(n):
                self.add(nodes)
        except BaseException:
            self.close()
            raise

    def add(self, nodes=None):
        srv = self._make()
        st = srv.blockchain.storages
        st.account_node_storage.update([], dict(nodes or {}))
        self.endpoints.append(f"127.0.0.1:{srv.start(port=0)}")
        self.servers.append(srv)
        return self.endpoints[-1]

    def close(self):
        for srv in self.servers:
            srv.stop()


def _base_state():
    """The port node after the base chain: its nodes and head root."""
    base, _ = chain_wire()
    bc = port_node(wire=base)
    st = bc.storages
    nodes = {}
    for s in (st.account_node_storage, st.storage_node_storage,
              st.evmcode_storage):
        nodes.update(s.source._map)
    return bc, nodes, bc.get_header_by_number(len(base)).state_root


def _cluster_config(endpoints, **tel):
    from khipu_tpu_torch.config import ClusterConfig, TelemetryConfig

    return dataclasses.replace(
        _config("port", 1),
        cluster=ClusterConfig(endpoints=tuple(endpoints), max_retries=1,
                              backoff_base=0.001, rpc_deadline=10.0,
                              probe_interval=0.2),
        telemetry=TelemetryConfig(enabled=True, scrape_interval=0.5,
                                  **tel),
    )


def _walk(storage, root, ref_bc):
    """Every account of the base chain read through ``storage`` equals
    the port node's own read."""
    from khipu_tpu_torch.domain.account import address_key
    from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

    from tests.test_torch_rpc import holder, token_address

    trie = MerklePatriciaTrie(storage, root_hash=root)
    ref = MerklePatriciaTrie(ref_bc.storages.account_node_storage,
                             root_hash=root)
    addrs = list(genesis_alloc()) + [holder(i) for i in range(12)] + [
        token_address()]
    for a in addrs:
        assert trie.get(address_key(a)) == ref.get(address_key(a))
    return len(addrs)


def test_board_bridge_executes_and_answers():
    """``start_bridge``: blocks over the board's bridge commit on the
    board's device, and its reads answer from the board's chain."""
    from khipu_tpu_torch.bridge import BridgeClient

    base, _ = chain_wire()
    b = _board_pkg("port")
    board = b["board"](_config("port", 3),
                       b["GenesisSpec"](alloc=genesis_alloc()))
    cl = None
    try:
        port = board.start_bridge(port=0)
        assert board.bridge.device == board.device
        cl = BridgeClient(f"127.0.0.1:{port}", deadline=30.0)
        out = cl.execute_blocks(_blocks("port", base))
        assert [n for n, _ in out] == list(range(1, len(base) + 1))
        assert cl.best_block() == (len(base), _blocks("port", base)[-1].hash)
        root = cl.get_state_root(len(base))
        assert cl.get_node_data([root]) and root == out[-1][1]
    finally:
        if cl is not None:
            cl.close()
        board.shutdown()


def test_board_cluster_reads_through_and_survives_a_dead_shard():
    """``start_cluster``: the node stores read through three shards (one
    stopped), and the health prober drops the dead one."""
    ref_bc, nodes, root = _base_state()
    shards = Shards(3, nodes)
    board = None
    try:
        shards.servers[2].stop()
        b = _board_pkg("port")
        board = b["board"](_cluster_config(shards.endpoints), None)
        cluster = board.start_cluster(probe=False)
        assert board.cluster is cluster
        assert _walk(board.storages.account_node_storage, root, ref_bc)
        snap = cluster.metrics_snapshot()
        assert snap["unreachable"] == 0
        from khipu_tpu_torch.cluster import HealthMonitor

        mon = HealthMonitor(cluster, down_after=2, up_after=1)
        mon.probe_once()
        mon.probe_once()
        assert shards.endpoints[2] not in cluster.ring.members
    finally:
        if board is not None:
            board.shutdown()
        shards.close()


def test_board_join_and_retire_shard():
    """``join_shard`` / ``retire_shard``: the ring's epoch rises by one
    at each, every node still fetches bit-exact, and the joiner serves
    its share to a direct call."""
    from khipu_tpu_torch.bridge import BridgeClient

    _, nodes, _ = _base_state()
    shards = Shards(3)
    board = None
    try:
        b = _board_pkg("port")
        board = b["board"](_cluster_config(shards.endpoints), None)
        cluster = board.start_cluster(probe=False)
        cluster.replicate(nodes)
        e0 = cluster.ring.epoch
        joiner = shards.add()
        assert board.join_shard(joiner) > 0
        assert cluster.ring.epoch == e0 + 1 and joiner in cluster.ring.members
        assert board.retire_shard(shards.endpoints[0]) > 0
        assert cluster.ring.epoch == e0 + 2
        assert shards.endpoints[0] not in cluster.ring.members
        assert cluster.fetch(list(nodes)) == nodes
        share = [k for k in nodes if joiner in cluster.ring.replicas_for(k)]
        direct = BridgeClient(joiner, deadline=10.0)
        try:
            assert direct.get_node_data(share) == {k: nodes[k] for k in share}
        finally:
            direct.close()
        assert board.rebalancer.completed == 2
        assert cluster.metrics_snapshot()["rebalance"]["completed"] == 2
    finally:
        if board is not None:
            board.shutdown()
        shards.close()


def test_board_telemetry_scrapes_the_shards():
    """``start_telemetry`` after ``start_cluster`` and ``start_serving``:
    the federation scrapes every shard, the serving plane gains the
    cluster signal, the RPC service serves the cluster report, and a
    stopped shard scores below ``health_threshold``."""
    from khipu_tpu_torch.config import KhipuConfig

    shards = Shards(2)
    board = None
    try:
        b = _board_pkg("port")
        board = b["board"](_cluster_config(shards.endpoints), None)
        board.start_cluster(probe=False)
        plane = board.start_serving()
        tel = board.start_telemetry()
        assert board.telemetry is tel
        assert "cluster" in [getattr(s, "signal_name", None)
                             for s in plane.admission.signals]
        assert tel.scrape_once() == 2
        board.start_rpc(port=0)
        report = board._rpc_server.service.khipu_cluster_report()
        assert set(report["shards"]) == set(shards.endpoints)
        assert report.keys() == tel.report().keys()
        shards.servers[1].stop()
        tel.scrape_once()
        scores = tel.health_scores()
        assert scores[shards.endpoints[1]].score < (
            board.config.telemetry.health_threshold)
        assert "khipu_" in board._rpc_server.service.khipu_cluster_metrics_text()
        assert b["board"](KhipuConfig(), None).start_telemetry() is None
    finally:
        if board is not None:
            board.shutdown()
        shards.close()


def test_eth_service_serves_the_cluster():
    """``EthService(cluster=, telemetry=)``: ``khipu_metrics`` carries the
    client's ``cluster`` block and the cluster RPCs answer from the
    telemetry plane."""
    from khipu_tpu_torch.cluster import ShardedNodeClient
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.jsonrpc import EthService
    from khipu_tpu_torch.observability.registry import MetricsRegistry
    from khipu_tpu_torch.observability.telemetry import ClusterTelemetry

    shards = Shards(2)
    cl = None
    try:
        cl = ShardedNodeClient(shards.endpoints, rpc_deadline=10.0)
        tel = ClusterTelemetry(shards.endpoints, cluster=cl,
                               registry=MetricsRegistry())
        tel.scrape_once()
        svc = EthService(port_node(), KhipuConfig(), cluster=cl,
                         telemetry=tel)
        metrics = svc.khipu_metrics()
        assert set(metrics["cluster"]["shards"]) == set(shards.endpoints)
        report = svc.khipu_cluster_report()
        assert set(report["shards"]) == set(shards.endpoints)
        assert report.keys() == tel.report().keys()
        assert svc.khipu_cluster_metrics_text() == tel.cluster_text()
    finally:
        if cl is not None:
            cl.close()
        shards.close()


class _Replica:
    def __init__(self, name):
        self.name = name

    def alive(self):
        return True


class _MetricsShard:
    def __init__(self, fail):
        from khipu_tpu_torch.observability.registry import MetricsRegistry
        from khipu_tpu_torch.observability.telemetry import (
            decode_metrics,
            encode_metrics,
        )

        self.fail = fail
        self._get = lambda: decode_metrics(encode_metrics(MetricsRegistry()))

    def get_metrics(self):
        if self.fail:
            raise ConnectionError("down")
        return self._get()

    def close(self):
        pass


def _replica_telemetry():
    from khipu_tpu_torch.observability.registry import MetricsRegistry
    from khipu_tpu_torch.observability.telemetry import ClusterTelemetry

    shards = {"r1": _MetricsShard(False), "r2": _MetricsShard(True)}
    tel = ClusterTelemetry(list(shards), client_factory=shards.__getitem__,
                           registry=MetricsRegistry())
    tel.scrape_once()
    return tel


def test_fleet_router_weighs_replicas_by_health():
    """``FleetRouter(telemetry=)``: a replica whose scrape fails weighs
    0 though it is alive; a healthy one weighs its score."""
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.jsonrpc import EthService, JsonRpcServer
    from khipu_tpu_torch.serving.fleet import FleetRouter

    tel = _replica_telemetry()
    primary = JsonRpcServer(EthService(port_node(), KhipuConfig()),
                            "127.0.0.1", 0)
    router = FleetRouter(primary, [_Replica("r1"), _Replica("r2")],
                         telemetry=tel)
    assert router._health(router.replicas[0]) == tel.health_scores()[
        "r1"].score == 1.0
    assert router._health(router.replicas[1]) == 0.0


def test_serving_plane_and_pressure_signals():
    """``ServingPlane.build(telemetry=)``, ``cluster_pressure`` and
    ``rebalance_pressure``: the signals read the federation's worst
    shard and the rebalancer's transition pressure."""
    from khipu_tpu_torch.cluster import Rebalancer, ShardedNodeClient
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.serving import (
        ServingPlane,
        cluster_pressure,
        rebalance_pressure,
    )

    tel = _replica_telemetry()
    plane = ServingPlane.build(port_node(), KhipuConfig(), telemetry=tel)
    names = [getattr(s, "signal_name", None) for s in plane.admission.signals]
    assert "cluster" in names
    sig = cluster_pressure(tel)
    assert sig.signal_name == "cluster" and sig() == tel.pressure() == 1.0
    rb = Rebalancer(ShardedNodeClient(["a:1"],
                                      channel_factory=lambda ep: None),
                    pressure=0.88)
    sig = rebalance_pressure(rb)
    assert sig.signal_name == "rebalance" and sig() == 0.0  # idle


def test_sync_services_ask_the_cluster():
    """The ``cluster=`` argument of ``RegularSyncService`` (the heal asks
    the shards first), ``FastSyncService`` and ``PeerFetchPool``."""
    from khipu_tpu_torch.cluster import ShardedNodeClient
    from khipu_tpu_torch.sync.fast_sync_service import (
        FastSyncService,
        PeerFetchPool,
    )
    from khipu_tpu_torch.sync.regular_sync import RegularSyncService

    _, nodes, root = _base_state()
    shards = Shards(2, nodes)
    cl = None
    try:
        cl = ShardedNodeClient(shards.endpoints, rpc_deadline=10.0)
        cfg = _config("port", 1)
        bc = port_node(cfg)
        sync = RegularSyncService(bc, cfg, None, cluster=cl, device="cpu")
        sync._heal_missing_node(None, root)
        assert sync.cluster_healed == 1
        assert bc.storages.account_node_storage.get(root) == nodes[root]
        fast = FastSyncService(bc, cfg, _NoPeers(), cluster=cl,
                               device="cpu")
        keys = list(nodes)[:50]
        assert fast.pool.fetch_nodes(keys) == {k: nodes[k] for k in keys}
        assert fast.pool.cluster_served == 50
        pool = PeerFetchPool(_NoPeers(), cluster=cl)
        assert pool.fetch_nodes(keys[:5]) == {k: nodes[k] for k in keys[:5]}
    finally:
        if cl is not None:
            cl.close()
        shards.close()


class _NoPeers:
    peers = []


def test_regular_sync_import_publishes_into_the_read_view():
    """``RegularSyncService(read_view=)``'s windowed batch import: the
    same publications and retirements as the reference's."""
    base, _ = chain_wire()
    out = {}
    for name in ("port", "jax"):
        cfg = _config(name, 2)
        bc = _node(name, cfg)
        view = _pkg(name)["ReadView"](bc)
        log = record(view, window=2)
        kw = {"device": "cpu"} if name == "port" else {}
        svc = _board_pkg(name)["RegularSyncService"](
            bc, cfg, None, read_view=view, **kw)
        done = svc._import_windowed(_blocks(name, base))
        out[name] = (done, log, view.snapshot())
    assert out["port"] == out["jax"]
    done, log, snap = out["port"]
    assert done == len(base) and snap["retired"] == len(base)
    assert log["invalidate"] == []


def test_regular_sync_device_error_invalidates_the_view():
    """In the port a raise at ``fused.dispatch`` escapes the windowed
    import (no per-block fallback hides it) and leaves nothing above
    the durable chain in the overlay."""
    ns = _namespace("port")
    base, _ = chain_wire()
    cfg = _config("port", 2)
    bc = port_node(cfg)
    view = _pkg("port")["ReadView"](bc)
    log = record(view)
    svc = _board_pkg("port")["RegularSyncService"](bc, cfg, None,
                                                   read_view=view,
                                                   device="cpu")
    plan = ns.FaultPlan(seed=1, rules=[ns.FaultRule("fused.dispatch",
                                                    "raise")])
    with ns.active(plan):
        with pytest.raises(ns.InjectedFault):
            svc._import_windowed(_blocks("port", base))
    snap = view.snapshot()
    assert log["invalidate"] == [0] and snap["overlayBlocks"] == 0
    assert snap["invalidated"] == snap["published"] > 0
    assert bc.best_block_number == 0


def _cli(*extra, timeout=60):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "khipu_tpu_torch", "--device", "cpu",
         "--no-network", "--rpc-port", "0", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_cli_boots_answers_and_stops_on_sigterm():
    proc = _cli("--no-bridge")
    try:
        lines = []
        for _ in range(10):
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("JSON-RPC on "):
                break
        url = lines[-1].split(" on ", 1)[1].strip()
        assert url.startswith("http://127.0.0.1:"), lines
        req = urllib.request.Request(
            url, json.dumps({"jsonrpc": "2.0", "id": 1,
                             "method": "eth_blockNumber"}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["result"] == "0x0"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, err
    assert lines[0].startswith("chain head: #0")
    assert out.strip().endswith("shut down cleanly")


def test_cli_default_start_serves_its_bridge():
    """Without ``--no-bridge`` the node starts its bridge: it answers
    ``BestBlock`` and the node shuts down cleanly on SIGTERM."""
    from khipu_tpu_torch.bridge import BridgeClient

    proc = _cli("--bridge-port", "0")
    cl = None
    try:
        lines = []
        for _ in range(10):
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("bridge on "):
                break
        target = lines[-1].split(" on ", 1)[1].strip()
        cl = BridgeClient(target, deadline=10.0)
        number, head = cl.best_block()
        assert number == 0 and len(head) == 32
        assert cl.ping(b"up") == b"up"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if cl is not None:
            cl.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, err
    assert out.strip().endswith("shut down cleanly")


def test_cli_bridge_commits_windowed_on_its_device(monkeypatch, capsys):
    """The CLI's default bridge commits on ``--device`` through the
    windowed device commit: a batch of 16 blocks is two windows of 8,
    each one K5 (the plain fixpoint on the CPU) and no host window, and
    every answered root is its header's."""
    from khipu_tpu_torch import __main__ as cli
    from khipu_tpu_torch.bridge import BridgeClient
    from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.chain_builder import ChainBuilder
    from khipu_tpu_torch.trie import fused

    resolves = []
    resolve = fused.resolve_levels

    def counted(*a, **k):
        resolves.append(1)
        return resolve(*a, **k)

    monkeypatch.setattr(fused, "resolve_levels", counted)
    board = cli.start_node(cli.parse_args(
        ["--device", "cpu", "--no-rpc", "--no-network", "--bridge-port",
         "0"]))
    cl = None
    try:
        assert board.bridge.device == board.device
        assert board.config.sync.commit_window_blocks == 8
        port = capsys.readouterr().out.split("bridge on ")[1].split(":")[1]
        builder = ChainBuilder(Blockchain(Storages(), board.config),
                               board.config, GenesisSpec())
        blocks = [builder.add_block(coinbase=bytes([0xC0 + i]) * 20)
                  for i in range(16)]
        before = dict(WINDOW_GAUGES)
        cl = BridgeClient(f"127.0.0.1:{int(port)}", deadline=30.0)
        out = cl.execute_blocks(blocks)
        assert out == [(b.number, b.header.state_root) for b in blocks]
        assert len(resolves) == 2
        assert WINDOW_GAUGES["device_windows"] - before["device_windows"] == 2
        assert WINDOW_GAUGES["host_windows"] == before["host_windows"]
    finally:
        if cl is not None:
            cl.close()
        board.shutdown()
