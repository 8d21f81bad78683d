"""The port's node front (service_board.py, __main__.py) and the read
view's wiring into live sync, against the JAX package's.

* Boot recovery: a windowed replay into the ``sqlite`` engine killed at
  ``collector.save`` mid-window, then a ``ServiceBoard`` opened on that
  directory in each package: equal recovery reports and tips, and the
  resume lands on the chain.
* The board wires the serving plane into the RPC service and the
  regular-sync service (read view, reorg listener); every entry point
  of the bridge, the cluster and its telemetry raises
  ``NotImplementedError`` naming ROADMAP A11.
* ``RegularSyncService(read_view=)``: a windowed batch import publishes
  and retires the same blocks as the reference's; in the port an error
  at ``fused.dispatch`` escapes the import with the overlay invalidated.
* ``python -m khipu_tpu_torch --no-bridge --no-network --rpc-port 0
  --device cpu`` boots, answers, and stops cleanly on SIGTERM; without
  ``--no-bridge`` it stops with the bridge's ``NotImplementedError``.

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


def _a11_calls():
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.jsonrpc import EthService
    from khipu_tpu_torch.serving import (
        ServingPlane,
        cluster_pressure,
        rebalance_pressure,
    )
    from khipu_tpu_torch.serving.fleet import FleetRouter

    def board():
        b = _board_pkg("port")
        return b["board"](KhipuConfig(), None)

    def eth(**kw):
        return EthService(port_node(), KhipuConfig(), **kw)

    return {
        "start_bridge": lambda: board().start_bridge(port=0),
        "start_cluster": lambda: board().start_cluster(),
        "start_telemetry": lambda: board().start_telemetry(),
        "join_shard": lambda: board().join_shard("127.0.0.1:1"),
        "retire_shard": lambda: board().retire_shard("127.0.0.1:1"),
        "eth_cluster": lambda: eth(cluster=object()),
        "eth_telemetry": lambda: eth(telemetry=object()),
        "plane_telemetry": lambda: ServingPlane.build(
            port_node(), KhipuConfig(), telemetry=object()),
        "fleet_telemetry": lambda: FleetRouter(None, [],
                                               telemetry=object()),
        "rebalance_pressure": lambda: rebalance_pressure(object()),
        "cluster_pressure": lambda: cluster_pressure(object()),
    }


@pytest.mark.parametrize("entry", sorted(_a11_calls()))
def test_a11_entry_points_raise(entry):
    with pytest.raises(NotImplementedError, match="A11"):
        _a11_calls()[entry]()


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


def test_cli_default_bridge_raises_until_ported():
    proc = _cli()
    try:
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode != 0
    assert "NotImplementedError" in err and "A11" in err
    assert "shut down cleanly" in out
