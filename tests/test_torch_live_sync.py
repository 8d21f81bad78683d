"""Live sync over RLPx loopback: a port client synced from a JAX-package
server, held against a JAX client synced the same way.

Each regular-sync case of ``tests/test_regular_sync.py`` runs twice over
the same JAX-built chains served by JAX ``PeerManager`` + ``HostService``
nodes: once with a JAX client, once with a port client
(``RegularSyncService(..., device="cpu")``, the plain versions of the
card path). Both must end with the same best block, the same canonical
hashes, receipts and reachable account, storage and code nodes at the
head. Likewise fast sync (``tests/test_fast_sync_service.py``), a
windowed import, the collector death of ``test_chaos.py``, a port miner
pushing to a JAX client, and keystore files across the packages.

Where the port differs on purpose, the case says so: an error of the
device path (a dead collector under fail-stop, a raise at the
``fused.dispatch`` seam) escapes the port's ``sync_once`` instead of
being logged away, and ``recover`` settles the torn window.

Every socket, request and wait is bounded.
"""

import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

from khipu_tpu.base.crypto.secp256k1 import (
    privkey_to_pubkey,
    pubkey_to_address,
)
from khipu_tpu.config import SyncConfig as JaxSyncConfig
from khipu_tpu.config import fixture_config as jax_fixture_config
from khipu_tpu.domain.blockchain import Blockchain as JaxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JaxGenesisSpec
from khipu_tpu.domain.transaction import Transaction as JaxTransaction
from khipu_tpu.domain.transaction import sign_transaction as jax_sign
from khipu_tpu.network.host_service import HostService as JaxHostService
from khipu_tpu.network.messages import Status as JaxStatus
from khipu_tpu.network.peer import PeerManager as JaxPeerManager
from khipu_tpu.storage.storages import Storages as JaxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JaxChainBuilder
from khipu_tpu.sync.replay import ReplayDriver as JaxReplayDriver

PRIV_A = (0xA11CE).to_bytes(32, "big")
PRIV_B = (0xB0B).to_bytes(32, "big")
SENDER_KEY = (7).to_bytes(32, "big")
SENDER = pubkey_to_address(privkey_to_pubkey(SENDER_KEY))
ALLOC = {SENDER: 10**24}
TIMEOUT = 5.0

SYNC = dict(parallel_tx=False, tx_workers=2, commit_window_blocks=1,
            block_resolving_depth=20)
JCFG = dataclasses.replace(jax_fixture_config(chain_id=1),
                           sync=JaxSyncConfig(**SYNC))


# ---------------------------------------------------------------- chains


def build_chain(n_blocks, diverge_at=None, fork_coinbase=b"\xbb" * 20,
                cfg=JCFG):
    """test_regular_sync.py's fixture chain, built by the JAX package."""
    builder = JaxChainBuilder(JaxBlockchain(JaxStorages(), cfg), cfg,
                              JaxGenesisSpec(alloc=ALLOC))
    blocks = []
    for n in range(1, n_blocks + 1):
        coinbase = (fork_coinbase if diverge_at is not None
                    and n >= diverge_at else b"\xaa" * 20)
        tx = jax_sign(JaxTransaction(n - 1, 10**9, 21_000,
                                     bytes.fromhex("%040x" % (0xD00D + n)),
                                     1), SENDER_KEY, chain_id=1)
        blocks.append(builder.add_block([tx], coinbase=coinbase))
    return blocks


_CHAINS = {}


def chain(*key):
    if key not in _CHAINS:
        _CHAINS[key] = build_chain(*key)
    return _CHAINS[key]


def serving_node(blocks, cfg=JCFG):
    bc = JaxBlockchain(JaxStorages(), cfg)
    bc.load_genesis(JaxGenesisSpec(alloc=ALLOC))
    JaxReplayDriver(bc, cfg).replay(blocks)
    return bc


class Box:
    """Mutable holder so a server can switch chains mid-test."""

    def __init__(self, bc):
        self.bc = bc


def status_of(status_cls, box):
    def make():
        bc = box.bc
        best = bc.best_block_number
        return status_cls(
            protocol_version=63, network_id=1,
            total_difficulty=bc.get_total_difficulty(best) or 0,
            best_hash=bc.get_hash_by_number(best),
            genesis_hash=bc.get_hash_by_number(0))
    return make


class SwitchingHost(JaxHostService):
    def __init__(self, box):
        self.box = box

    @property
    def blockchain(self):
        return self.box.bc

    @blockchain.setter
    def blockchain(self, v):
        pass


# --------------------------------------------------------------- clients


def client_ns(name):
    """One package's client side under one set of names. The port's
    entry points run on ``device="cpu"``."""
    if name == "port":
        from khipu_tpu_torch import keystore
        from khipu_tpu_torch.chaos import FaultPlan, FaultRule, active
        from khipu_tpu_torch.config import SyncConfig, fixture_config
        from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu_torch.network.messages import Status
        from khipu_tpu_torch.network.peer import PeerManager
        from khipu_tpu_torch.storage.compactor import compact
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync import regular_sync
        from khipu_tpu_torch.sync.fast_sync_service import (
            FastSyncError,
            FastSyncService,
        )
        from khipu_tpu_torch.sync.replay import CollectorDied, ReplayDriver
        from khipu_tpu_torch.txpool import PendingTransactionsPool

        kw = {"device": "cpu"}

        def driver(bc, cfg):
            return ReplayDriver(bc, cfg, device_commit=True, device="cpu")
    else:
        from khipu_tpu import keystore
        from khipu_tpu.chaos import FaultPlan, FaultRule, active
        from khipu_tpu.config import SyncConfig, fixture_config
        from khipu_tpu.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu.network.messages import Status
        from khipu_tpu.network.peer import PeerManager
        from khipu_tpu.storage.compactor import compact
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync import regular_sync
        from khipu_tpu.sync.fast_sync_service import (
            FastSyncError,
            FastSyncService,
        )
        from khipu_tpu.sync.replay import CollectorDied, ReplayDriver
        from khipu_tpu.txpool import PendingTransactionsPool

        kw = {}

        def driver(bc, cfg):
            return ReplayDriver(bc, cfg)
    ns = SimpleNamespace(**{k: v for k, v in locals().items()
                            if k != "name"})
    ns.name = name
    ns.CFG = dataclasses.replace(fixture_config(chain_id=1),
                                 sync=SyncConfig(**SYNC))

    def fresh(cfg=None):
        bc = Blockchain(Storages(), cfg or ns.CFG)
        bc.load_genesis(GenesisSpec(alloc=ALLOC))
        return bc

    def sync_service(bc, manager, cfg=None, **extra):
        return regular_sync.RegularSyncService(bc, cfg or ns.CFG, manager,
                                               request_timeout=TIMEOUT,
                                               **kw, **extra)

    ns.fresh, ns.sync_service = fresh, sync_service
    return ns


NAMES = ["jax", "port"]


class _Sink:
    def __init__(self):
        self.nodes = {}

    def update(self, removes, upserts):
        self.nodes.update(upserts)


def final_state(ns, bc, upto=None):
    """Best block, canonical hashes, receipts and the reachable nodes at
    the head (or at ``upto``)."""
    best = bc.best_block_number if upto is None else upto
    s = bc.storages
    sinks = [_Sink() for _ in range(3)]
    report = ns.compact(s.account_node_storage, s.storage_node_storage,
                        s.evmcode_storage,
                        bc.get_header_by_number(best).state_root, *sinks,
                        verify_hashes=True)
    assert report.missing == 0 and report.corrupt == 0
    return {
        "best": bc.best_block_number,
        "hashes": [bc.get_hash_by_number(n) for n in range(best + 1)],
        "receipts": [s.receipts_storage.get(n) for n in range(1, best + 1)],
        "nodes": [sink.nodes for sink in sinks],
    }


def run_both(scenario):
    """``scenario(ns)`` with a JAX client and with a port client; their
    final states must be equal. Returns the port's extra results."""
    out = {name: scenario(client_ns(name)) for name in NAMES}
    assert out["port"][0] == out["jax"][0]
    return out


@pytest.fixture
def loopback():
    """connect(server_box, client_ns, client_bc) -> (server, client,
    peer): a JAX server over ``server_box``, a client of ``client_ns``'s
    package; all managers stop at teardown."""
    managers = []

    def connect(server_box, ns, client_bc, server_status=None):
        server = JaxPeerManager(
            PRIV_A, "khipu-tpu/server",
            server_status or status_of(JaxStatus, server_box))
        SwitchingHost(server_box).install(server)
        port = server.listen()
        managers.append(server)
        client = ns.PeerManager(PRIV_B, f"khipu-tpu/{ns.name}",
                                status_of(ns.Status, Box(client_bc)))
        managers.append(client)
        peer = client.connect("127.0.0.1", port, privkey_to_pubkey(PRIV_A),
                              timeout=TIMEOUT)
        return server, client, peer

    yield connect
    for m in managers:
        m.stop()


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# --------------------------------------------------------- regular sync


def test_fresh_node_syncs_50_blocks_with_reorg(loopback):
    chain1, chain2 = chain(30), chain(50, 26)
    assert chain1[24].hash == chain2[24].hash
    assert chain1[25].hash != chain2[25].hash
    serving1, serving2 = serving_node(chain1), serving_node(chain2)

    def scenario(ns):
        box = Box(serving1)
        bc = ns.fresh()
        _, client, _ = loopback(box, ns, bc)
        sync = ns.sync_service(bc, client, batch_size=7)
        sync.run(until=lambda: bc.best_block_number >= 30, max_seconds=60)
        assert bc.get_hash_by_number(30) == chain1[-1].hash
        box.bc = serving2  # the peer switches to a heavier branch
        sync.run(until=lambda: bc.best_block_number >= 50, max_seconds=60)
        assert bc.get_hash_by_number(26) == chain2[25].hash
        assert bc.get_header_by_hash(chain1[-1].hash) is None
        return final_state(ns, bc), (sync.reorgs, sync.imported)

    out = run_both(scenario)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1][0] == 1


def test_lower_td_branch_is_rejected(loopback):
    chain1, short_fork = chain(30), chain(27, 26)
    serving1, serving_short = serving_node(chain1), serving_node(short_fork)

    def scenario(ns):
        box = Box(serving1)
        bc = ns.fresh()
        _, client, _ = loopback(box, ns, bc)
        sync = ns.sync_service(bc, client, batch_size=7)
        sync.run(until=lambda: bc.best_block_number >= 30, max_seconds=60)
        box.bc = serving_short
        assert sync.sync_once() == 0
        assert bc.get_hash_by_number(30) == chain1[-1].hash
        assert sync.reorgs == 0
        return final_state(ns, bc), None

    run_both(scenario)


def test_missing_node_heals_through_peer(loopback):
    blocks = chain(12)
    serving = serving_node(blocks)

    def scenario(ns):
        bc = ns.fresh()
        _, client, _ = loopback(Box(serving), ns, bc)
        sync = ns.sync_service(bc, client, batch_size=4)
        sync.run(until=lambda: bc.best_block_number >= 8, max_seconds=60)
        # vandalize: drop the head's state root node, as a partial
        # write would; the next import heals it from the peer
        root = bc.get_header_by_number(8).state_root
        store = bc.storages.account_node_storage
        store._cache.remove(root)
        store._unconfirmed.source._map.pop(root, None)
        dcache = getattr(store, "_mpt_dcache", None)
        if dcache is not None:
            dcache.pop(root, None)
        sync.run(until=lambda: bc.best_block_number >= 12, max_seconds=60)
        assert sync.healed_nodes >= 1 and store.get(root) is not None
        return final_state(ns, bc), sync.healed_nodes

    out = run_both(scenario)
    assert out["port"][1] == out["jax"][1]


def test_pushed_block_imports_without_pull(loopback):
    """A JAX server broadcasts a sealed block over NewBlock; the client
    imports it on its reader thread (on the port: the per-block device
    commit, K1r's plain version here), with no pull round."""
    from khipu_tpu.sync.regular_sync import broadcast_new_block

    blocks = chain(6)
    serving = serving_node(blocks[:5])

    def scenario(ns):
        bc = ns.fresh()
        server, client, _ = loopback(Box(serving), ns, bc)
        sync = ns.sync_service(bc, client, batch_size=5)
        sync.install_new_block_handler()
        sync.run(until=lambda: bc.best_block_number >= 5, max_seconds=30)
        td = (serving.get_total_difficulty(5) or 0) + \
            blocks[5].header.difficulty
        assert broadcast_new_block(server, blocks[5], td) == 1
        assert wait_for(lambda: bc.best_block_number >= 6)
        assert sync.imported == 6
        return final_state(ns, bc), None

    run_both(scenario)


def test_stale_higher_td_shorter_peer_does_not_wedge(loopback):
    blocks = chain(30)
    box = Box(serving_node(blocks[:20]))

    def lying_status():
        real = status_of(JaxStatus, box)()
        return dataclasses.replace(real,
                                   total_difficulty=real.total_difficulty
                                   * 100)

    def scenario(ns):
        bc = ns.fresh()
        _, client, _ = loopback(box, ns, bc, server_status=lying_status)
        sync = ns.sync_service(bc, client, batch_size=7)
        sync.run(until=lambda: bc.best_block_number >= 20, max_seconds=30)
        from khipu_tpu_torch.domain.block import Block

        rest = blocks[20:] if ns.name == "jax" else [
            Block.decode(b.encode()) for b in blocks[20:]]
        ns.driver(bc, ns.CFG).replay(rest)
        for _ in range(3):
            assert sync.sync_once() == 0
        assert sync.reorgs == 0
        assert not client.blacklist.is_blacklisted(privkey_to_pubkey(PRIV_A))
        return final_state(ns, bc), None

    run_both(scenario)


def test_tx_gossip_mine_and_announce_across_packages(loopback):
    """A JAX node A and a client node B: a tx submitted on A gossips to
    B; B imports a block holding it and propagates it back; A imports
    it and both pools drop the tx. Then a NewBlockHashes announce from A
    is fetched and imported by B's next pull tick."""
    from khipu_tpu.sync.regular_sync import (
        RegularSyncService as JaxSync,
        gossip_pending,
    )
    from khipu_tpu.txpool import PendingTransactionsPool as JaxPool
    from khipu_tpu.network.messages import (
        ETH_OFFSET,
        NEW_BLOCK_HASHES,
        encode_new_block_hashes,
    )

    stx = jax_sign(JaxTransaction(0, 10**9, 21_000, b"\xd0" * 20, 5),
                   SENDER_KEY, chain_id=1)
    builder = JaxChainBuilder(serving_node([]), JCFG,
                              JaxGenesisSpec(alloc=ALLOC))
    mined = builder.add_block([stx], coinbase=b"\xaa" * 20)
    announced = builder.add_block([], coinbase=b"\xaa" * 20)

    def scenario(ns):
        a_bc = serving_node([])
        a_box = Box(a_bc)
        b_bc = ns.fresh()
        server, client, _ = loopback(a_box, ns, b_bc)
        a_pool, b_pool = JaxPool(), ns.PendingTransactionsPool()
        a_sync = JaxSync(a_bc, JCFG, server, txpool=a_pool)
        b_sync = ns.sync_service(b_bc, client, txpool=b_pool)
        assert wait_for(lambda: server.peers), "inbound peer never appeared"
        a_sync.install_new_block_handler()
        b_sync.install_new_block_handler()
        cursor = a_pool.cursor()
        a_pool.add(stx)
        gossip_pending(server, a_pool, cursor)
        assert wait_for(lambda: b_pool.get(stx.hash) is not None)
        from khipu_tpu_torch.domain.block import Block

        block = mined if ns.name == "jax" else Block.decode(mined.encode())
        with b_sync._import_lock:
            b_sync._on_new_block_locked(block)
        assert b_bc.best_block_number == 1 and len(b_pool) == 0
        td = (b_bc.get_total_difficulty(0) or 0) + block.header.difficulty
        assert ns.regular_sync.propagate_block(client, block, td) == 1
        assert wait_for(lambda: a_bc.best_block_number >= 1)
        assert len(a_pool) == 0
        # A takes block 2 locally and announces only its hash
        JaxReplayDriver(a_bc, JCFG).replay([announced])
        server.peers[0].send(ETH_OFFSET + NEW_BLOCK_HASHES,
                             encode_new_block_hashes([(announced.hash, 2)]))
        assert wait_for(lambda: b_sync._announced
                        or b_bc.best_block_number >= 2)
        b_sync.run(until=lambda: b_bc.best_block_number >= 2,
                   max_seconds=20)
        return final_state(ns, b_bc), final_state(ns, b_bc)["hashes"]

    out = run_both(scenario)
    assert out["port"][1][-1] == announced.hash


@pytest.mark.parametrize("contended", [True, False])
def test_announce_backlog_requeue(contended):
    """_drain_announces under _import_lock contention gives the
    unprocessed tail back to the backlog; uncontended, gaps are dropped
    for the pull round (test_regular_sync.py::TestAnnounceBacklogRequeue,
    on the port's service)."""
    import types

    ns = client_ns("port")
    sync = ns.sync_service(ns.fresh(), None)
    if not contended:
        with sync._announce_lock:
            sync._announced.append((b"\x09" * 32, 99, None))
        sync._drain_announces(types.SimpleNamespace(alive=True))
        assert sync._announced == []
        return
    genesis = sync.blockchain.get_header_by_number(0)
    h2, h3 = b"\x02" * 32, b"\x03" * 32
    pairs = [(genesis.hash, 5, None), (h2, 1, None), (h3, 1, None)]
    with sync._announce_lock:
        sync._announced.extend(pairs)
    sync._request_headers = lambda src, n, c: [types.SimpleNamespace(hash=h2)]
    sync._fetch_blocks = lambda src, headers: ["sentinel"]
    assert sync._import_lock.acquire(blocking=False)
    try:
        sync._drain_announces(types.SimpleNamespace(alive=True))
    finally:
        sync._import_lock.release()
    assert sync.imported == 0
    assert sync._announced == pairs[1:]


# ------------------------------------------------- the windowed import


def _windowed_cfg(ns, window, **extra):
    return dataclasses.replace(ns.CFG, sync=dataclasses.replace(
        ns.CFG.sync, commit_window_blocks=window, pipeline_depth=2,
        collector_join_timeout=5.0, adaptive_commit=False, **extra))


def test_windowed_import_at_window_4(loopback):
    """A full fetched batch (batch_size 8) goes through the windowed
    pipeline at commit_window_blocks=4: on the port the fused fixpoint
    and the mirror (their plain versions here), two windows a batch."""
    blocks = chain(16)
    serving = serving_node(blocks)

    def scenario(ns):
        cfg = _windowed_cfg(ns, 4)
        bc = ns.fresh(cfg)
        _, client, _ = loopback(Box(serving), ns, bc)
        sync = ns.sync_service(bc, client, cfg=cfg, batch_size=8)
        logs = []
        sync.log = logs.append
        sync.run(until=lambda: bc.best_block_number >= 16, max_seconds=60)
        assert not [m for m in logs if "fell back" in m or "healing" in m]
        return final_state(ns, bc), None

    port_launches = {}
    from khipu_tpu_torch.trie import fused

    real = fused.resolve_levels

    def counting(*a, **k):
        port_launches["k5"] = port_launches.get("k5", 0) + 1
        return real(*a, **k)

    fused.resolve_levels = counting
    try:
        run_both(scenario)
    finally:
        fused.resolve_levels = real
    assert port_launches.get("k5") == 4, port_launches


def test_collector_death_mid_sync_round_then_recovery(loopback):
    """test_chaos.py::TestRegularSyncCollectorDeath: the collector dies
    right after saving block 1 of window [1, 2] with degradation off.
    The JAX client logs a local round failure (``sync_once`` returns 0);
    the port's ``sync_once`` raises ``CollectorDied`` (a device-path
    failure never turns into a quiet round). Either way the peer is not
    blamed, the torn window awaits recovery, and a recovery pass plus a
    fresh sync service lands the same chain."""
    blocks = chain(8)
    serving = serving_node(blocks)

    def scenario(ns):
        cfg = _windowed_cfg(ns, 2, degrade_on_collector_death=False)
        bc = ns.fresh(cfg)
        _, client, _ = loopback(Box(serving), ns, bc)
        sync = ns.sync_service(bc, client, cfg=cfg, batch_size=8)
        plan = ns.FaultPlan(seed=7, rules=[
            ns.FaultRule("collector.save", "die", after=0, times=1)])
        with ns.active(plan):
            if ns.name == "port":
                with pytest.raises(ns.CollectorDied):
                    sync.sync_once()
            else:
                assert sync.sync_once() == 0
        assert [s for (s, _, _, _) in plan.fired] == ["collector.save"]
        assert not client.blacklist.is_blacklisted(privkey_to_pubkey(PRIV_A))
        assert bc.storages.app_state.best_block_number == 1
        assert bc.get_header_by_number(2) is None
        assert bc.storages.window_journal.pending()
        report = ns.driver(bc, cfg).recover()
        assert report.rolled_back >= 1 and report.best_after == 0
        assert bc.storages.window_journal.pending() == []
        resumed = ns.sync_service(bc, client, cfg=cfg, batch_size=8)
        resumed.run(until=lambda: bc.best_block_number >= 8,
                    max_seconds=60)
        return final_state(ns, bc), None

    run_both(scenario)


def test_fused_dispatch_raise_escapes_the_port_sync_once(loopback):
    """A raise at the ``fused.dispatch`` seam of the only window of a
    2-block batch. The JAX package degrades that window to its host
    hasher and the round imports both blocks. The port does not hash a
    window on the host after a device error: ``InjectedFault`` escapes
    ``sync_once``, nothing of the window is committed, ``recover``
    settles the intent and a fresh round imports the blocks. Both end on
    the same chain."""
    from khipu_tpu.trie.bulk import host_hasher

    blocks = chain(2)
    serving = serving_node(blocks)

    def scenario(ns):
        cfg = _windowed_cfg(ns, 2, device_mirror_commit=False)
        bc = ns.fresh(cfg)
        _, client, _ = loopback(Box(serving), ns, bc)
        if ns.name == "jax":
            sync = ns.sync_service(bc, client, cfg=cfg, batch_size=2,
                                   device_commit=True)
            sync._driver.hasher = host_hasher  # before any XLA compile
        else:
            sync = ns.sync_service(bc, client, cfg=cfg, batch_size=2)
        plan = ns.FaultPlan(seed=3, rules=[
            ns.FaultRule("fused.dispatch", "raise", after=0, times=1)])
        with ns.active(plan):
            if ns.name == "port":
                from khipu_tpu_torch.chaos import InjectedFault

                with pytest.raises(InjectedFault):
                    sync.sync_once()
                assert bc.best_block_number == 0
                assert bc.storages.window_journal.pending()
            else:
                assert sync.sync_once() == 2
        assert plan.fired
        if ns.name == "port":
            report = ns.driver(bc, cfg).recover()
            assert report.rolled_back >= 1
            ns.sync_service(bc, client, cfg=cfg, batch_size=2).run(
                until=lambda: bc.best_block_number >= 2, max_seconds=30)
        return final_state(ns, bc), None

    run_both(scenario)


# what a kernel wrapper raises when a launch is refused or fails: a
# sticky CUDA error, or a tensor on the wrong card (a reader thread that
# resolved another device)
DEVICE_ERRORS = {
    "cuda_error": RuntimeError("CUDA error: an illegal memory access"),
    "wrong_card": ValueError("K1r takes a blob on the card"),
}


@pytest.mark.parametrize("kind", sorted(DEVICE_ERRORS))
def test_pushed_block_device_error_is_kept_for_sync_once(loopback, kind):
    """A device-path error in a pushed block's import on a reader thread
    is not logged away: the next ``sync_once`` raises it (port only). A
    wrapper's ValueError is such an error, not a refused block."""
    from khipu_tpu.sync.regular_sync import broadcast_new_block

    blocks = chain(6)
    serving = serving_node(blocks[:5])
    ns = client_ns("port")
    bc = ns.fresh()
    server, client, _ = loopback(Box(serving), ns, bc)
    sync = ns.sync_service(bc, client, batch_size=5)
    logs = []
    sync.log = logs.append
    sync.install_new_block_handler()
    sync.run(until=lambda: bc.best_block_number >= 5, max_seconds=30)
    boom = DEVICE_ERRORS[kind]

    def failing(block, stats):
        raise boom

    sync._driver._execute_and_insert = failing
    td = (serving.get_total_difficulty(5) or 0) + blocks[5].header.difficulty
    assert broadcast_new_block(server, blocks[5], td) == 1
    assert wait_for(lambda: sync._push_error is not None)
    assert sync._push_error is boom
    with pytest.raises(type(boom), match=str(boom)):
        sync.sync_once()
    assert sync._push_error is None and bc.best_block_number == 5
    assert not [m for m in logs if "rejected" in m]


@pytest.mark.parametrize("path", ["windowed", "per_block"])
def test_wrapper_value_error_escapes_the_port_sync_once(loopback, path):
    """A kernel wrapper's ValueError (here K5's ``resolve_levels`` in a
    window, or the per-block import) escapes ``sync_once`` and ``run``:
    it is not taken for a block the peer got wrong, nor imported again
    block by block. After a windowed one, ``recover`` settles the torn
    window and a fresh round imports the blocks (port only)."""
    from khipu_tpu_torch.trie import fused

    blocks = chain(2)
    serving = serving_node(blocks)
    ns = client_ns("port")
    cfg = _windowed_cfg(ns, 2 if path == "windowed" else 1,
                        device_mirror_commit=False)
    bc = ns.fresh(cfg)
    _, client, _ = loopback(Box(serving), ns, bc)
    sync = ns.sync_service(bc, client, cfg=cfg, batch_size=2)
    logs = []
    sync.log = logs.append
    boom = ValueError("unsupported device cuda:1")
    real = fused.resolve_levels

    def failing(*a, **k):
        raise boom

    if path == "windowed":
        fused.resolve_levels = failing
    else:
        sync._driver._execute_and_insert = lambda block, stats: failing()
    try:
        with pytest.raises(ValueError, match="unsupported device"):
            sync.sync_once()
        with pytest.raises(ValueError, match="unsupported device"):
            sync.run(until=lambda: bc.best_block_number >= 2,
                     max_seconds=10)
    finally:
        fused.resolve_levels = real
    assert bc.best_block_number == 0
    assert not [m for m in logs
                if "failed locally" in m or "per block" in m]
    if path == "windowed":
        assert bc.storages.window_journal.pending()
    ns.driver(bc, cfg).recover()
    assert bc.storages.window_journal.pending() == []
    ns.sync_service(bc, client, cfg=cfg, batch_size=2).run(
        until=lambda: bc.best_block_number >= 2, max_seconds=30)
    assert final_state(ns, bc) == final_state(client_ns("jax"), serving)


# ------------------------------------------------------------ fast sync


# a 2 s request timeout (the JAX test's is 1 s): an honest peer of a
# loaded test host must not be mistaken for the staller
FAST = dict(min_peers_to_choose_pivot=3, pivot_block_offset=3,
            nodes_per_request=16, peer_request_timeout=2.0)


@pytest.fixture
def cluster():
    """Three JAX serving peers over one 20-block chain (peer 2 can
    stall its node-data replies); ``connect(ns)`` makes a fresh client
    of ``ns``'s package connected to all three."""
    from khipu_tpu.network.messages import ETH_OFFSET, GET_NODE_DATA

    cfg = dataclasses.replace(JCFG, sync=dataclasses.replace(JCFG.sync,
                                                             **FAST))
    blocks = chain(20)
    bc = serving_node(blocks, cfg)
    stall = threading.Event()
    managers, servers = [], []
    for i in range(3):
        priv = (0x5E0 + i).to_bytes(32, "big")
        m = JaxPeerManager(priv, f"server{i}", status_of(JaxStatus, Box(bc)))
        JaxHostService(bc).install(m)
        if i == 2:
            real = m.handlers[ETH_OFFSET + GET_NODE_DATA]

            def stalling(body, _real=real):
                if stall.is_set():
                    time.sleep(4.0)  # past the client's 2 s timeout
                    return None
                return _real(body)

            m.handlers[ETH_OFFSET + GET_NODE_DATA] = stalling
        servers.append((m.listen(), privkey_to_pubkey(priv)))
        managers.append(m)

    def connect(ns):
        cfg = dataclasses.replace(ns.CFG, sync=dataclasses.replace(
            ns.CFG.sync, **FAST))
        client_bc = ns.fresh(cfg)
        client = ns.PeerManager((0xC11).to_bytes(32, "big"), "syncer",
                                status_of(ns.Status, Box(client_bc)))
        managers.append(client)
        for port, pub in servers:
            client.connect("127.0.0.1", port, pub, timeout=TIMEOUT)
        return cfg, client_bc, client

    yield blocks, connect, stall
    for m in managers:
        m.stop()


@pytest.mark.parametrize("name", NAMES)
def test_pivot_is_median_minus_offset(cluster, name):
    blocks, connect, _ = cluster
    ns = client_ns(name)
    cfg, bc, client = connect(ns)
    pivot = ns.FastSyncService(bc, cfg, client, **ns.kw).choose_pivot()
    assert pivot.number == 17
    assert pivot.state_root == blocks[16].header.state_root


@pytest.mark.parametrize("name", NAMES)
def test_pivot_requires_min_peers(cluster, name):
    _, connect, _ = cluster
    ns = client_ns(name)
    cfg, bc, client = connect(ns)
    client.peers[0].disconnect()
    with pytest.raises(ns.FastSyncError, match="peers"):
        ns.FastSyncService(bc, cfg, client, **ns.kw).choose_pivot()


def test_full_fast_sync_with_stalling_peer(cluster):
    blocks, connect, stall = cluster
    stall.set()

    def scenario(ns):
        cfg, bc, client = connect(ns)
        svc = ns.FastSyncService(bc, cfg, client, **ns.kw)
        state = svc.run()
        assert svc.pool.blacklisted == 1
        assert client.blacklist.is_blacklisted(client.peers[2].remote_pub)
        assert bc.best_block_number == 17
        assert bc.storages.app_state.fast_sync_done
        return final_state(ns, bc), state.downloaded_nodes

    out = run_both(scenario)
    assert out["port"][1] == out["jax"][1] > 20


# ----------------------------------------------------- miner, keystore


def test_port_miner_propagates_a_block_a_jax_client_imports(loopback):
    """``Miner(peer_manager=)`` on a port node seals block 1 (seal-less
    dev chain) and pushes it; a JAX client connected to it imports the
    block on its reader thread."""
    from khipu_tpu.sync.regular_sync import RegularSyncService as JaxSync
    from khipu_tpu_torch.mining import Miner

    ns = client_ns("port")
    port_bc = ns.fresh()
    pool = ns.PendingTransactionsPool()
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        recover_senders,
        sign_transaction,
    )

    stx = sign_transaction(Transaction(0, 10**9, 21_000, b"\xd0" * 20, 5),
                           SENDER_KEY, chain_id=1)
    recover_senders([stx])
    pool.add(stx)
    server = ns.PeerManager(PRIV_A, "port-miner",
                            status_of(ns.Status, Box(port_bc)))
    port = server.listen()
    jax_bc = serving_node([])
    client = JaxPeerManager(PRIV_B, "jax-client",
                            status_of(JaxStatus, Box(jax_bc)))
    try:
        client.connect("127.0.0.1", port, privkey_to_pubkey(PRIV_A),
                       timeout=TIMEOUT)
        sync = JaxSync(jax_bc, JCFG, client)
        sync.install_new_block_handler()
        assert wait_for(lambda: server.peers)
        block = Miner(port_bc, ns.CFG, pool, b"\xaa" * 20,
                      peer_manager=server).mine_next()
        assert len(pool) == 0
        assert wait_for(lambda: jax_bc.best_block_number >= 1)
        assert jax_bc.get_hash_by_number(1) == block.hash
        assert sync.imported == 1
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_keystore_files_decrypt_across_packages(tmp_path, writer, reader):
    w, r = client_ns(writer).keystore, client_ns(reader).keystore
    priv = (0x5EC7E7).to_bytes(32, "big")
    keyfile = w.encrypt_key(priv, "pass phrase", scrypt_n=1 << 10)
    wallet = r.decrypt_key(keyfile, "pass phrase")
    assert wallet.private_key == priv
    assert wallet.address == pubkey_to_address(privkey_to_pubkey(priv))
    with pytest.raises(r.KeyStoreError):
        r.decrypt_key(keyfile, "wrong")
    store_dir = str(tmp_path / "keys")
    address = w.KeyStore(store_dir).import_key(priv, "pw")
    assert r.KeyStore(store_dir).list_accounts() == [address]
    assert r.KeyStore(store_dir).unlock(address, "pw").private_key == priv
