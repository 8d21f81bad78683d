"""The port's replica fleet (serving/replica.py, serving/fleet.py,
serving/router.py, the metrics codec) against the JAX package's.

* Read tokens cross both ways byte for byte, and the same seed gives the
  same health-weighted pick-2.
* The metrics payload a replica's scrape surface answers in is
  byte-equal, and each package decodes the other's.
* A replica (its commits on the CPU: the plain K1r) tails a primary to
  its head; reads through the router keep zero stale answers while a
  replica fails over mid-load; a chain switch on the primary reaches a
  lagging replica's log filter as ``removed: true`` retractions once
  its tail mirrors the switch — equal JSON in both packages — and
  ``chaos.check_token_floor`` holds on the port's router.

Chains: ``tests/test_torch_rpc.py``'s JAX-built ERC-20 chain and fork.
Replica tails are driven by ``tail_once`` where the two packages are
compared; every thread and wait is bounded and stopped in ``finally``.
"""

import dataclasses
import json
import random
import threading
import time

import pytest

from tests.test_torch_rpc import (
    FORK_ANCESTOR,
    MINER_A,
    N_SENDERS,
    chain_wire,
    genesis_alloc,
    jx_config,
    sender_keys,
    token_address,
)
from tests.test_torch_serving import _blocks

from khipu_tpu_torch import workloads

WAIT_S = 20.0


def _pkg(name):
    if name == "port":
        from khipu_tpu_torch import chaos
        from khipu_tpu_torch.config import ServingConfig
        from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu_torch.jsonrpc import EthService, JsonRpcServer
        from khipu_tpu_torch.observability import telemetry
        from khipu_tpu_torch.observability.registry import MetricsRegistry
        from khipu_tpu_torch.serving import loadgen
        from khipu_tpu_torch.serving.fleet import FleetRouter
        from khipu_tpu_torch.serving.readview import ReadView
        from khipu_tpu_torch.serving.replica import (
            PrimaryFeed,
            ReplicaDriver,
        )
        from khipu_tpu_torch.serving.router import ReadToken, pick2
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.reorg import ReorgManager
        from khipu_tpu_torch.sync.replay import ReplayDriver, ReplayStats
    else:
        from khipu_tpu import chaos
        from khipu_tpu.config import ServingConfig
        from khipu_tpu.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu.jsonrpc import EthService, JsonRpcServer
        from khipu_tpu.observability import telemetry
        from khipu_tpu.observability.registry import MetricsRegistry
        from khipu_tpu.serving import loadgen
        from khipu_tpu.serving.fleet import FleetRouter
        from khipu_tpu.serving.readview import ReadView
        from khipu_tpu.serving.replica import PrimaryFeed, ReplicaDriver
        from khipu_tpu.serving.router import ReadToken, pick2
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.reorg import ReorgManager
        from khipu_tpu.sync.replay import ReplayDriver, ReplayStats
    return dict(locals())


def _config(name):
    if name == "port":
        cfg = workloads.replay_config()
    else:
        cfg = jx_config()
    serving = _pkg(name)["ServingConfig"](replica_poll_interval=0.002,
                                          ryw_wait_s=0.5)
    return dataclasses.replace(cfg, serving=serving)


class Primary:
    """A full primary node: store, read view, replay driver, journaled
    reorg, RPC service and server, synced block by block through
    ``blocks[:upto]``."""

    def __init__(self, name, blocks, upto):
        p = self.p = _pkg(name)
        self.name = name
        self.cfg = cfg = _config(name)
        self.genesis = p["GenesisSpec"](alloc=genesis_alloc())
        self.bc = p["Blockchain"](p["Storages"](), cfg)
        self.view = p["ReadView"](self.bc)
        if name == "port":
            self.bc.load_genesis(self.genesis, on_device=True, device="cpu")
            self.driver = p["ReplayDriver"](
                self.bc, cfg, device_commit=True, device="cpu",
                read_view=self.view)
        else:
            self.bc.load_genesis(self.genesis)
            self.driver = p["ReplayDriver"](self.bc, cfg,
                                            read_view=self.view)
        self.reorg = p["ReorgManager"](self.bc, cfg, driver=self.driver,
                                       read_view=self.view)
        self.service = p["EthService"](self.bc, cfg, read_view=self.view,
                                       reorg_manager=self.reorg)
        self.server = p["JsonRpcServer"](self.service)
        self.stats = p["ReplayStats"]()
        if name == "port":
            from khipu_tpu_torch.sync.replay import PHASES

            self.stats.phases = {k: 0.0 for k in PHASES}
        for b in blocks[:upto]:
            self.import_block(b)
        self.feed = p["PrimaryFeed"](self.bc)

    def import_block(self, block):
        self.driver._execute_and_insert(block, self.stats)

    def replica(self, rname):
        kw = {"device": "cpu"} if self.name == "port" else {}
        return self.p["ReplicaDriver"](rname, self.feed, self.cfg,
                                       self.genesis, **kw)


def tail_until(replica, number, block_hash=None, limit=200):
    for _ in range(limit):
        h = replica.blockchain.get_header_by_number(number)
        if h is not None and (block_hash is None or h.hash == block_hash):
            return
        replica.tail_once()
    raise AssertionError(f"{replica.name} never reached block {number}")


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def rpc(server, method, *params):
    resp = server.handle({"jsonrpc": "2.0", "id": 1, "method": method,
                          "params": list(params)})
    return json.loads(json.dumps(resp))


# ---------------------------------------------------------------- router


@pytest.mark.parametrize("fields", [
    (1, 7, bytes(range(32))), (1, 0, None), (2**40 + 5, 2**50, b"\xff" * 32)],
    ids=["anchored", "unanchored", "large"])
def test_tokens_read_across_both_ways(fields):
    pt, jx = _pkg("port")["ReadToken"], _pkg("jax")["ReadToken"]
    a, b = pt(*fields), jx(*fields)
    assert a.encode() == b.encode()
    assert dataclasses.astuple(jx.decode(a.encode())) == fields
    assert dataclasses.astuple(pt.decode(b.encode())) == fields


@pytest.mark.parametrize("raw", [None, 7, "zz", "0x12", "0xgg",
                                 "0x" + "00" * 17])
def test_malformed_tokens_decode_to_none_in_both(raw):
    assert _pkg("port")["ReadToken"].decode(raw) is None
    assert _pkg("jax")["ReadToken"].decode(raw) is None


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_same_seed_same_pick2(seed):
    names = ["r1", "r2", "r3", "r4", "r5"]
    weights = {"r1": 1.0, "r2": 0.5, "r3": 0.0, "r4": 0.25, "r5": 0.9}
    got = {}
    for name in ("port", "jax"):
        pick2 = _pkg(name)["pick2"]
        rng = random.Random(seed)
        loads = random.Random(seed + 1)
        load = {n: loads.randrange(4) for n in names}
        picks = []
        for _ in range(300):
            picks.append(pick2(rng, names, weights.get, load.get))
            load[picks[-1]] = (load[picks[-1]] + 1) % 5
        got[name] = picks
    assert got["port"] == got["jax"]
    assert "r3" not in got["port"] and len(set(got["port"])) == 4
    for name in ("port", "jax"):
        assert _pkg(name)["pick2"](random.Random(seed), ["x"],
                                   lambda c: 0.0, lambda c: 0) is None


def test_metrics_codec_byte_equal():
    """The replica's scrape payload: one registry a package with the
    same families encodes to the same bytes, and each package decodes
    the other's."""
    out = {}
    for name in ("port", "jax"):
        p = _pkg(name)
        reg = p["MetricsRegistry"]()
        reg.gauge("khipu_replica_lag_blocks").set(3)
        reg.counter("khipu_fleet_requests_total",
                    labels={"route": "replica"}).inc(41)
        reg.histogram("khipu_rpc_latency_seconds",
                      buckets=(0.001, 0.01, 0.1),
                      labels={"method": "eth_call"}).observe(0.005)
        out[name] = p["telemetry"].encode_metrics(reg)
    assert out["port"] == out["jax"]
    pt_dec = _pkg("port")["telemetry"].decode_metrics(out["jax"])
    jx_dec = _pkg("jax")["telemetry"].decode_metrics(out["port"])
    assert pt_dec == jx_dec
    assert pt_dec["khipu_rpc_latency_seconds"][2][0][1]["count"] == 1


# ----------------------------------------------------------------- fleet


def test_replica_tails_to_head():
    """A started replica catches the primary up to its head: the same
    hashes and state root, lag 0, its scrape surface alive; killed, its
    scrape fails and its health is 0."""
    base, _ = chain_wire()
    primary = Primary("port", _blocks("port", base), len(base))
    replica = primary.replica("r1")
    try:
        replica.start()
        # the tail pass counts its blocks after the last one is in, so
        # the head can show before the count does
        wait_for(lambda: replica.blockchain.best_block_number == len(base)
                 and replica.blocks_applied == len(base),
                 "the replica did not reach the head")
        for n in range(len(base) + 1):
            assert (replica.blockchain.get_header_by_number(n).hash
                    == primary.bc.get_header_by_number(n).hash)
        assert replica.lag_blocks() == 0 and replica.alive()
        fams = replica.get_metrics()
        assert fams["khipu_replica_lag_blocks"][2] == [({}, 0)]
        assert replica.snapshot()["blocksApplied"] == len(base)
    finally:
        replica.kill()
    assert not replica.alive()
    with pytest.raises(ConnectionError):
        replica.get_metrics()


def test_failover_under_load_serves_no_stale_read():
    """Reads with tokens through the router while the primary imports the
    chain block by block and one replica is killed mid-load: zero
    checker violations, zero errors, replicas served reads, and the
    killed one served none after its death."""
    p = _pkg("port")
    base, _ = chain_wire()
    blocks = _blocks("port", base)
    primary = Primary("port", blocks, 1)
    replicas = [primary.replica("r1"), primary.replica("r2")]
    router = p["FleetRouter"](primary.server, replicas,
                              reorg_manager=primary.reorg, seed=3)
    done = threading.Event()

    def feed():
        try:
            for b in blocks[1:]:
                primary.import_block(b)
                time.sleep(0.03)
        finally:
            done.set()

    t = threading.Thread(target=feed, daemon=True)
    try:
        for r in replicas:
            r.start()
        t.start()
        _, addrs = sender_keys()
        lg = p["loadgen"]
        gen = lg.LoadGenerator(
            lg.InProcessTransport(router), lg.READ_ONLY, clients=3,
            seed=9, max_requests=60,
            nonce_addresses=["0x" + a.hex() for a in addrs[:N_SENDERS]],
            balance_addresses=["0x" + MINER_A.hex()])
        killer = threading.Timer(0.05, replicas[0].kill)
        killer.start()
        report = gen.run()
        killer.join(WAIT_S)
        t.join(WAIT_S)
        assert done.is_set()
        wait_for(lambda: replicas[1].blockchain.best_block_number
                 == len(base), "the live replica did not catch up")
        assert report.violations == [] and report.errors == 0
        assert report.requests == 180
        assert router.snapshot()["readsReplica"] > 0
        assert not replicas[0].alive() and replicas[1].alive()
        # after the failover no read reaches the dead replica
        dead_reads = []
        handle = replicas[0].server.handle
        replicas[0].server.handle = (
            lambda *a: dead_reads.append(a) or handle(*a))
        before = router.snapshot()["readsReplica"]
        for _ in range(20):
            resp = router.handle({"jsonrpc": "2.0", "id": 1,
                                  "method": "eth_blockNumber", "params": []})
            assert int(resp["result"], 16) == len(base)
        assert dead_reads == []
        assert router.snapshot()["readsReplica"] > before
    finally:
        for r in replicas:
            r.kill()
        t.join(WAIT_S)


def _lagging_replica_scenario(name):
    """Primary and replica at the base head; the replica's log filter
    delivers the base logs; the primary switches to the fork while the
    replica's tail is idle; then the tail mirrors the switch."""
    base, fork = chain_wire()
    primary = Primary(name, _blocks(name, base), len(base))
    replica = primary.replica("lag")
    router = primary.p["FleetRouter"](primary.server, [replica],
                                      reorg_manager=primary.reorg)
    tail_until(replica, len(base))
    token = "0x" + token_address().hex()
    fid = rpc(replica.server, "eth_newFilter",
              {"fromBlock": "0x1", "address": token})["result"]
    delivered = rpc(replica.server, "eth_getFilterChanges", fid)
    retracted = [(n, primary.bc.get_header_by_number(n).hash)
                 for n in range(FORK_ANCESTOR + 1, len(base) + 1)]
    primary.reorg.switch(FORK_ANCESTOR, _blocks(name, fork[FORK_ANCESTOR:]))
    idle = rpc(replica.server, "eth_getFilterChanges", fid)
    tail_until(replica, len(fork),
               primary.bc.get_header_by_number(len(fork)).hash)
    changes = rpc(replica.server, "eth_getFilterChanges", fid)
    floor = primary.p["chaos"].check_token_floor(router, retracted,
                                                 FORK_ANCESTOR)
    tip = replica.blockchain.get_header_by_number(len(fork))
    return (delivered, idle, changes, replica.snapshot()["switchesMirrored"],
            (tip.hash, tip.state_root), floor.ok)


def test_retraction_reaches_a_lagging_replica():
    got = {name: _lagging_replica_scenario(name) for name in ("port", "jax")}
    assert got["port"] == got["jax"]
    delivered, idle, changes, mirrored, _, floor_ok = got["port"]
    base, fork = chain_wire()
    assert len(delivered["result"]) == (len(base) - 1) * N_SENDERS
    assert idle["result"] == []
    removed = [h for h in changes["result"] if h["removed"]]
    assert len(removed) == (len(base) - FORK_ANCESTOR) * N_SENDERS
    assert len(changes["result"]) - len(removed) == (
        len(fork) - FORK_ANCESTOR) * N_SENDERS
    assert mirrored == 1 and floor_ok


# ------------------------------------------------------------ the seams


@pytest.mark.parametrize("after", [0, 1, 3, 5])
def test_tail_death_leaves_a_prefix_and_resumes(after):
    """A ``die`` at ``replica.tail`` after ``after`` hits fail-stops the
    tail mid-batch: the replica's chain is a hash-exact prefix of the
    primary's, the same in both packages, and the resumed tail reaches
    the head."""
    base, _ = chain_wire()
    got = {}
    for name in ("port", "jax"):
        primary = Primary(name, _blocks(name, base), len(base))
        replica = primary.replica(f"die-{after}")
        chaos = primary.p["chaos"]
        plan = chaos.FaultPlan(seed=after, rules=[chaos.FaultRule(
            "replica.tail", "die", after=after, times=1)])
        died = False
        try:
            with chaos.active(plan):
                tail_until(replica, len(base))
        except chaos.InjectedDeath:
            died = True
        best = replica.blockchain.best_block_number
        prefix = all(replica.blockchain.get_header_by_number(n).hash
                     == primary.bc.get_header_by_number(n).hash
                     for n in range(best + 1))
        tail_until(replica, len(base))
        got[name] = (died, best, prefix,
                     replica.blockchain.get_header_by_number(
                         len(base)).state_root)
    assert got["port"] == got["jax"]
    died, best, prefix, _ = got["port"]
    assert died and prefix and best < len(base)


def test_route_death_kills_one_request_not_the_router():
    """A ``die`` at ``fleet.route``: that request dies, nothing stays in
    flight, and the next read through the router answers with a token
    (both packages)."""
    base, _ = chain_wire()
    got = {}
    for name in ("port", "jax"):
        primary = Primary(name, _blocks(name, base), len(base))
        replica = primary.replica("route")
        tail_until(replica, len(base))
        replica._started = True  # alive without a tail thread
        replica._thread = threading.current_thread()
        router = primary.p["FleetRouter"](primary.server, [replica],
                                          reorg_manager=primary.reorg)
        chaos = primary.p["chaos"]
        plan = chaos.FaultPlan(seed=1, rules=[chaos.FaultRule(
            "fleet.route", "die", after=2, times=1)])
        answered = 0
        with pytest.raises(chaos.InjectedDeath):
            with chaos.active(plan):
                for _ in range(5):
                    rpc(router, "eth_blockNumber")
                    answered += 1
        resp = router.handle({"jsonrpc": "2.0", "id": 1,
                              "method": "eth_getBalance",
                              "params": ["0x" + MINER_A.hex(), "latest"]})
        token = primary.p["ReadToken"].decode(resp["khipuToken"])
        got[name] = (answered, sum(router._inflight.values()),
                     resp["result"], dataclasses.astuple(token),
                     router.snapshot()["readsReplica"])
    assert got["port"] == got["jax"]
    answered, inflight, _, token, reads = got["port"]
    assert answered == 2 and inflight == 0 and reads == 3
    assert token[1] == len(base)

