"""The port's sharded node-cache cluster (cluster/ring.py, client.py,
health.py) against the JAX package's.

* Placement: ``replicas_for``, ``primary_for``, ``read_chain`` and
  ``write_chains`` of 10,000 keys equal the JAX ring's, on a static ring,
  across a join's transition and its commit, after an abort, and after a
  health removal (the points are keccak-derived, so this is the
  keccak agreeing key for key).
* Retries: the same jitter seed, the same scripted failures of fake
  shards and the same fake clock give the same sleep schedule, the same
  ``metrics_snapshot`` (breaker states included) and the same registry
  samples in both packages.
* ``HealthMonitor`` hysteresis: the same scripted probe outcomes give
  the same verdicts, ring members, transitions and re-join backfills.
* ``PeerFetchPool(cluster=)`` asks the cluster before any peer.
* The chaos seams ``bridge.node.value``, ``cluster.fetch.value``,
  ``bridge.call.*`` and ``cluster.replicate`` on loopback bridges (each
  package over its own): the same counters as the reference's.
* A 3-shard loopback cluster of port bridges, replicated at 2 from a
  JAX-built state, walks that state root through
  ``RemoteReadThroughNodeStorage`` with one shard stopped: every account
  read equals the JAX trie's, and the health prober drops the dead
  shard after ``down_after`` misses.

Every server is stopped in ``finally``; every bridge call has a
deadline.
"""

import pytest

from tests.test_torch_bridge import _StoresOnly
from tests.test_torch_rpc import chain_wire, genesis_alloc, holder
from tests.test_torch_serving import _config, _node

N_KEYS = 10_000
DEADLINE_S = 10.0


def _pkg(name):
    if name == "port":
        from khipu_tpu_torch.base.keccak import keccak256
        from khipu_tpu_torch.cluster import (
            HashRing,
            HealthMonitor,
            ShardedNodeClient,
        )
        from khipu_tpu_torch.cluster.ring import _point
        from khipu_tpu_torch.domain.account import address_key
        from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
        from khipu_tpu_torch.storage.node_storage import NodeStorage
        from khipu_tpu_torch.storage.remote import RemoteReadThroughNodeStorage
        from khipu_tpu_torch.sync.fast_sync_service import PeerFetchPool
        from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie
    else:
        from khipu_tpu.base.crypto.keccak import keccak256
        from khipu_tpu.cluster import (
            HashRing,
            HealthMonitor,
            ShardedNodeClient,
        )
        from khipu_tpu.cluster.ring import _point
        from khipu_tpu.domain.account import address_key
        from khipu_tpu.storage.datasource import MemoryKeyValueDataSource
        from khipu_tpu.storage.node_storage import NodeStorage
        from khipu_tpu.storage.remote import RemoteReadThroughNodeStorage
        from khipu_tpu.sync.fast_sync_service import PeerFetchPool
        from khipu_tpu.trie.mpt import MerklePatriciaTrie
    return dict(locals())


MEMBERS = tuple(f"10.0.0.{i}:7000" for i in range(1, 5))


def _keys(n=N_KEYS):
    kk = _pkg("jax")["keccak256"]
    return [kk(i.to_bytes(4, "big")) for i in range(n)]


def _placements(ring, keys):
    return [(tuple(ring.replicas_for(k)), ring.primary_for(k),
             tuple(ring.read_chain(k)), tuple(ring.write_chains(k)))
            for k in keys]


def _ring_steps(name, scenario):
    """(epoch, members, in_transition, placements) after the
    scenario's steps."""
    ring = _pkg(name)["HashRing"](MEMBERS[:3], 2, 64)
    keys = _keys()
    if scenario in ("join", "join_commit", "join_abort"):
        ring.begin_transition(MEMBERS)
        if scenario == "join_commit":
            ring.commit_transition()
        elif scenario == "join_abort":
            ring.abort_transition()
    elif scenario == "health_remove":
        ring.remove(MEMBERS[1])
    out = [(ring.epoch, ring.members, ring.in_transition,
            _placements(ring, keys))]
    return out


@pytest.mark.parametrize("scenario", ["static", "join", "join_commit",
                                      "join_abort", "health_remove"])
def test_placement_equals_the_reference(scenario):
    port = _ring_steps("port", scenario)
    jax = _ring_steps("jax", scenario)
    assert port == jax
    epoch, members, in_transition, placements = port[-1]
    if scenario == "join":
        assert in_transition
        # mid-move: reads try the new owners first, writes go to both
        assert any(len(w) > len(r) for r, _p, _rc, w in placements)
    assert len(placements) == N_KEYS


def test_ring_points_equal():
    keys = _keys(2_000)
    assert ([_pkg("port")["_point"](k) for k in keys]
            == [_pkg("jax")["_point"](k) for k in keys])


class ScriptedShard:
    """A bridge stand-in whose calls follow a script of outcomes."""

    def __init__(self, store, script):
        self.store = dict(store)
        self.script = list(script)

    def _next(self):
        ok = self.script.pop(0) if self.script else True
        if not ok:
            raise ConnectionError("scripted failure")

    def get_node_data(self, hashes):
        self._next()
        return {h: self.store[h] for h in hashes if h in self.store}

    def put_node_data(self, nodes):
        self._next()
        self.store.update(nodes)
        return len(nodes)

    def ping(self, payload=b""):
        self._next()
        return payload

    def close(self):
        pass


def _vals(n):
    return [b"cluster node value %d" % i for i in range(n)]


def _client_run(name, seed):
    p = _pkg(name)
    kk = p["keccak256"]
    vals = _vals(40)
    store = {kk(v): v for v in vals}
    scripts = {
        "a:1": [False, False, True, False, False, False, False, False],
        "b:2": [True, False, True],
        "c:3": [False] * 3 + [True] * 4,
    }
    shards = {ep: ScriptedShard(store, sc) for ep, sc in scripts.items()}
    tick = [0.0]

    def clock():
        tick[0] += 0.25
        return tick[0]

    slept = []
    cl = p["ShardedNodeClient"](
        list(shards), replication=2, vnodes=16, max_retries=2,
        breaker_failures=3, breaker_reset=2.0, jitter_seed=seed,
        channel_factory=lambda ep: shards[ep], clock=clock,
        sleep=slept.append, local_get=lambda h: None,
    )
    keys = [kk(v) for v in vals] + [kk(b"absent %d" % i) for i in range(4)]
    got = []
    for start in range(0, len(keys), 11):
        got.append(sorted(cl.fetch(keys[start:start + 11]).items()))
    placed = cl.replicate({kk(b"w%d" % i): b"w%d" % i for i in range(6)})
    samples = sorted(
        (n, k, tuple(sorted(lb.items())), v)
        for n, k, lb, v in cl._registry_samples())
    return (got, placed, slept, cl.metrics_snapshot(), samples,
            {ep: b.state for ep, b in cl.breakers.items()})


@pytest.mark.parametrize("seed", [0, 7])
def test_retries_and_breakers_equal_the_reference(seed):
    port = _client_run("port", seed)
    jax = _client_run("jax", seed)
    for mine, ref in zip(port, jax):
        assert mine == ref
    got, _placed, slept, snap, _samples, _states = port
    assert slept  # retries really backed off
    assert sum(len(g) for g in got) == 40
    assert any(s["failures"] for s in snap["shards"].values())


def test_jitter_seeds_decorrelate():
    assert _client_run("port", 0)[2] != _client_run("port", 7)[2]


PROBES = {  # per round: the endpoints that answer
    "flap": [{"a", "b", "c"}, {"a", "c"}, {"a", "b", "c"}, {"a", "c"},
             {"a", "c"}, {"a", "c"}, {"a", "b", "c"}, {"a", "b", "c"}],
    "two_down": [{"a"}, {"a"}, {"a"}, {"a", "b"}, {"a", "b", "c"},
                 {"a", "b", "c"}, {"a", "b", "c"}],
}


def _health_run(name, script, down_after, up_after):
    p = _pkg(name)
    kk = p["keccak256"]
    up = set()
    shards = {ep: ScriptedShard({}, []) for ep in ("a", "b", "c")}
    cl = p["ShardedNodeClient"](
        list(shards), replication=2, vnodes=16, max_retries=0,
        channel_factory=lambda ep: shards[ep], sleep=lambda s: None,
        breaker_failures=1000,
        local_get=lambda h: {kk(b"v%d" % i): b"v%d" % i
                             for i in range(30)}.get(h),
    )
    mon = p["HealthMonitor"](cl, down_after=down_after, up_after=up_after,
                             probe=lambda ep: ep in up)
    trail = []
    for i, alive in enumerate(PROBES[script]):
        up.clear()
        up.update(alive)
        verdict = mon.probe_once()
        # writes while someone is out of the ring become backfill debt
        cl.replicate({kk(b"v%d" % i): b"v%d" % i})
        trail.append((sorted(verdict.items()), cl.ring.members,
                      mon.transitions, cl.metrics_snapshot()["missedKeys"]))
    return trail, {ep: s.store for ep, s in shards.items()}


@pytest.mark.parametrize("script", sorted(PROBES))
@pytest.mark.parametrize("hyst", [(2, 1), (3, 2)], ids=["d2u1", "d3u2"])
def test_health_hysteresis_equals_the_reference(script, hyst):
    port = _health_run("port", script, *hyst)
    jax = _health_run("jax", script, *hyst)
    assert port == jax
    trail, _ = port
    assert trail[-1][2] >= 2  # someone left and came back


class _Manager:
    peers = []

    class blacklist:
        @staticmethod
        def is_blacklisted(pub):
            return False


def test_peer_fetch_pool_asks_the_cluster_first():
    out = {}
    for name in ("port", "jax"):
        p = _pkg(name)
        kk = p["keccak256"]
        store = {kk(v): v for v in _vals(12)}
        shards = {ep: ScriptedShard(store, []) for ep in ("a", "b")}
        cl = p["ShardedNodeClient"](list(shards),
                                    channel_factory=lambda ep: shards[ep])
        pool = p["PeerFetchPool"](_Manager(), cluster=cl)
        got = pool.fetch_nodes(list(store))
        out[name] = (sorted(got.items()), pool.cluster_served)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 12


def _jax_state():
    """The JAX package's node after the base chain: its stores and the
    head's state root."""
    base, _ = chain_wire()
    from tests.test_torch_rpc import jax_blocks
    from khipu_tpu.sync.replay import ReplayDriver

    cfg = _config("jax", 1)
    bc = _node("jax", cfg)
    ReplayDriver(bc, cfg).replay(jax_blocks(base))
    st = bc.storages
    nodes = {}
    for s in (st.account_node_storage, st.storage_node_storage,
              st.evmcode_storage):
        nodes.update(s.source._map)
    return bc, nodes, bc.get_header_by_number(len(base)).state_root


def _addresses():
    from tests.test_torch_rpc import token_address

    return (list(genesis_alloc()) + [holder(i) for i in range(12)]
            + [token_address(), b"\x77" * 20])


def test_loopback_cluster_walks_a_jax_state_with_a_shard_down():
    from khipu_tpu_torch.bridge import BridgeServer
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.storage.storages import Storages

    p = _pkg("port")
    jx = _pkg("jax")
    ref_bc, nodes, root = _jax_state()
    servers, eps = [], []
    cl = None
    try:
        for _ in range(3):
            srv = BridgeServer(_StoresOnly(Storages()), KhipuConfig(),
                               device="cpu")
            eps.append(f"127.0.0.1:{srv.start(port=0)}")
            servers.append(srv)
        cl = p["ShardedNodeClient"](eps, replication=2, vnodes=64,
                                    max_retries=1, backoff_base=0.001,
                                    rpc_deadline=DEADLINE_S)
        placed = cl.replicate(nodes)
        assert placed == 2 * len(nodes)
        servers[1].stop()
        local = p["RemoteReadThroughNodeStorage"].from_cluster(
            p["NodeStorage"](p["MemoryKeyValueDataSource"]()), cl)
        trie = p["MerklePatriciaTrie"](local, root_hash=root)
        ref_trie = jx["MerklePatriciaTrie"](
            ref_bc.storages.account_node_storage, root_hash=root)
        for addr in _addresses():
            key = p["address_key"](addr)
            assert trie.get(key) == ref_trie.get(jx["address_key"](addr))
        assert local.healed > 0
        snap = cl.metrics_snapshot()
        dead = snap["shards"][eps[1]]
        assert dead["failures"] > 0 and snap["unreachable"] == 0
        # the prober drops it after down_after=2 misses; reads go on
        mon = p["HealthMonitor"](cl, down_after=2, up_after=1)
        mon.probe_once()
        assert eps[1] in cl.ring.members
        mon.probe_once()
        assert eps[1] not in cl.ring.members
        fresh = p["MerklePatriciaTrie"](
            p["RemoteReadThroughNodeStorage"].from_cluster(
                p["NodeStorage"](p["MemoryKeyValueDataSource"]()), cl),
            root_hash=root)
        failures = cl.metrics_snapshot()["shards"][eps[1]]["failures"]
        for addr in _addresses():
            assert fresh.get(p["address_key"](addr)) == ref_trie.get(
                jx["address_key"](addr))
        # no read went to the dead shard once it left the ring
        assert cl.metrics_snapshot()["shards"][eps[1]]["failures"] == failures
    finally:
        if cl is not None:
            cl.close()
        for srv in servers:
            srv.stop()


def _chaos(name):
    if name == "port":
        from khipu_tpu_torch import bridge
        from khipu_tpu_torch.chaos import (
            FaultPlan,
            FaultRule,
            InjectedFault,
            active,
        )
        from khipu_tpu_torch.config import KhipuConfig
        from khipu_tpu_torch.storage.storages import Storages
    else:
        from khipu_tpu import bridge
        from khipu_tpu.chaos import FaultPlan, FaultRule, InjectedFault, active
        from khipu_tpu.config import KhipuConfig
        from khipu_tpu.storage.storages import Storages
    return dict(locals())


def _bridges(name, n, store):
    """``n`` bridges of package ``name`` on loopback over one node dict,
    under fixed endpoint names."""
    c = _chaos(name)
    servers, addr = [], {}
    for i in range(n):
        st = c["Storages"]()
        st.account_node_storage.update([], dict(store))
        kw = {"device": "cpu"} if name == "port" else {}
        srv = c["bridge"].BridgeServer(_StoresOnly(st), c["KhipuConfig"](),
                                       **kw)
        addr[f"shard-{i}:1"] = f"127.0.0.1:{srv.start(port=0)}"
        servers.append(srv)
    return servers, addr


def _seam_run(name, site, kind, times):
    """A fetch of 40 keys and a replicate through 3 loopback bridges of
    ``name`` under one rule at ``site``; what came back and the
    counters."""
    p, c = _pkg(name), _chaos(name)
    kk = p["keccak256"]
    store = {kk(v): v for v in _vals(40)}
    servers, addr = _bridges(name, 3, store)
    cl = None
    try:
        cl = p["ShardedNodeClient"](
            sorted(addr), replication=2, vnodes=16, max_retries=1,
            jitter_seed=3, sleep=lambda s: None,
            channel_factory=lambda ep: c["bridge"].BridgeClient(
                addr[ep], deadline=DEADLINE_S))
        plan = c["FaultPlan"](seed=5, rules=[c["FaultRule"](
            site, kind, times=times)])
        with c["active"](plan):
            got = cl.fetch(sorted(store))
            try:
                placed = cl.replicate({kk(b"new"): b"new"})
            except c["InjectedFault"]:
                placed = "InjectedFault"
        snap = cl.metrics_snapshot()
        shards = {ep: {k: v for k, v in m.items() if k != "latencySeconds"}
                  for ep, m in snap["shards"].items()}
        return got == store, placed, shards, snap["unreachable"]
    finally:
        if cl is not None:
            cl.close()
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("site,kind,times", [
    ("bridge.node.value", "corrupt", 3),
    ("cluster.fetch.value", "corrupt", 3),
    ("bridge.call.GetNodeData", "raise", 2),
    ("cluster.replicate", "raise", 1),
], ids=["bridge_value", "fetch_value", "call_raise", "replicate_raise"])
def test_seams_equal_the_reference(site, kind, times):
    """The cluster's chaos seams on loopback bridges: corrupted values
    are never admitted (the next replica serves them), a raised call is
    retried, a raise at ``cluster.replicate`` fails the write; the same
    counters as the reference's."""
    port = _seam_run("port", site, kind, times)
    jax = _seam_run("jax", site, kind, times)
    assert port == jax
    complete, placed, shards, unreachable = port
    assert complete and unreachable == 0
    if kind == "corrupt":
        assert sum(m["corrupt"] for m in shards.values()) == times
    if site == "cluster.replicate":
        assert placed == "InjectedFault"
    else:
        assert placed == 2
