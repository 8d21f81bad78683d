"""The port's live rebalance (cluster/rebalance.py) against the JAX
package's.

* ``movement_plan``: the ranges (bounds, sources, gainers) and
  ``moved_fraction`` of joins and retires at replication 1, 2 and 3
  equal the reference's.
* Join then retire on fake shards (paged ``StreamNodeData``): every
  shard's store, the ring's epoch and members, and the counters equal
  the reference's on the same inputs.
* Join then retire on loopback bridges, each package over its own
  bridges (the port's HTTP, the reference's gRPC): memory stores
  streamed in pages, kesque stores shipped in segments, the same count
  of keys streamed at each step as the reference's. Every store ends
  holding the same keys as under the reference, and every key still
  fetches bit-exact.
* Bits flipped at ``bridge.segment.raw`` make a kesque join's segment
  ship fall back to the paged walk in both packages: the same keys
  land, none corrupt.
* A kill (``InjectedDeath``) at each ``rebalance.*`` seam, then
  ``recover``: the same outcome, epoch, members and stores as the
  reference's.

Every server is stopped in ``finally``; every bridge call has a
deadline; a rebalance on bridges runs on a worker thread joined with a
timeout.
"""

import threading

import pytest

from tests.test_torch_bridge import _StoresOnly

DEADLINE_S = 10.0
REBALANCE_TIMEOUT_S = 60.0


def _pkg(name):
    if name == "port":
        from khipu_tpu_torch import bridge
        from khipu_tpu_torch.base.keccak import keccak256
        from khipu_tpu_torch.chaos import FaultPlan, FaultRule, active
        from khipu_tpu_torch.chaos import InjectedDeath
        from khipu_tpu_torch.cluster import (
            HashRing,
            Rebalancer,
            ShardedNodeClient,
            movement_plan,
        )
        from khipu_tpu_torch.cluster.rebalance import moved_fraction
        from khipu_tpu_torch.cluster.ring import _point
        from khipu_tpu_torch.config import KhipuConfig
        from khipu_tpu_torch.storage.storages import Storages
    else:
        from khipu_tpu import bridge
        from khipu_tpu.base.crypto.keccak import keccak256
        from khipu_tpu.chaos import FaultPlan, FaultRule, active
        from khipu_tpu.chaos import InjectedDeath
        from khipu_tpu.cluster import (
            HashRing,
            Rebalancer,
            ShardedNodeClient,
            movement_plan,
        )
        from khipu_tpu.cluster.rebalance import moved_fraction
        from khipu_tpu.cluster.ring import _point
        from khipu_tpu.config import KhipuConfig
        from khipu_tpu.storage.storages import Storages
    return dict(locals())


def _plan_rows(name, members, target, replication):
    p = _pkg(name)
    ring = p["HashRing"](members, replication, 16)
    old, new = ring.begin_transition(target)
    plan = p["movement_plan"](old, new)
    return ([(r.lo, r.hi, r.sources, r.gainers) for r in plan],
            p["moved_fraction"](plan))


PLANS = {
    "join_3_4": (("a", "b", "c"), ("a", "b", "c", "d")),
    "retire_4_3": (("a", "b", "c", "d"), ("a", "c", "d")),
    "join_1_2": (("a",), ("a", "b")),
    "swap": (("a", "b", "c"), ("a", "b", "d")),
}


@pytest.mark.parametrize("replication", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_movement_plan_equals_the_reference(case, replication):
    members, target = PLANS[case]
    port = _plan_rows("port", members, target, replication)
    jax = _plan_rows("jax", members, target, replication)
    assert port == jax
    rows, fraction = port
    assert rows and 0 < fraction <= 1
    if case == "join_3_4" and replication == 1:
        assert fraction < 0.5  # ~1/N of the keyspace, not a reshuffle


def _val(i):
    return b"mpt node rlp bytes #%d" % i


class FakeShard:
    """An in-memory bridge stand-in with the rebalance surface."""

    def __init__(self, point):
        self.store = {}
        self.point = point

    def get_node_data(self, hashes):
        return {h: self.store[h] for h in hashes if h in self.store}

    def put_node_data(self, nodes):
        self.store.update(nodes)
        return len(nodes)

    def stream_node_data(self, ranges, cursor, count):
        keys = sorted(k for k in self.store if cursor < k and any(
            lo <= self.point(k) < hi for lo, hi in ranges))
        page = keys[:count]
        nxt = page[-1] if page else bytes(cursor)
        return len(keys) <= count, nxt, [(k, self.store[k]) for k in page]

    def ping(self, payload=b""):
        return payload

    def close(self):
        pass


def _fake_cluster(name, n_keys=240):
    p = _pkg(name)
    shards = {ep: FakeShard(p["_point"]) for ep in ("a", "b", "c", "d")}
    cl = p["ShardedNodeClient"](["a", "b", "c"], replication=2, vnodes=8,
                                max_retries=1, sleep=lambda s: None,
                                channel_factory=lambda ep: shards[ep])
    rb = p["Rebalancer"](cl, batch=32)
    data = {p["keccak256"](_val(i)): _val(i) for i in range(n_keys)}
    cl.replicate(data)
    return cl, rb, shards, data


def _outcome(cl, rb, shards, data):
    return (cl.ring.epoch, cl.ring.members,
            {ep: sorted(s.store) for ep, s in shards.items()},
            rb.completed, rb.aborts, rb.keys_streamed,
            round(rb.last_moved_fraction, 12),
            cl.fetch(list(data)) == data)


def _join_retire_fake(name):
    cl, rb, shards, data = _fake_cluster(name)
    rb.join("d")
    after_join = _outcome(cl, rb, shards, data)
    rb.retire("a")
    return after_join, _outcome(cl, rb, shards, data)


def test_join_retire_on_fake_shards_equals_the_reference():
    port = _join_retire_fake("port")
    jax = _join_retire_fake("jax")
    assert port == jax
    (e1, m1, *_r1, ok1), (e2, m2, *_r2, ok2) = port
    assert (e2, m2) == (e1 + 1, ("b", "c", "d")) and ok1 and ok2


SEAMS = ("rebalance.plan", "rebalance.stream", "rebalance.cutover",
         "rebalance.retire")


def _kill_then_recover(name, site, after):
    p = _pkg(name)
    cl, rb, shards, data = _fake_cluster(name, 120)
    kind, target = ("retire", "a") if site == "rebalance.retire" else (
        "join", "d")
    plan = p["FaultPlan"](seed=0, rules=[p["FaultRule"](
        site, "die", after=after, times=1)])
    died = False
    with p["active"](plan):
        try:
            getattr(rb, kind)(target)
        except p["InjectedDeath"]:
            died = True
    outcome = rb.recover()
    return (died, outcome, cl.ring.in_transition) + _outcome(
        cl, rb, shards, data)


@pytest.mark.parametrize("after", [0, 2])
@pytest.mark.parametrize("site", SEAMS)
def test_kill_then_recover_equals_the_reference(site, after):
    port = _kill_then_recover("port", site, after)
    jax = _kill_then_recover("jax", site, after)
    assert port == jax
    died, outcome, in_transition, *_rest, reads_ok = port
    assert not in_transition and reads_ok
    if after == 0:
        assert died  # every seam is hit at least once


# ------------------------------------------------- loopback bridges


def _run_bounded(fn, *args):
    """Run a rebalance on a worker thread under a hard deadline."""
    box = {}

    def work():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # reported below
            box["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(REBALANCE_TIMEOUT_S)
    assert not t.is_alive(), f"rebalance exceeded {REBALANCE_TIMEOUT_S} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _bridge_cluster(name, engine, tmp_path, n_keys):
    """Four shards of one package on loopback (three in the ring, one to
    join), replicated with ``n_keys`` nodes; returns what the run reads."""
    p = _pkg(name)
    servers, eps, stores = [], [], []
    cl = None
    try:
        for i in range(4):
            if engine == "kesque":
                st = p["Storages"]("kesque", str(tmp_path / f"{name}{i}"))
            else:
                st = p["Storages"]()
            stores.append(st)
            kw = {"device": "cpu"} if name == "port" else {}
            srv = p["bridge"].BridgeServer(_StoresOnly(st), p["KhipuConfig"](),
                                           **kw)
            eps.append(f"127.0.0.1:{srv.start(port=0)}")
            servers.append(srv)
        # the same endpoint names in both packages (placement hashes
        # them), dialled at each package's own ports
        names = [f"shard-{i}:1" for i in range(4)]
        addr = dict(zip(names, eps))
        cl = p["ShardedNodeClient"](
            names[:3], replication=2, vnodes=16, max_retries=1,
            backoff_base=0.001,
            channel_factory=lambda ep: p["bridge"].BridgeClient(
                addr[ep], deadline=DEADLINE_S))
        rb = p["Rebalancer"](cl, batch=64)
        rb.chunk_bytes = 16 << 10  # several chunks a segment
        data = {p["keccak256"](_val(i)): _val(i) for i in range(n_keys)}
        cl.replicate(data)
        streamed = [_run_bounded(rb.join, names[3])]
        streamed.append(_run_bounded(rb.retire, names[0]))
        keys = [sorted(k for k in st.node_keys() if k in data)
                for st in stores]
        ok = cl.fetch(list(data)) == data
        # the joiner serves its share to a direct call
        direct = p["bridge"].BridgeClient(eps[3], deadline=DEADLINE_S)
        try:
            share = [k for k in data
                     if names[3] in cl.ring.replicas_for(k)]
            served = direct.get_node_data(share) == {k: data[k]
                                                     for k in share}
        finally:
            direct.close()
        return {"streamed": streamed, "keys": keys,
                "epoch": cl.ring.epoch, "members": len(cl.ring.members),
                "reads_ok": ok, "joiner_serves": served,
                "completed": rb.completed,
                "segment_ship": rb.segment_chunks > 0}
    finally:
        if cl is not None:
            cl.close()
        for srv in servers:
            srv.stop()
        for st in stores:
            st.stop()


@pytest.mark.parametrize("engine", ["memory", "kesque"])
def test_join_retire_on_bridges_equals_the_reference(engine, tmp_path):
    port = _bridge_cluster("port", engine, tmp_path, 300)
    jax = _bridge_cluster("jax", engine, tmp_path, 300)
    assert port == jax
    assert port["reads_ok"] and port["joiner_serves"]
    assert port["completed"] == 2 and port["members"] == 3
    assert all(port["streamed"])
    assert port["segment_ship"] == (engine == "kesque")


def _corrupt_ship(name, tmp_path):
    """A kesque join whose every shipped segment chunk is bit-flipped at
    ``bridge.segment.raw``: the receipt scan refuses the chunk, the
    segment ship falls back to the paged ``StreamNodeData`` walk, and
    the join lands exactly the planned keys."""
    p = _pkg(name)
    servers, stores, addr = [], [], {}
    cl = None
    try:
        for i in range(4):
            st = p["Storages"]("kesque", str(tmp_path / f"c{name}{i}"))
            stores.append(st)
            kw = {"device": "cpu"} if name == "port" else {}
            srv = p["bridge"].BridgeServer(_StoresOnly(st), p["KhipuConfig"](),
                                           **kw)
            addr[f"shard-{i}:1"] = f"127.0.0.1:{srv.start(port=0)}"
            servers.append(srv)
        names = sorted(addr)
        cl = p["ShardedNodeClient"](
            names[:3], replication=2, vnodes=16, max_retries=1,
            backoff_base=0.001,
            channel_factory=lambda ep: p["bridge"].BridgeClient(
                addr[ep], deadline=DEADLINE_S))
        rb = p["Rebalancer"](cl, batch=64)
        data = {p["keccak256"](_val(i)): _val(i) for i in range(200)}
        cl.replicate(data)
        e0 = cl.ring.epoch
        plan = p["FaultPlan"](seed=2, rules=[p["FaultRule"](
            "bridge.segment.raw", "corrupt")])
        with p["active"](plan):
            streamed = _run_bounded(rb.join, names[3])
        keys = [sorted(k for k in st.node_keys() if k in data)
                for st in stores]
        return (streamed, cl.ring.epoch - e0, rb.aborts, keys,
                cl.fetch(list(data)) == data)
    finally:
        if cl is not None:
            cl.close()
        for srv in servers:
            srv.stop()
        for st in stores:
            st.stop()


def test_corrupt_segment_chunks_fall_back_to_pages(tmp_path):
    port = _corrupt_ship("port", tmp_path)
    jax = _corrupt_ship("jax", tmp_path)
    assert port == jax
    streamed, moved, aborts, keys, ok = port
    assert streamed > 0 and moved == 1 and aborts == 0 and ok
    assert all(len(set(k)) == len(k) for k in keys)
