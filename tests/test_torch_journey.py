"""The port's transaction passport (khipu_tpu_torch/observability/
journey.py and its stamps) against the JAX package's, on the CPU.

The same chains go through both packages with each package's board on;
every transaction's journey must have the same edges, in the same
order, with the same node and the same tags (``source``, ``batch``,
``lane``, ``index``, ``block``, ``seq``, ``via``, ``reason``, ...):

* the serial, scheduled and optimistic executors (the port's
  ``workloads`` chains of tests/test_torch_parallel_exec.py, replayed
  at window 8, and block by block for the pre-Byzantium optimistic
  merge): ``ingress``, ``schedule`` (batch and predicted lane),
  ``execute`` (the lane that ran), ``seal``, ``journal.intent``,
  ``durable``;
* a depth-2 chain switch (tests/test_torch_reorg.py's chains):
  ``reorg.retract`` then ``reorg.reinclude``, ``via=pool`` for the
  orphaned-only transactions and ``via=mined`` for those the winning
  branch holds again;
* a stage thread killed mid-window, then ``recover`` and the resumed
  replay: the window's journeys stop before ``durable``, gain
  ``journal.rollback``, and pick ``durable`` up on the resume;
* a pool at capacity: ``pool.admit``, ``pool.evict`` (capacity and
  replacement) and ``pool.reject`` (underpriced).

The port replays on ``device="cpu"`` with the device commit; the JAX
package on its host path. ``journey_sampled`` keeps the same hashes in
both. Each test leaves both boards disabled and empty."""

import dataclasses

import numpy as np
import pytest

from khipu_tpu.observability import journey as jx_journey

from khipu_tpu_torch.observability import journey as pt_journey
from tests.test_torch_reorg import _reorg_namespace, build, fresh_node

SEED = 20261018
BOARDS = {"port": pt_journey.JOURNEY, "jax": jx_journey.JOURNEY}


@pytest.fixture(autouse=True)
def _clean_boards():
    for board in BOARDS.values():
        board.disable()
        board.reset()
    yield
    for board in BOARDS.values():
        board.disable()
        board.reset()


def _journeys(name, hashes):
    """Each hash's journey as [(edge, node, detail)] (None: untracked)."""
    board = BOARDS[name]
    out = {}
    for h in hashes:
        j = board.get(h)
        out[h] = None if j is None else [
            (e[1], e[2], e[4]) for e in j.events]
    return out


def _edges(journey):
    return [e[0] for e in journey]


@pytest.mark.parametrize("per_10k", [0, 1, 100, 2_500, 5_000, 9_999,
                                     10_000])
def test_journey_sampled_agrees(per_10k):
    rng = np.random.default_rng([SEED, per_10k])
    hashes = [rng.bytes(32) for _ in range(10_000)]
    got = [pt_journey.journey_sampled(h, per_10k) for h in hashes]
    assert got == [jx_journey.journey_sampled(h, per_10k) for h in hashes]
    if 0 < per_10k < 10_000:
        assert 0 < sum(got) < 10_000


def test_board_retention_agrees():
    """Head sampling, the ring's drop-oldest, pins, the event cap and the
    exported shape on one seeded stamp program."""
    rng = np.random.default_rng(SEED)
    hashes = [rng.bytes(32) for _ in range(40)]
    out = {}
    for name, mod in (("port", pt_journey), ("jax", jx_journey)):
        board = mod.JourneyBoard()
        board.enable(capacity=16, pinned_capacity=4, sample_per_10k=6_000,
                     max_events=5, slow_ms=1e9)
        for i, h in enumerate(hashes):
            board.record(h, "ingress", source="import", block=i)
            for k in range(6):
                board.record(h, "execute", lane="residue", index=k)
            if i % 9 == 0:
                board.record(h, "reorg.retract", ancestor=1, block=i)
            board.record(h, "durable", block=i)
        out[name] = ({h: (j.pin_reason, j.truncated, [e[1:] for e in
                                                      j.events])
                      for h in hashes for j in [board.get(h)] if j},
                     board.events_total, board.evicted_total,
                     board.dropped_events_total, len(board))
        board.disable()
    assert out["port"] == out["jax"]
    assert out["port"][2] > 0 and out["port"][3] > 0


# ------------------------------------------------------------ executors


def _replay_journeys(name, window, parallel, sched_fixture):
    """Replay a parallel-exec chain through both packages with the
    boards on; returns each package's journeys and the hashes."""
    from khipu_tpu.domain.block import Block as JxBlock
    from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
    from khipu_tpu.storage.storages import Storages as JxStorages
    from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.replay import ReplayDriver
    from tests import test_torch_parallel_exec as pe

    make_cfg, spec, wire = pe._chain(sched_fixture)
    prebyz = sched_fixture.startswith("prebyz")
    pt_cfg = make_cfg(parallel_tx=parallel, commit_window_blocks=window)
    jx_cfg = pe._jx_cfg(prebyz, parallel_tx=parallel,
                        commit_window_blocks=window)
    hashes = [stx.hash for w in wire for stx in
              Block.decode(w).body.transactions]
    out = {}
    pe._reset_both()
    BOARDS["port"].enable()
    bc = Blockchain(Storages(), pt_cfg)
    bc.load_genesis(spec, on_device=True, device="cpu")
    ReplayDriver(bc, pt_cfg, device_commit=True, device="cpu").replay(
        [Block.decode(w) for w in wire])
    out["port"] = _journeys("port", hashes)
    BOARDS["jax"].enable()
    jbc = JxBlockchain(JxStorages(), jx_cfg)
    jbc.load_genesis(pe._jx_spec(spec))
    JxReplayDriver(jbc, jx_cfg).replay([JxBlock.decode(w) for w in wire])
    out["jax"] = _journeys("jax", hashes)
    return out, hashes


EXECUTORS = {
    # chain, window, parallel_tx
    "serial": ("erc20_4x40", 8, False),
    "scheduled_calls": ("erc20_4x40", 8, True),
    "scheduled_transfers": ("contended_4x30", 8, True),
    "scheduled_mixed": ("mixed_4x20", 8, True),
    "optimistic": ("prebyz_contended_4x30", 1, True),
}


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_executor_journeys_equal(executor):
    chain, window, parallel = EXECUTORS[executor]
    out, hashes = _replay_journeys(chain, window, parallel, chain)
    assert out["port"] == out["jax"]
    journeys = out["port"]
    assert all(j is not None for j in journeys.values())
    lanes = {d["lane"] for j in journeys.values() for e, _n, d in j
             if e == "execute"}
    for j in journeys.values():
        edges = _edges(j)
        assert edges[0] == "ingress" and edges[-1] == "durable"
        if window > 1:
            assert edges.index("seal") < edges.index("journal.intent") \
                < edges.index("durable")
    if executor == "serial" or executor == "optimistic":
        assert lanes == set()
        assert all(set(_edges(j)) <= {"ingress", "seal", "journal.intent",
                                      "durable"}
                   for j in journeys.values())
    elif executor == "scheduled_calls":
        assert lanes == {"residue", "checked", "vector-call"}
    elif executor == "scheduled_transfers":
        assert "vector-transfer" in lanes
    if executor.startswith("scheduled"):
        # one schedule page a transaction the planner saw (a block of
        # one transaction, the deploy, runs unplanned)
        sched = [[d for e, _n, d in j if e == "schedule"]
                 for j in journeys.values()]
        assert all(len(d) <= 1 for d in sched)
        assert sum(map(len, sched)) >= len(hashes) - 1
        assert all(set(d[0]) == {"batch", "lane"} for d in sched if d)


# ------------------------------------------------------- the chain switch


@pytest.fixture(scope="module")
def reorg_env():
    out = {}
    for name in ("port", "jax"):
        ns = _reorg_namespace(name)
        _, ns.base = build(ns, 8)
        # diverging after block 6 (a depth-2 switch): other transactions
        # (orphaned-only -> the pool), and the same ones (mined again)
        _, ns.fork = build(ns, 10, diverge_at=6, value_off=1000)
        _, ns.mined = build(ns, 10, diverge_at=6, value_off=0)
        out[name] = ns
    return out


@pytest.mark.parametrize("branch", ["fork", "mined"])
def test_reorg_journeys_equal(reorg_env, branch):
    out = {}
    for name, ns in reorg_env.items():
        BOARDS[name].enable()
        bc, driver = fresh_node(ns, ns.base, 8)
        pool = ns.Pool()
        ns.ReorgManager(bc, ns.RCFG, driver=driver, txpool=pool).switch(
            6, getattr(ns, branch)[6:])
        assert bc.best_block_number == 10
        hashes = [stx.hash for b in ns.base + getattr(ns, branch)[6:]
                  for stx in b.body.transactions]
        out[name] = _journeys(name, hashes)
    assert out["port"] == out["jax"]
    ns = reorg_env["port"]
    via = "pool" if branch == "fork" else "mined"
    for b in ns.base[6:]:
        for stx in b.body.transactions:
            j = out["port"][stx.hash]
            edges = _edges(j)
            assert edges.index("durable") < edges.index("reorg.retract") \
                < edges.index("reorg.reinclude")
            assert [d["via"] for e, _n, d in j
                    if e == "reorg.reinclude"] == [via]
            assert BOARDS["port"].get(stx.hash).pin_reason == "retracted"


# --------------------------------------------------------- kill + recover


def test_killed_window_journeys_equal(reorg_env):
    """A stage thread dies after block 5's save in the chain's last
    window ([5..6]: the driver has sealed every window by then, so the
    journal's sequence numbers do not depend on timing); recover rolls
    the window back; the resumed replay commits it again."""
    out = {}
    for name, ns in reorg_env.items():
        cfg = dataclasses.replace(ns.RCFG, sync=ns.SyncConfig(
            parallel_tx=False, commit_window_blocks=2, pipeline_depth=2,
            degrade_on_collector_death=False, collector_join_timeout=5.0,
            adaptive_commit=False))
        _, chain = build(ns, 6)
        BOARDS[name].enable()
        bc = ns.Blockchain(ns.Storages(), cfg)
        bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
        plan = ns.FaultPlan(seed=3, rules=[
            ns.FaultRule("collector.save", "die", after=4, times=1)])
        with ns.active(plan):
            with pytest.raises(ns.CollectorDied):
                ns.new_driver(bc, cfg).replay(chain)
        assert bc.best_block_number == 5
        report = ns.recover_(bc, config=cfg)
        assert report.rolled_back >= 1
        best = bc.best_block_number
        ns.new_driver(bc, cfg).replay(chain[best:])
        assert bc.best_block_number == 6
        out[name] = _journeys(name, [stx.hash for b in chain
                                     for stx in b.body.transactions])
    assert out["port"] == out["jax"]
    ns = reorg_env["port"]
    _, chain = build(ns, 6)
    edges = [_edges(out["port"][b.body.transactions[0].hash])
             for b in chain[4:6]]
    # block 5's records were saved and removed again; block 6 never saved
    assert edges == [
        ["ingress", "seal", "journal.intent", "journal.rollback", "seal",
         "journal.intent", "durable"],
        ["ingress", "seal", "journal.intent", "seal", "journal.intent",
         "durable"]]


# ------------------------------------------------------------------- pool


def test_pool_journeys_equal(reorg_env):
    out = {}
    for name, ns in reorg_env.items():
        from tests.test_torch_reorg import _tx

        BOARDS[name].enable()
        pool = ns.Pool(capacity=2)
        txs = [_tx(ns, 0, 0, ns.ADDRS[1], 1), _tx(ns, 1, 0, ns.ADDRS[2], 2),
               _tx(ns, 2, 0, ns.ADDRS[3], 3)]
        cheap = _tx(ns, 2, 0, ns.ADDRS[3], 4, gas_price=10**9)
        dear = _tx(ns, 2, 0, ns.ADDRS[3], 5, gas_price=2 * 10**9)
        for stx in txs + [cheap, dear]:
            pool.add(stx)
        out[name] = _journeys(name, [s.hash for s in txs + [cheap, dear]])
    assert out["port"] == out["jax"]
    edges = [_edges(j) for j in out["port"].values()]
    assert edges == [["pool.admit", "pool.evict"], ["pool.admit"],
                     ["pool.admit", "pool.evict"], ["pool.reject"],
                     ["pool.admit"]]
    details = [j[-1][2] for j in out["port"].values()]
    assert details == [{"reason": "capacity"}, {"replaced": False},
                       {"reason": "replaced"}, {"reason": "underpriced"},
                       {"replaced": True}]
