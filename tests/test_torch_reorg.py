"""The port's journaled chain switch (sync/reorg.py, the journal's reorg
records) against the JAX package's, on the same chains.

The chains are the JAX package's ``tests/test_reorg.py`` fixtures, built
in each package: 8 transfer blocks, and a 10-block fork that diverges
after block 5 (another miner, shifted values: the base's blocks 6-8 hold
3 orphaned-only transactions). The port switches on ``device="cpu"``
with the driver's device commit (the plain versions of the card path),
the JAX package on its host path; best blocks, tip hashes, state roots,
recovery reports and pools must be equal.

The TD rule and the regular-sync cases are in
``test_torch_live_sync.py``; the filter retractions, the read view's
fence and the replica's mirrored switch in ``test_torch_serving.py``
and ``test_torch_fleet.py``.
"""

import dataclasses

import pytest

from tests.test_torch_chaos import _namespace

pytestmark = pytest.mark.chaos

MINER_A = b"\xaa" * 20
MINER_B = b"\xbb" * 20


def _reorg_namespace(name):
    ns = _namespace(name)
    if name == "port":
        from khipu_tpu_torch.sync.journal import ReorgRecord, WindowJournal
        from khipu_tpu_torch.sync.reorg import ReorgManager, ReorgTooDeep
        from khipu_tpu_torch.sync.replay import PHASES, ReplayStats
        from khipu_tpu_torch.txpool import PendingTransactionsPool
        from khipu_tpu_torch.domain.block import Block

        def driver(bc, cfg):
            return ns.ReplayDriver(bc, cfg, device_commit=True, device="cpu")

        def stats():
            return ReplayStats(phases={k: 0.0 for k in PHASES})

        def recover(bc, **kw):
            return ns.recover(bc, device="cpu", **kw)
    else:
        from khipu_tpu.domain.block import Block
        from khipu_tpu.sync.journal import ReorgRecord, WindowJournal
        from khipu_tpu.sync.reorg import ReorgManager, ReorgTooDeep
        from khipu_tpu.sync.replay import ReplayStats
        from khipu_tpu.txpool import PendingTransactionsPool

        def driver(bc, cfg):
            return ns.ReplayDriver(bc, cfg)

        def stats():
            return ReplayStats()

        recover = ns.recover
    ns.Block, ns.ReorgRecord, ns.WindowJournal = Block, ReorgRecord, WindowJournal
    ns.ReorgManager, ns.ReorgTooDeep = ReorgManager, ReorgTooDeep
    ns.Pool, ns.new_driver, ns.stats, ns.recover_ = (
        PendingTransactionsPool, driver, stats, recover)
    ns.RCFG = dataclasses.replace(ns.CFG, sync=ns.SyncConfig(
        commit_window_blocks=1, parallel_tx=False))
    return ns


def _tx(ns, i, nonce, to, value, gas_price=10**9):
    return ns.sign_transaction(
        ns.Transaction(nonce, gas_price, 21_000, to, value), ns.KEYS[i],
        chain_id=1)


def build(ns, n, diverge_at=None, value_off=0):
    builder = ns.ChainBuilder(ns.Blockchain(ns.Storages(), ns.RCFG), ns.RCFG,
                              ns.GenesisSpec(alloc=ns.ALLOC))
    blocks, nonces = [], [0, 0, 0, 0]
    for k in range(n):
        i = k % 4
        diverged = diverge_at is not None and k >= diverge_at
        blocks.append(builder.add_block(
            [_tx(ns, i, nonces[i], ns.ADDRS[(i + 1) % 4],
                 100 + k + (value_off if diverged else 0))],
            coinbase=MINER_B if diverged else MINER_A,
            timestamp=10 * (k + 1)))
        nonces[i] += 1
    return builder.blockchain, blocks


@pytest.fixture(scope="module")
def env():
    out = {}
    for name in ("port", "jax"):
        ns = _reorg_namespace(name)
        ns.base_bc, ns.base = build(ns, 8)
        ns.fork_bc, ns.fork = build(ns, 10, diverge_at=5, value_off=1000)
        ns.sweep_base_bc, ns.sweep_base = build(ns, 6)
        ns.sweep_fork_bc, ns.sweep_fork = build(ns, 8, diverge_at=3,
                                                value_off=500)
        out[name] = ns
    for chain in ("base", "fork", "sweep_base", "sweep_fork"):
        assert [b.hash for b in getattr(out["port"], chain)] == [
            b.hash for b in getattr(out["jax"], chain)], chain
    return out


def fresh_node(ns, blocks, upto, config=None):
    config = config or ns.RCFG
    bc = ns.Blockchain(ns.Storages(), config)
    bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
    driver = ns.new_driver(bc, config)
    stats = ns.stats()
    for b in blocks[:upto]:
        driver._execute_and_insert(b, stats)
    return bc, driver


def tip(bc):
    best = bc.best_block_number
    h = bc.get_header_by_number(best)
    return best, h.hash, h.state_root


def report_fields(report):
    return dataclasses.asdict(report)


def both(env, fn):
    """``fn(ns)`` in each package; the results must be equal."""
    got, want = fn(env["port"]), fn(env["jax"])
    assert got == want
    return got


# ------------------------------------------------- the journal records


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reorg_intent_read_across_packages(env, writer):
    """A reorg intent (staged branch, old hashes, orphan transactions)
    written by one package is read whole by the other, and pruned by it
    once settled."""
    from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource

    w = env[writer]
    r = env["jax" if writer == "port" else "port"]
    src = MemoryKeyValueDataSource()
    anc = w.base_bc.get_header_by_number(5)
    old = [b.hash for b in w.base[5:]]
    orphans = [tx for b in w.base[5:] for tx in b.body.transactions]
    w.WindowJournal(src).log_intent(1, 1, b"\x01" * 32, [b"\x02" * 32])
    seq = w.WindowJournal(src).log_reorg_intent(
        5, anc.hash, old, w.fork[5:], orphan_txs=orphans)
    journal = r.WindowJournal(src)
    intent, rec = journal.pending()
    assert intent.lo == intent.hi == 1
    assert isinstance(rec, r.ReorgRecord) and rec.seq == seq == 1
    assert (rec.ancestor_number, rec.ancestor_hash) == (5, anc.hash)
    assert rec.old_hashes == old
    assert rec.adopted_hashes == [b.hash for b in w.fork[5:]]
    assert (rec.old_top, rec.new_top) == (8, 10)
    staged = journal.staged_blocks(rec)
    assert [b.hash for b in staged] == [b.hash for b in w.fork[5:]]
    assert [t.hash for t in rec.orphan_txs()] == [t.hash for t in orphans]
    for s in (0, 1):
        journal.log_commit(s)
    assert journal.prune() == 2 and journal.depth == 0
    assert len(src.keys()) == 2  # head and tail pointers only


def test_reorg_intent_rejects_a_detached_branch(env):
    ns = env["port"]
    j = ns.WindowJournal(ns.Storages().journal_source)
    with pytest.raises(ValueError):
        j.log_reorg_intent(4, b"\x00" * 32, [], ns.fork[5:])
    with pytest.raises(ValueError):
        j.log_reorg_intent(5, b"\x00" * 32, [], [])


# ------------------------------------------------------ settling intents


def test_pending_intent_with_intact_chain_abandons(env):
    def run(ns):
        bc, _ = fresh_node(ns, ns.base, 8)
        journal = bc.storages.window_journal
        anc = bc.get_header_by_number(5)
        journal.log_reorg_intent(5, anc.hash,
                                 [b.hash for b in ns.base[5:]], ns.fork[5:])
        report = ns.recover_(bc, config=ns.RCFG)
        assert report.reorgs_abandoned == 1 and journal.pending() == []
        return report_fields(report), tip(bc)

    got = both(env, run)
    assert got[1][0] == 8 and got[1][1] == env["port"].base[7].hash


def test_torn_switch_rolls_forward_bit_exact(env):
    def run(ns):
        bc, _ = fresh_node(ns, ns.base, 8)
        journal = bc.storages.window_journal
        anc = bc.get_header_by_number(5)
        journal.log_reorg_intent(5, anc.hash,
                                 [b.hash for b in ns.base[5:]], ns.fork[5:])
        bc.remove_block(ns.base[7].hash)  # the tip half removed
        report = ns.recover_(bc, config=ns.RCFG)
        assert report.reorgs_completed == 1 and journal.pending() == []
        return report_fields(report), tip(bc)

    got = both(env, run)
    ns = env["port"]
    assert got[1] == (10, ns.fork[9].hash,
                      ns.fork_bc.get_header_by_number(10).state_root)


def test_torn_switch_rolls_forward_through_the_device_commit(env,
                                                            monkeypatch):
    """The roll-forward re-executes the staged branch with the device
    commit on the given device (K1r on the card; here its plain
    version), never through the host fold."""
    from khipu_tpu_torch.sync import replay

    ns = env["port"]
    calls = []

    def counting(messages, device=None):
        calls.append(str(device))
        return hasher(messages, device=device)

    hasher = replay.device_hasher
    monkeypatch.setattr(replay, "device_hasher", counting)
    bc, _ = fresh_node(ns, ns.base, 8)
    anc = bc.get_header_by_number(5)
    bc.storages.window_journal.log_reorg_intent(
        5, anc.hash, [b.hash for b in ns.base[5:]], ns.fork[5:])
    bc.remove_block(ns.base[7].hash)
    calls.clear()
    report = ns.recover_(bc, config=ns.RCFG)
    assert report.reorgs_completed == 1
    assert tip(bc)[1] == ns.fork[9].hash
    assert len(calls) >= len(ns.fork[5:]) and set(calls) == {"cpu"}


def test_torn_switch_without_config_stops_at_the_ancestor(env):
    def run(ns):
        bc, _ = fresh_node(ns, ns.base, 8)
        journal = bc.storages.window_journal
        anc = bc.get_header_by_number(5)
        pool = ns.Pool()
        orphans = [tx for b in ns.base[5:] for tx in b.body.transactions]
        journal.log_reorg_intent(5, anc.hash,
                                 [b.hash for b in ns.base[5:]], ns.fork[5:],
                                 orphan_txs=orphans)
        bc.remove_block(ns.base[7].hash)
        report = ns.recover_(bc, txpool=pool)
        return (report_fields(report), tip(bc),
                sorted(t.hash for t in pool.pending()))

    got = both(env, run)
    assert got[1][0] == 5 and len(got[2]) == 3


def test_mid_switch_death_recovery_recycles_orphans(env):
    def run(ns):
        bc, driver = fresh_node(ns, ns.base, 8)
        pool = ns.Pool()
        mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver, txpool=pool)
        plan = ns.FaultPlan(seed=7, rules=[
            ns.FaultRule("reorg.adopt", "die", times=1, after=1)])
        with pytest.raises(ns.InjectedDeath):
            with ns.active(plan):
                mgr.switch(5, ns.fork[5:])
        report = ns.recover_(bc, config=ns.RCFG, txpool=pool)
        assert any("recycled" in a for a in report.actions)
        return (report_fields(report), tip(bc),
                sorted(t.hash for t in pool.pending()))

    got = both(env, run)
    orphans = {tx.hash for b in env["port"].base[5:]
               for tx in b.body.transactions}
    assert got[1][0] == 10 and set(got[2]) == orphans


def test_too_deep_reorg_refused_and_counted(env):
    def run(ns):
        shallow = dataclasses.replace(
            ns.RCFG, db=dataclasses.replace(ns.RCFG.db, unconfirmed_depth=2))
        bc, driver = fresh_node(ns, ns.base, 8, config=shallow)
        mgr = ns.ReorgManager(bc, shallow, driver=driver)
        with pytest.raises(ns.ReorgTooDeep):
            mgr.switch(5, ns.fork[5:])
        samples = {n: v for n, _k, _l, v in mgr._registry_samples()}
        return (mgr.refused, tip(bc), samples["khipu_reorg_refused_total"],
                samples["khipu_reorg_total"])

    assert both(env, run)[0] == 1


def test_branch_must_attach_to_the_ancestor(env):
    ns = env["port"]
    bc, driver = fresh_node(ns, ns.base, 8)
    mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver)
    with pytest.raises(ValueError, match="ancestor"):
        mgr.switch(4, ns.fork[5:])
    with pytest.raises(ValueError, match="attach"):
        mgr.switch(5, ns.sweep_fork[5:6])
    assert tip(bc)[0] == 8 and bc.storages.window_journal.pending() == []


# ------------------------------------------------------- clean switches


def test_windowed_adoption(env):
    """A branch of at least ``commit_window_blocks`` blocks adopts through
    the windowed pipeline (the port: the fused fixpoint's plain version
    and the mirror); every intent ends committed and pruned."""
    def run(ns):
        cfg = dataclasses.replace(ns.RCFG, sync=ns.SyncConfig(
            commit_window_blocks=3, parallel_tx=False))
        bc, driver = fresh_node(ns, ns.base, 8, config=cfg)
        mgr = ns.ReorgManager(bc, cfg, driver=driver)
        done = mgr.switch(5, ns.fork[5:])
        assert bc.storages.window_journal.pending() == []
        return done, tip(bc)

    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES

    device0 = WINDOW_GAUGES["device_windows"]
    got = both(env, run)
    ns = env["port"]
    assert got == (5, (10, ns.fork[9].hash,
                       ns.fork_bc.get_header_by_number(10).state_root))
    assert WINDOW_GAUGES["device_windows"] - device0 == 2  # [6..8], [9..10]


def test_clean_switch_counters_and_listeners(env):
    def run(ns):
        bc, driver = fresh_node(ns, ns.base, 8)
        pool = ns.Pool()
        mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver, txpool=pool)
        seen = []
        mgr.add_listener(lambda anc, hits: seen.append((anc, len(hits))))
        mgr.add_listener(lambda anc, hits: 1 / 0)  # a broken observer
        assert mgr.switch(5, ns.fork[5:]) == 5
        return (mgr.switches, mgr.last_depth, mgr.orphaned_blocks,
                mgr.recycled_txs, seen, tip(bc))

    got = both(env, run)
    assert got[:5] == (1, 3, 3, 3, [(5, 0)])


def test_orphans_recycle_under_the_replacement_rules(env):
    """A pooled same-(sender, nonce) transaction that outbids the orphan
    keeps its slot, and a lower bid is replaced."""
    def run(ns):
        bc, driver = fresh_node(ns, ns.base, 8)
        pool = ns.Pool()
        orphans = [tx for b in ns.base[5:] for tx in b.body.transactions]
        rich = _tx(ns, 5 % 4, orphans[0].tx.nonce, orphans[0].tx.to, 1,
                   gas_price=2 * 10**9)
        poor = _tx(ns, 6 % 4, orphans[1].tx.nonce, orphans[1].tx.to, 1,
                   gas_price=1)
        assert pool.add(rich) and pool.add(poor)
        mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver, txpool=pool)
        mgr.switch(5, ns.fork[5:])
        assert pool.get(rich.hash) is not None
        assert pool.get(orphans[0].hash) is None
        assert pool.get(poor.hash) is None
        assert pool.get(orphans[1].hash) is not None
        return mgr.recycled_txs, sorted(t.hash for t in pool.pending())

    assert both(env, run)[0] == 2


def test_adopted_branch_txs_leave_the_pool(env):
    def run(ns):
        bc, driver = fresh_node(ns, ns.base, 8)
        pool = ns.Pool()
        adopted = [tx for b in ns.fork[5:] for tx in b.body.transactions]
        for tx in adopted:
            assert pool.add(tx)
        mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver, txpool=pool)
        mgr.switch(5, ns.fork[5:])
        assert all(pool.get(tx.hash) is None for tx in adopted)
        return mgr.recycled_txs, sorted(t.hash for t in pool.pending())

    assert both(env, run)[0] == 3


# ------------------------------------------------------ 12-seed sweep


SITES = ["reorg.intent", "reorg.rollback", "reorg.adopt", "reorg.finalize"]


def _sweep_outcome(ns, seed):
    site = SITES[seed % len(SITES)]
    after = (seed // len(SITES)) % 6
    bc, driver = fresh_node(ns, ns.sweep_base, 6)
    mgr = ns.ReorgManager(bc, ns.RCFG, driver=driver)
    plan = ns.FaultPlan(seed=seed, rules=[
        ns.FaultRule(site, "die", times=1, after=after)])
    died = False
    try:
        with ns.active(plan):
            mgr.switch(3, ns.sweep_fork[3:])
    except ns.InjectedDeath:
        died = True
    report = report_fields(ns.recover_(bc, config=ns.RCFG)) if died else None
    landed = tip(bc)
    assert bc.storages.window_journal.pending() == []
    if landed[0] == 6:
        # an abandoned switch must not poison the next attempt
        mgr.switch(3, ns.sweep_fork[3:])
        assert tip(bc)[1] == ns.sweep_fork[7].hash
    return died, report, landed


@pytest.mark.parametrize("seed", list(range(0, 120, 10)))
def test_sweep_lands_on_exactly_old_or_new(env, seed):
    """Twelve of the JAX package's 120 seeds (same sites and depths):
    after recovery the node is at exactly the old chain or the new one,
    tip hash and state root bit-exact, with the same outcome and report
    per seed as the JAX package."""
    got = both(env, lambda ns: _sweep_outcome(ns, seed))
    ns = env["port"]
    old_tip = (6, ns.sweep_base[5].hash,
               ns.sweep_base_bc.get_header_by_number(6).state_root)
    new_tip = (8, ns.sweep_fork[7].hash,
               ns.sweep_fork_bc.get_header_by_number(8).state_root)
    died, _, landed = got
    assert landed in (old_tip, new_tip)
    if not died:
        assert landed == new_tip


def test_default_driver_raises_without_card(env, monkeypatch):
    import torch

    ns = env["port"]
    bc, _ = fresh_node(ns, ns.base, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ns.ReorgManager(bc, ns.RCFG)
    mgr = ns.ReorgManager(bc, ns.RCFG, device="cpu")
    assert mgr.driver.device.type == "cpu"
    assert mgr.driver.hasher is not None  # both adoptions commit on it


def test_switch_from_an_ancestor_inside_a_committed_window(env):
    """A chain replayed in windows of 3 stores the states of blocks 3, 6
    and 8 only; block 5, the fork point, has no state. The port rebuilds
    it (re-executing block 4 and 5 from block 3's state) before the
    intent, then adopts the branch and lands on the fork's tip. The JAX
    package's switch fails there with a missing node, after removing
    the old blocks: the node is left at the ancestor without its state
    (ROADMAP C)."""
    out = {}
    for name in ("port", "jax"):
        ns = env[name]
        cfg = dataclasses.replace(ns.RCFG, sync=ns.SyncConfig(
            commit_window_blocks=3, parallel_tx=False))
        bc = ns.Blockchain(ns.Storages(), cfg)
        bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
        driver = ns.new_driver(bc, cfg)
        driver.replay(ns.base)
        root5 = bc.get_header_by_number(5).state_root
        assert bc.storages.account_node_storage.get(root5) is None
        mgr = ns.ReorgManager(bc, cfg, driver=driver)
        try:
            mgr.switch(5, ns.fork[5:])
            out[name] = tip(bc)
            assert mgr.regenerated_blocks == 2  # blocks 4 and 5
        except AssertionError:
            raise
        except Exception as e:  # noqa: BLE001 — the JAX package's fault
            out[name] = type(e).__name__, bc.best_block_number
    ns = env["port"]
    assert out["port"] == (10, ns.fork[9].hash,
                           ns.fork_bc.get_header_by_number(10).state_root)
    assert out["jax"] == ("MPTNodeMissingException", 5)
