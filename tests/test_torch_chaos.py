"""The port's chaos plane and crash recovery against the JAX package's.

Both packages replay the same 12-block transfer chain (the JAX package's
``tests/test_chaos.py`` fixture, built once in each package, block for
block the same hashes), are killed at the same seam and hit, recover,
and resume. The port runs its card path on ``device="cpu"``
(``device_commit``: the plain K5 and a CPU mirror), the JAX package its
host path; the recovery reports, best blocks and roots must be equal.

A window pipeline runs four stage threads, so how far the driver gets
before it notices a dead stage depends on timing, in either package.
Each kill here is gated: the block source holds the driver after the
dying window's last block until that stage thread is dead and every
earlier window is committed. Then both packages seal exactly one more
window before the liveness check, and the reports compare field for
field. Every wait is bounded.
"""

import dataclasses
import os
import re
import shutil
import threading
import time
from types import SimpleNamespace

import pytest

from khipu_tpu_torch import chaos as pt_chaos
from khipu_tpu_torch.chaos import plan as pt_plan

pytestmark = pytest.mark.chaos

N_BLOCKS = 12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _namespace(name):
    """One package's classes, under the same names."""
    if name == "port":
        from khipu_tpu_torch.base.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu_torch.chaos import (
            FaultPlan,
            FaultRule,
            InjectedDeath,
            InjectedFault,
            active,
        )
        from khipu_tpu_torch.config import SyncConfig, fixture_config
        from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu_torch.domain.transaction import (
            Transaction,
            sign_transaction,
        )
        from khipu_tpu_torch.storage.compactor import verify_reachable
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.chain_builder import ChainBuilder
        from khipu_tpu_torch.sync.journal import recover
        from khipu_tpu_torch.sync.replay import CollectorDied, ReplayDriver

        def driver(bc, cfg):
            # the port's main path: the fused fixpoint and the mirror,
            # their plain versions on the CPU
            return ReplayDriver(bc, cfg, device_commit=True, device="cpu")

        def serial_driver(bc, cfg):
            return ReplayDriver(bc, cfg, device="cpu")
    else:
        from khipu_tpu.base.crypto.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu.chaos import (
            FaultPlan,
            FaultRule,
            InjectedDeath,
            InjectedFault,
            active,
        )
        from khipu_tpu.config import SyncConfig, fixture_config
        from khipu_tpu.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu.domain.transaction import Transaction, sign_transaction
        from khipu_tpu.storage.compactor import verify_reachable
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.chain_builder import ChainBuilder
        from khipu_tpu.sync.journal import recover
        from khipu_tpu.sync.replay import CollectorDied, ReplayDriver

        def driver(bc, cfg):
            return ReplayDriver(bc, cfg)

        serial_driver = driver
    ns = SimpleNamespace(**{k: v for k, v in locals().items()
                            if k not in ("name",)})
    ns.name = name
    ns.CFG = fixture_config(chain_id=1)
    ns.KEYS = [(i + 1).to_bytes(32, "big") for i in range(4)]
    ns.ADDRS = [pubkey_to_address(privkey_to_pubkey(k)) for k in ns.KEYS]
    ns.ALLOC = {a: 1000 * 10**18 for a in ns.ADDRS}
    return ns


def _tx(ns, i, nonce, to, value):
    return ns.sign_transaction(ns.Transaction(nonce, 10**9, 21_000, to, value),
                               ns.KEYS[i], chain_id=1)


def _transfer_chain(ns):
    """The JAX package's chaos fixture: 12 blocks of one transfer."""
    builder = ns.ChainBuilder(ns.Blockchain(ns.Storages(), ns.CFG), ns.CFG,
                              ns.GenesisSpec(alloc=ns.ALLOC))
    blocks, nonces = [], [0, 0, 0, 0]
    for n in range(N_BLOCKS):
        i = n % 4
        blocks.append(builder.add_block(
            [_tx(ns, i, nonces[i], ns.ADDRS[(i + 1) % 4], 100 + n)],
            coinbase=b"\xaa" * 20))
        nonces[i] += 1
    return blocks


def _wide_chain(ns):
    """12 blocks x 2 disjoint transfers: every block takes the scheduled
    fast path (the JAX package's TestExecuteBatchDeath fixture)."""
    builder = ns.ChainBuilder(ns.Blockchain(ns.Storages(), ns.CFG), ns.CFG,
                              ns.GenesisSpec(alloc=ns.ALLOC))
    blocks, nonces = [], [0, 0, 0, 0]
    for n in range(N_BLOCKS):
        a, b = n % 2, 2 + n % 2
        txs = []
        for i, tag in ((a, 0xBEEF0000), (b, 0xFEED0000)):
            to = (tag + n).to_bytes(4, "big").rjust(20, b"\x00")
            txs.append(_tx(ns, i, nonces[i], to, 100 + n))
            nonces[i] += 1
        blocks.append(builder.add_block(txs, coinbase=b"\xaa" * 20))
    return blocks


@pytest.fixture(scope="module")
def env():
    out = {}
    for name in ("port", "jax"):
        ns = _namespace(name)
        ns.chain = _transfer_chain(ns)
        ns.wide = _wide_chain(ns)
        out[name] = ns
    assert [b.hash for b in out["port"].chain] == [
        b.hash for b in out["jax"].chain]
    assert [b.hash for b in out["port"].wide] == [
        b.hash for b in out["jax"].wide]
    return out


def cfg_of(ns, window=2, depth=2, degrade=False, parallel=False):
    return dataclasses.replace(ns.CFG, sync=ns.SyncConfig(
        parallel_tx=parallel, commit_window_blocks=window,
        pipeline_depth=depth, degrade_on_collector_death=degrade,
        collector_join_timeout=5.0, adaptive_commit=False))


def fresh(ns, cfg, storages=None):
    bc = ns.Blockchain(storages or ns.Storages(), cfg)
    bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
    return bc


def gated(blocks, at, until, timeout=20.0):
    """``blocks[:at]``, then a bounded wait until ``until()``, then the
    rest: holds the driver (or its sender prefetcher) after the dying
    window."""
    yield from blocks[:at]
    deadline = time.monotonic() + timeout
    while not until():
        if time.monotonic() > deadline:
            raise AssertionError("the gated kill did not happen in time")
        time.sleep(0.002)
    yield from blocks[at:]


def stage_dead(stage):
    return not any(t.name == f"window-{stage}" and t.is_alive()
                   for t in threading.enumerate())


def committed(bc, n):
    """Every window through block ``n`` saved and commit-marked."""
    s = bc.storages
    return s.app_state.best_block_number >= n and all(
        rec.lo > n for rec in s.window_journal.pending())


def kill(ns, blocks, cfg, site, after, window_no, stage, kind="die",
         expect=None, bc=None, driver=None, seed=3):
    """Replay ``blocks`` windowed with one ``kind`` rule at ``site`` that
    fires in window ``window_no`` (1-based) on ``stage``'s thread (None:
    the driver's); returns (chain, plan, the exception raised)."""
    bc = bc or fresh(ns, cfg)
    w = cfg.sync.commit_window_blocks
    plan = ns.FaultPlan(seed=seed, rules=[ns.FaultRule(site, kind,
                                                       after=after, times=1)])
    if stage is None:
        # a death on the driver: only earlier windows must be committed
        def until():
            return committed(bc, w * (window_no - 1))
        at = w * (window_no - 1)
    else:
        def until():
            return (bool(plan.fired) and stage_dead(stage)
                    and committed(bc, w * (window_no - 1)))
        at = w * window_no
    raised = None
    with ns.active(plan):
        try:
            (driver or ns.driver(bc, cfg)).replay(gated(blocks, at, until))
        except BaseException as e:  # noqa: BLE001 — the test checks it
            raised = e
    if expect is not None:
        assert isinstance(raised, expect), repr(raised)
    assert [s for (s, _, _, _) in plan.fired] == [site]
    return bc, plan, raised


def report_fields(report):
    return dataclasses.asdict(report)


def tip(bc):
    best = bc.best_block_number
    h = bc.get_header_by_number(best)
    return best, h.hash, h.state_root


def assert_whole(ns, bc, blocks):
    """At the chain's head, every root and hash the host-built chain's,
    and the state walk complete with clean content addresses."""
    assert bc.best_block_number == blocks[-1].number
    for b in blocks:
        h = bc.get_header_by_number(b.number)
        assert h is not None and h.hash == b.hash, b.number
    s = bc.storages
    walk = ns.verify_reachable(
        s.account_node_storage, s.storage_node_storage, s.evmcode_storage,
        blocks[-1].header.state_root, verify_hashes=True)
    assert walk.missing == 0 and walk.corrupt == 0


def resume(ns, bc, blocks, cfg, driver=None):
    best = bc.best_block_number
    (driver or ns.driver(bc, cfg)).replay(blocks[best:])
    assert_whole(ns, bc, blocks)


# ------------------------------------------------------------ the plan


def _fire_log(mod, seed, script):
    plan = mod.FaultPlan(seed=seed, rules=[
        mod.FaultRule("a.site", "latency", prob=0.3, latency_s=0.0),
        mod.FaultRule("b.*", "latency", prob=0.5, latency_s=0.0),
        mod.FaultRule("c", "corrupt", prob=0.25),
        mod.FaultRule("d", "latency", after=3, times=2, latency_s=0.0),
    ], sleep=lambda s: None)
    out = []
    for site in script:
        out.append(plan.fire(site, bytes(range(48)) if site == "c" else None))
    return list(plan.fired), out


def _script():
    return [s for i in range(120) for s in (
        "a.site", "b.other" if i % 3 else "b.site", "c", "d")]


class TestFaultPlan:
    @pytest.mark.parametrize("seed", [0, 42, 2**40 + 3])
    def test_same_seed_fires_the_same_in_both_packages(self, env, seed):
        from khipu_tpu.chaos import plan as jx_plan

        got = _fire_log(pt_plan, seed, _script())
        want = _fire_log(jx_plan, seed, _script())
        assert got == want
        assert len(got[0]) > 40
        # the window rule fired on hits 4 and 5 only
        assert [h for (s, h, _, _) in got[0] if s == "d"] == [4, 5]

    def test_different_seed_different_sequence(self):
        assert _fire_log(pt_plan, 1, _script()) != _fire_log(
            pt_plan, 2, _script())

    def test_corrupt_flips_exactly_one_bit(self):
        plan = pt_chaos.FaultPlan(seed=7, rules=[
            pt_chaos.FaultRule("c", "corrupt")])
        original = bytes(range(64))
        out = plan.fire("c", original)
        changed = [a ^ b for a, b in zip(original, out) if a ^ b]
        assert len(out) == 64 and len(changed) == 1
        assert bin(changed[0]).count("1") == 1

    def test_raise_and_die_kinds(self):
        plan = pt_chaos.FaultPlan(seed=0, rules=[
            pt_chaos.FaultRule("r", "raise"), pt_chaos.FaultRule("d", "die")])
        with pytest.raises(pt_chaos.InjectedFault):
            plan.fire("r")
        with pytest.raises(pt_chaos.InjectedDeath):
            plan.fire("d")
        assert issubclass(pt_chaos.InjectedFault, Exception)
        assert not issubclass(pt_chaos.InjectedDeath, Exception)
        with pytest.raises(ValueError):
            pt_chaos.FaultRule("x", "melt")

    def test_merge_and_extend_keep_draw_streams(self, env):
        from khipu_tpu.chaos import plan as jx_plan

        def run(mod):
            a = mod.FaultPlan(seed=5, rules=[
                mod.FaultRule("s", "latency", prob=0.5, latency_s=0.0)],
                sleep=lambda s: None)
            b = mod.FaultPlan(seed=9, rules=[
                mod.FaultRule("t", "latency", prob=0.5, latency_s=0.0)],
                sleep=lambda s: None)
            merged = mod.merge_plans(a, b, sleep=lambda s: None)
            merged.extend([mod.FaultRule("u", "latency", prob=0.5,
                                         latency_s=0.0)])
            for _ in range(50):
                for site in ("s", "t", "u"):
                    merged.fire(site)
            alone = mod.FaultPlan(seed=9, rules=list(b.rules),
                                  sleep=lambda s: None)
            for _ in range(50):
                alone.fire("t")
            return (merged.fired, merged._rule_keys,
                    [h for (s, h, _, _) in merged.fired if s == "t"],
                    [h for (_, h, _, _) in alone.fired])

        got, want = run(pt_plan), run(jx_plan)
        assert got == want
        assert got[2] == got[3]  # b's stream unchanged by the merge

    def test_known_seams_equal_the_reference(self, env):
        from khipu_tpu.chaos import plan as jx_plan

        assert pt_plan.KNOWN_SEAMS == jx_plan.KNOWN_SEAMS
        assert pt_chaos.known_seam("cluster.call:10.0.0.1:30303")
        assert not pt_chaos.known_seam("collector.nowhere")

    def test_disabled_seams_are_the_identity(self):
        blob = b"untouched"
        assert pt_plan._PLAN is None
        assert pt_chaos.fault_value("storage.node.get", blob) is blob
        assert pt_chaos.fault_point("storage.node.get") is None

    def test_active_installs_and_uninstalls(self):
        with pt_chaos.active(pt_chaos.FaultPlan(seed=0, rules=[
                pt_chaos.FaultRule("x", "raise")])):
            with pytest.raises(pt_chaos.InjectedFault):
                pt_chaos.fault_point("x")
        assert pt_plan._PLAN is None
        pt_chaos.fault_point("x")

    def test_fault_log_and_registry_counts(self):
        from khipu_tpu_torch.observability import registry, trace

        pt_chaos.fault_log.reset()
        ring = trace.Tracer()
        ring.enable()
        plan = pt_chaos.FaultPlan(seed=0, rules=[pt_chaos.FaultRule(
            "m.one", "latency", latency_s=0.0, times=3)],
            sleep=lambda s: None)
        with pt_chaos.active(plan), trace.use_tracer(ring):
            for _ in range(5):
                pt_chaos.fault_point("m.one")
        snap = pt_chaos.fault_log.snapshot()
        assert snap == {"fired": 3, "byKind": {
            "raise": 0, "latency": 3, "corrupt": 0, "die": 0},
            "bySite": {"m.one": 3}}
        # one chaos.fault instant event a fired fault, with its tags
        assert [(s.name, s.tags) for s in ring.snapshot()] == [
            ("chaos.fault", {"site": "m.one", "kind": "latency", "hit": h})
            for h in (1, 2, 3)]
        samples = {(n, tuple(sorted(lab.items()))): v
                   for n, _k, lab, v in registry.REGISTRY._collected()}
        assert samples[("khipu_chaos_faults_fired_total", ())] == 3
        pt_chaos.fault_log.reset()

    def test_scenario_schedule_and_arming(self):
        plan = pt_chaos.FaultPlan(seed=3, rules=[], sleep=lambda s: None)
        hooked = []
        sc = pt_chaos.Scenario(3, [
            pt_chaos.ScenarioEvent("kill-save", 4, "die",
                                   "collector.save"),
            pt_chaos.ScenarioEvent("fork", 2, "fork", params={"depth": 2}),
        ])
        eng = pt_chaos.ScenarioEngine(sc, plan, hooks={"fork": hooked.append})
        assert sc.schedule() == [("fork", 2, "fork", ""),
                                 ("kill-save", 4, "die", "collector.save")]
        assert [e.event_id for e in eng.step(3)] == ["fork"]
        plan.fire("collector.save")
        eng.step(4)
        assert eng.done() and hooked[0].params["depth"] == 2
        with pytest.raises(pt_chaos.InjectedDeath):
            plan.fire("collector.save")  # armed after the 1 hit so far
        assert pt_chaos.current_event_id() == "kill-save"
        pt_chaos.clear_current_event()
        with pytest.raises(ValueError, match="registered"):
            pt_chaos.ScenarioEvent("x", 1, "die", "collector.nowhere")
        assert pt_chaos.derive(3, "salt", 100) == __import__(
            "khipu_tpu.chaos", fromlist=["derive"]).derive(3, "salt", 100)


def _seams_in(root):
    # a literal seam at its call, or a class's seam-name attribute
    pat = re.compile(
        r"(?:fault_(?:point|value)\(\s*f?|_seam = )\"([^\"]+)\"")
    out = set()
    for dirpath, _, files in os.walk(root):
        if os.path.basename(dirpath) == "chaos":
            continue  # the plane itself (its docstrings name examples)
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                out.update(pat.findall(text))
    return out


def test_seam_audit():
    """Every seam the port calls is registered in KNOWN_SEAMS and is
    named by a port test (these files and chip_smoke.py's seam list)."""
    seams = _seams_in(os.path.join(REPO, "khipu_tpu_torch"))
    assert seams == {
        "ledger.batch", "collector.seal", "collector.pack",
        "collector.collect", "collector.persist", "collector.save",
        "collector.commit", "collector.spill", "storage.kv.get",
        "storage.kv.put", "storage.node.get", "storage.node.put",
        "storage.block.get", "storage.block.put", "reorg.intent",
        "reorg.rollback", "reorg.adopt", "reorg.finalize",
        "fused.dispatch", "fused.collect", "kesque.append", "kesque.roll",
        "kesque.index", "kesque.compact", "kesque.ingest", "replica.tail",
        "fleet.route"}
    import inspect

    tests = "".join(
        open(os.path.join(REPO, "tests", f)).read()
        for f in os.listdir(os.path.join(REPO, "tests"))
        if f.startswith("test_torch_") and f.endswith(".py"))
    tests = tests.replace(inspect.getsource(test_seam_audit), "")
    for seam in seams:
        assert pt_chaos.known_seam(seam), seam
        assert f'"{seam}"' in tests, f"no port test names {seam}"


@pytest.mark.parametrize("seam,call", [
    ("storage.kv.get", lambda s: s.app_state.source.get(b"k")),
    ("storage.kv.put", lambda s: s.app_state.source.put(b"k", b"v")),
    ("storage.node.get", lambda s: s.account_node_storage.source.get(b"h")),
    ("storage.node.put",
     lambda s: s.account_node_storage.source.put(b"h", b"v")),
    ("storage.block.get", lambda s: s.block_header_storage.source.get(1)),
    ("storage.block.put",
     lambda s: s.block_header_storage.source.put(1, b"v")),
], ids=lambda v: v if isinstance(v, str) else "")
def test_memory_engine_seams(seam, call):
    """Each of the memory engine's reads and writes is its seam: a
    ``raise`` rule there fails exactly that call, and only with a plan
    installed."""
    from khipu_tpu_torch.storage.storages import Storages

    storages = Storages()
    call(storages)
    plan = pt_chaos.FaultPlan(seed=0, rules=[pt_chaos.FaultRule(seam,
                                                                "raise")])
    with pt_chaos.active(plan):
        with pytest.raises(pt_chaos.InjectedFault):
            call(storages)
    assert [s for (s, _, _, _) in plan.fired] == [seam]


# ------------------------------------------------------------ journal


class TestWindowJournal:
    def test_intent_commit_pending_roundtrip(self, env):
        from khipu_tpu.sync.journal import WindowJournal as JxJournal
        from khipu_tpu_torch.storage.datasource import (
            MemoryKeyValueDataSource,
        )
        from khipu_tpu_torch.sync.journal import (
            IntentRecord,
            WindowJournal,
        )

        src = MemoryKeyValueDataSource()
        j = WindowJournal(src)
        s0 = j.log_intent(1, 2, b"\x01" * 32, [b"\x02" * 32, b"\x03" * 32])
        s1 = j.log_intent(3, 4, b"\x03" * 32, [b"\x04" * 32, b"\x05" * 32])
        j.log_commit(s0)
        (rec,) = j.pending()
        assert isinstance(rec, IntentRecord) and rec.seq == s1 == 1
        assert JxJournal(src).pending()[0].roots == rec.roots
        assert j.prune() == 1 and j.depth == 1
        with pytest.raises(ValueError):
            j.log_intent(5, 6, b"\x00" * 32, [b"\x00" * 32])

    def test_clean_recover_is_a_noop(self, env):
        ns = env["port"]
        cfg = cfg_of(ns)
        bc = fresh(ns, cfg)
        driver = ns.driver(bc, cfg)
        driver.replay(ns.chain)
        report = driver.recover()
        assert report.clean and report.best_after == N_BLOCKS
        assert bc.storages.storage_repair_report() == []


# ------------------------------------------------------ crash recovery

# (site, after, window that dies, stage thread it dies on): the JAX
# package's TestCrashRecovery and TestStorageLayerDeath kills, and the
# stage-entry kills of its sweep
KILLS = [
    ("collector.save", 4, 3, "save"),  # mid save: block 5 of [5..6] saved
    ("collector.commit", 2, 3, "save"),  # saves done, mark missing
    ("collector.spill", 2, 3, "persist"),  # between the node stores
    ("collector.seal", 2, 3, "seal"),  # intent down, nothing packed
    ("collector.pack", 1, 2, "seal"),  # scanned, nothing dispatched
    ("collector.collect", 1, 2, "collect"),  # dispatched, not checked
    ("collector.persist", 1, 2, "persist"),  # admitted, not spilled
    ("storage.block.put", 1, 1, "save"),  # header of block 1, no body
    ("storage.node.put", 2, 2, "persist"),  # window 2's account nodes
]


@pytest.mark.parametrize("site,after,window_no,stage", KILLS,
                         ids=[k[0] for k in KILLS])
def test_kill_recover_resume_matches_reference(env, site, after, window_no,
                                               stage):
    """The same kill in both packages: the same torn state (best block),
    the same RecoveryReport, and a resumed replay that lands on the
    host-built chain."""
    out = {}
    for name in ("port", "jax"):
        ns = env[name]
        cfg = cfg_of(ns)
        bc, plan, raised = kill(ns, ns.chain, cfg, site, after, window_no,
                                stage, expect=ns.CollectorDied)
        torn = bc.storages.app_state.best_block_number
        report = ns.driver(bc, cfg).recover()
        assert bc.storages.window_journal.pending() == []
        assert report.rolled_back + report.repaired == report.scanned >= 1
        out[name] = (torn, report_fields(report), tip(bc))
        resume(ns, bc, ns.chain, cfg)
    assert out["port"] == out["jax"]


def test_die_mid_batch_on_the_driver(env):
    """``ledger.batch`` fires per scatter row of the vectorized transfer
    lane, on the driver thread: the death escapes as itself (not
    CollectorDied), nothing of the torn block is durable, and a serial
    resume lands bit-exact — in both packages alike."""
    out = {}
    for name in ("port", "jax"):
        ns = env[name]
        cfg = cfg_of(ns, parallel=True)
        # 2 rows a block: after=6 dies on block 4's first row
        bc, plan, raised = kill(ns, ns.wide, cfg, "ledger.batch", 6, 2, None,
                                expect=ns.InjectedDeath)
        assert bc.best_block_number == 2
        report = ns.driver(bc, cfg).recover()
        out[name] = report_fields(report), tip(bc)
        serial = dataclasses.replace(cfg, sync=dataclasses.replace(
            cfg.sync, commit_window_blocks=1, parallel_tx=False))
        best = bc.best_block_number
        ns.serial_driver(bc, serial).replay(ns.wide[best:])
        assert_whole(ns, bc, ns.wide)
    assert out["port"] == out["jax"]


def test_device_seams_kill_recover_resume(env):
    """The fused path's own seams (the port's card path; the JAX package
    reaches them only with ``device_commit``): a death at
    ``fused.collect`` (the persist stage's digest fetch) recovers and
    resumes like any stage death."""
    ns = env["port"]
    cfg = cfg_of(ns)
    bc, _, _ = kill(ns, ns.chain, cfg, "fused.collect", 1, 2, "persist",
                    expect=ns.CollectorDied)
    report = ns.driver(bc, cfg).recover()
    assert report.best_after == 2 and report.rolled_back == 2
    resume(ns, bc, ns.chain, cfg)


class TestFusedDispatch:
    def test_fault_stops_the_replay_and_recover_settles(self, env):
        """The port's deliberate difference: an InjectedFault at
        ``fused.dispatch`` stops the windowed replay (no window is hashed
        on the host after a device error; the JAX package degrades that
        window to its host hasher). ``recover`` then settles the torn
        window and the resume lands on the chain."""
        from khipu_tpu_torch.ledger.window import WINDOW_GAUGES

        ns = env["port"]
        cfg = cfg_of(ns, degrade=True)
        host0 = WINDOW_GAUGES["host_windows"]
        # the first window's dispatch: a raise aborts the whole pipeline,
        # so no earlier window may be waited for
        bc, _, raised = kill(ns, ns.chain, cfg, "fused.dispatch", 0, 1,
                             "seal", kind="raise", expect=ns.InjectedFault)
        assert WINDOW_GAUGES["host_windows"] == host0
        assert bc.best_block_number < N_BLOCKS
        assert bc.storages.window_journal.pending()
        report = ns.driver(bc, cfg).recover()
        assert report.rolled_back >= 1
        assert bc.storages.window_journal.pending() == []
        resume(ns, bc, ns.chain, cfg)

    @pytest.mark.parametrize("name", ["port", "jax"])
    def test_die_escapes_the_replay(self, env, name):
        """A ``die`` at ``fused.dispatch`` escapes replay() in both
        packages: the seal stage dies, the degraded driver re-runs the
        torn job, dies there, and no handler swallows the death."""
        ns = env[name]
        cfg = cfg_of(ns, degrade=True)
        bc = fresh(ns, cfg)
        driver = ns.ReplayDriver(bc, cfg, device_commit=True,
                                 **({"device": "cpu"} if name == "port"
                                    else {}))
        if name == "jax":
            from khipu_tpu.trie.bulk import host_hasher

            driver.hasher = host_hasher  # fires before any XLA compile
        plan = ns.FaultPlan(seed=3, rules=[ns.FaultRule("fused.dispatch",
                                                        "die")])
        with ns.active(plan):
            with pytest.raises(ns.InjectedDeath):
                driver.replay(ns.chain)
        assert bc.best_block_number < N_BLOCKS


class TestDegrade:
    @pytest.mark.parametrize("site", ["collector.collect",
                                      "collector.persist"])
    def test_stage_death_degrades_to_sync_commits(self, env, site):
        """Default posture: a dead stage thread does not stop the replay;
        the live stages finish the jobs in hand, the driver re-runs the
        torn one and commits the rest synchronously, on the chain, each
        window saved once. (The JAX package's degrade path can re-run a
        job a live stage is still running, and then counts a window's
        blocks twice: ROADMAP C.)"""
        from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES

        ns = env["port"]
        cfg = cfg_of(ns, degrade=True)
        bc = fresh(ns, cfg)
        deaths0 = PIPELINE_GAUGES["collector_deaths"]
        fallback0 = PIPELINE_GAUGES["sync_fallback_windows"]
        plan = ns.FaultPlan(seed=1, rules=[ns.FaultRule(
            site, "die", after=1, times=1)])
        with ns.active(plan):
            stats = ns.driver(bc, cfg).replay(ns.chain)
        assert stats.blocks == N_BLOCKS
        assert PIPELINE_GAUGES["collector_deaths"] == deaths0 + 1
        assert PIPELINE_GAUGES["sync_fallback_windows"] > fallback0
        assert_whole(ns, bc, ns.chain)


class TestFailStopHandlers:
    def test_die_in_a_stage_is_not_recorded_as_failure(self):
        from khipu_tpu_torch.sync.replay import (
            CollectorDied,
            _WindowCollector,
        )

        collector = _WindowCollector(2, join_timeout=5.0)

        def torn_job():
            raise pt_chaos.InjectedDeath("die inside the seal stage")

        collector.submit(torn_job)
        collector._threads[0].join(timeout=5)
        assert not collector._threads[0].is_alive()
        assert collector._failure is None
        with pytest.raises(CollectorDied):
            collector.submit(lambda: None)
        assert collector.take_pending() == [torn_job]
        collector.kill()

    def test_a_raise_in_a_stage_is_recorded(self):
        from khipu_tpu_torch.sync.replay import _WindowCollector

        collector = _WindowCollector(2, join_timeout=5.0)

        def failing():
            raise pt_chaos.InjectedFault("fault inside the seal stage")

        collector.submit(failing)
        with pytest.raises(pt_chaos.InjectedFault):
            collector.drain()
        collector.kill()

    def test_close_raises_on_a_wedged_worker(self):
        from khipu_tpu_torch.sync.replay import _WindowCollector

        release = threading.Event()
        collector = _WindowCollector(1, join_timeout=0.2)
        collector.submit(lambda: release.wait(10))
        with pytest.raises(RuntimeError, match="failed to stop"):
            collector.close()
        release.set()
        for t in collector._threads:
            t.join(timeout=5)


# ---------------------------------------------- the mirror after a kill


@pytest.mark.parametrize("same_driver", [True, False],
                         ids=["same_driver", "fresh_driver"])
def test_resume_reads_no_placeholder_of_a_rolled_back_window(env,
                                                             same_driver):
    """A death at ``collector.persist`` leaves the dead window's live
    nodes in the driver's mirror under their placeholder aliases (admit
    ran, rekey did not). The next windowed replay restarts the
    session's placeholder counter, so a stale alias would be promoted
    under a new window's real hash. Resuming on the same driver or a
    fresh one must leave no alias behind and the mirror verifying."""
    ns = env["port"]
    cfg = cfg_of(ns)
    bc = fresh(ns, cfg)
    driver = ns.driver(bc, cfg)
    kill(ns, ns.chain, cfg, "collector.persist", 1, 2, "persist",
         expect=ns.CollectorDied, bc=bc, driver=driver)
    assert driver._mirror.alias_keys()  # the dead window's rows
    ns.driver(bc, cfg).recover()
    assert bc.storages.account_node_storage.mirror is None  # detached
    again = driver if same_driver else ns.driver(bc, cfg)
    resume(ns, bc, ns.chain, cfg, driver=again)
    assert again._mirror.alias_keys() == []
    assert again._mirror.verify() == 0
    for h, enc in bc.storages.account_node_storage.source._map.items():
        got = again._mirror.get(h)
        assert got is None or got == enc


# ------------------------------------------ deaths inside native frames


@pytest.mark.parametrize("kind,exc", [("die", "InjectedDeath"),
                                      ("raise", "InjectedFault")])
def test_death_inside_a_native_frame(kind, exc):
    """A rule at ``storage.node.get`` fires in a world read that a native
    EVM frame makes through a ctypes callback: the callback captures it
    and the frame re-raises it after the native call returns, as itself
    (a ``die`` stays an InjectedDeath, a ``raise`` an InjectedFault)."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.evm import native_vm
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.replay import ReplayDriver

    cfg = workloads.replay_config()
    _, spec, blocks = workloads.erc20_chain(cfg, 2, 4, 8)
    bc = Blockchain(Storages(cache_size=1), cfg)
    bc.load_genesis(spec)
    ReplayDriver(bc, cfg, device="cpu").replay(blocks[:2])
    plan = pt_chaos.FaultPlan(seed=1, rules=[pt_chaos.FaultRule(
        "storage.node.get", kind, times=1)])
    real = native_vm.native_execute_message
    in_frame = []

    def armed(*a, **k):
        # the rule is live only while a native frame runs
        with pt_chaos.active(plan):
            try:
                return real(*a, **k)
            finally:
                in_frame.append(bool(plan.fired))

    native_vm.native_execute_message = armed
    try:
        with pytest.raises(getattr(pt_chaos, exc)) as info:
            ReplayDriver(bc, cfg, device="cpu").replay(blocks[2:])
    finally:
        native_vm.native_execute_message = real
    assert type(info.value) is getattr(pt_chaos, exc)
    assert in_frame and in_frame[-1] and plan.fired[0][0] == "storage.node.get"
    assert bc.best_block_number == 2


# ---------------------------------------------- torn files, either reader


@pytest.mark.parametrize("engine", ["native", "sqlite"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_files_recovered_by_either_package(env, tmp_path, engine,
                                                writer):
    """A replay into a persistent engine is killed mid save and the
    files closed; each package opens a copy, recovers and resumes, and
    both land on the same chain: the same report, best block and roots,
    the host-built chain's."""
    ns = env[writer]
    cfg = cfg_of(ns)
    torn_dir = tmp_path / "torn"
    storages = ns.Storages(engine, str(torn_dir))
    bc = fresh(ns, cfg, storages)
    kill(ns, ns.chain, cfg, "collector.save", 4, 3, "save",
         expect=ns.CollectorDied, bc=bc)
    assert bc.storages.app_state.best_block_number == 5
    storages.stop()
    out = {}
    for reader in ("port", "jax"):
        rs = env[reader]
        copy = tmp_path / reader
        shutil.copytree(torn_dir, copy)
        rcfg = cfg_of(rs)
        rbc = rs.Blockchain(rs.Storages(engine, str(copy)), rcfg)
        report = rs.driver(rbc, rcfg).recover()
        assert rbc.best_block_number == 4
        out[reader] = report_fields(report)
        resume(rs, rbc, rs.chain, rcfg)
        out[reader] = (out[reader], tip(rbc))
        rbc.storages.stop()
    assert out["port"] == out["jax"]


# ------------------------------------------------- stage-boundary sweep


def test_stage_boundary_die_sweep_12_seeds(env):
    """Twelve of the JAX package's 120 sweep seeds (sites and hit depths
    from the same formula): whatever a seed kills, recovery plus a
    resume lands on the chain; a torn window is never half-durable."""
    ns = env["port"]
    sites = ("collector.seal", "collector.pack", "collector.collect",
             "collector.persist", "collector.spill", "collector.save",
             "collector.commit")
    killed = survived = 0
    for seed in range(0, 120, 10):
        site = sites[seed % len(sites)]
        cfg = cfg_of(ns)
        bc = fresh(ns, cfg)
        plan = ns.FaultPlan(seed=seed, rules=[ns.FaultRule(
            site, "die", times=1, after=(seed // len(sites)) % 14)])
        with ns.active(plan):
            try:
                ns.driver(bc, cfg).replay(ns.chain)
                survived += 1
            except ns.CollectorDied:
                killed += 1
                ns.driver(bc, cfg).recover()
                assert bc.storages.window_journal.pending() == []
        if bc.best_block_number < N_BLOCKS:
            resume(ns, bc, ns.chain, cfg)
        assert_whole(ns, bc, ns.chain)
    assert killed >= 4 and survived >= 2, (killed, survived)


def test_replay_under_an_empty_plan_is_bit_exact(env):
    ns = env["port"]
    cfg = cfg_of(ns)
    bc = fresh(ns, cfg)
    with ns.active(ns.FaultPlan(seed=99, rules=[])):
        ns.driver(bc, cfg).replay(ns.chain)
    assert_whole(ns, bc, ns.chain)


def test_take_pending_never_reruns_a_live_stages_job():
    """A stage dies while the seal stage is still running the next job.
    The degrade path must not hand that job back to be run again beside
    the live thread (two packs of one window at once): the live stage
    finishes and hands it on, then the pending list resumes it at the
    next stage. The JAX package's collector returns it whole."""
    from khipu_tpu_torch.sync.replay import CollectorDied, _WindowCollector

    calls = []
    release = threading.Event()
    collector = _WindowCollector(2, join_timeout=5.0)

    def seal_a():
        calls.append("seal-a")

    def collect_a():
        raise pt_chaos.InjectedDeath("collect stage dies on job a")

    def seal_b():
        release.wait(5)
        calls.append("seal-b")

    def collect_b():
        calls.append("collect-b")

    collector.submit((seal_a, collect_a))
    collector.submit((seal_b, collect_b))
    deadline = time.monotonic() + 5
    while collector._threads[1].is_alive():
        assert time.monotonic() < deadline
        time.sleep(0.002)
    with pytest.raises(CollectorDied):
        collector.drain()
    timer = threading.Timer(0.2, release.set)
    timer.start()
    pending = collector.take_pending()
    timer.join(timeout=5)
    assert calls == ["seal-a", "seal-b"]
    assert pending == [collect_a, collect_b]
    for fn in pending[1:]:
        fn()
    assert calls == ["seal-a", "seal-b", "collect-b"]
    assert not any(t.is_alive() for t in collector._threads)
