"""The port's serving plane (serving/) against the JAX package's.

* The read-your-writes view under the windowed replay, at windows 2 and
  3: the overlay after every ``commit_block``, the retirements and the
  invalidations are equal; a ``die`` at ``collector.persist``
  invalidates the same blocks; in the port an error at
  ``fused.dispatch`` invalidates the overlay and escapes; a concurrent
  load run sees no regressed read; a store read at ``latest`` while the
  save stage is inside a window answers in the port, where the
  reference meets a missing node (ROADMAP §C).
* Admission and the SLO tracker on the same scripted completions (a
  scripted clock) give the same limits, sheds and error budget.
* The load generator with the same seed sends the same request stream,
  and its checker reports the same violations.
* The filters retract the orphaned logs of a chain switch
  (``removed: true``) as the reference's do.

Chains: ``tests/test_torch_rpc.py``'s JAX-built ERC-20 chain and fork.
The port commits on the CPU (the plain K5 and a CPU mirror); the JAX
package runs its host path. Every wait is bounded.
"""

import functools
import hashlib
import json
import random
import threading
import time
from collections import defaultdict

import pytest

from tests.test_torch_chaos import _namespace, kill
from tests.test_torch_rpc import (
    FORK_ANCESTOR,
    MINER_A,
    MINER_B,
    N_TRANSFER_BLOCKS,
    _build,
    N_SENDERS,
    chain_wire,
    genesis_alloc,
    jax_blocks,
    jax_node,
    jx_config,
    port_blocks,
    port_node,
    sender_keys,
    token_address,
)

from khipu_tpu_torch import workloads

WAIT_S = 20.0


def _pkg(name):
    """One package's serving classes, under the same names."""
    if name == "port":
        from khipu_tpu_torch import serving
        from khipu_tpu_torch.config import ServingConfig
        from khipu_tpu_torch.jsonrpc import EthService, JsonRpcServer
        from khipu_tpu_torch.observability.registry import MetricsRegistry
        from khipu_tpu_torch.serving import admission, loadgen, slo
        from khipu_tpu_torch.serving.readview import ReadView
        from khipu_tpu_torch.sync.reorg import ReorgManager
        from khipu_tpu_torch.sync.replay import ReplayDriver
        from khipu_tpu_torch.txpool import PendingTransactionsPool
    else:
        from khipu_tpu import serving
        from khipu_tpu.config import ServingConfig
        from khipu_tpu.jsonrpc import EthService, JsonRpcServer
        from khipu_tpu.observability.registry import MetricsRegistry
        from khipu_tpu.serving import admission, loadgen, slo
        from khipu_tpu.serving.readview import ReadView
        from khipu_tpu.sync.reorg import ReorgManager
        from khipu_tpu.sync.replay import ReplayDriver
        from khipu_tpu.txpool import PendingTransactionsPool
    return dict(locals())


def _config(name, window, **sync):
    fields = dict(commit_window_blocks=window, pipeline_depth=2,
                  collector_join_timeout=5.0, adaptive_commit=False,
                  degrade_on_collector_death=False)
    fields.update(sync)
    if name == "port":
        return workloads.replay_config(**fields)
    return jx_config(**fields)


def _node(name, cfg):
    return port_node(cfg) if name == "port" else jax_node(cfg)


def _driver(name, bc, cfg, view):
    p = _pkg(name)
    if name == "port":
        return p["ReplayDriver"](bc, cfg, device_commit=True, device="cpu",
                                 read_view=view)
    return p["ReplayDriver"](bc, cfg, read_view=view)


def _blocks(name, wire):
    return port_blocks(wire) if name == "port" else jax_blocks(wire)


def _accounts(entries):
    """Overlay entries as (block, nonce, balance) — the fields the
    window session materializes exactly."""
    return {addr: (n, None if acc is None else (acc.nonce, acc.balance))
            for addr, (n, acc) in entries.items()}


def record(view, window=None):
    """Wrap ``view``'s pipeline hooks: every publication's overlay, every
    retirement and invalidation. With ``window``, each publication first
    waits (bounded) until every earlier window has retired, so the
    overlay it records holds exactly the open window's blocks."""
    log = {"overlay": [], "retire": [], "invalidate": []}
    publish, retire, invalidate = (view.publish_block, view.retire_through,
                                   view.invalidate_above)

    def published(header, accounts, txs=None):
        if window is not None:
            done = (header.number - 1) // window * window
            deadline = time.monotonic() + WAIT_S
            while view.retired < done:
                assert time.monotonic() < deadline, "no retirement"
                time.sleep(0.001)
        publish(header, accounts, txs)
        with view._lock:
            log["overlay"].append((header.number,
                                   _accounts(view._overlay)))

    def retired(number):
        retire(number)
        log["retire"].append(number)

    def invalidated(number):
        invalidate(number)
        log["invalidate"].append(number)

    view.publish_block = published
    view.retire_through = retired
    view.invalidate_above = invalidated
    return log


@pytest.mark.parametrize("window", [2, 3])
def test_overlay_retire_and_invalidate_equal(window):
    base, _ = chain_wire()
    out = {}
    for name in ("port", "jax"):
        cfg = _config(name, window)
        bc = _node(name, cfg)
        view = _pkg(name)["ReadView"](bc)
        log = record(view, window=window)
        stats = _driver(name, bc, cfg, view).replay(_blocks(name, base))
        assert stats.blocks == len(base)
        out[name] = (log, view.snapshot(), bc.best_block_number)
    assert out["port"] == out["jax"]
    log, snap, best = out["port"]
    assert best == len(base)
    assert snap["published"] == snap["retired"] == len(base)
    assert snap["invalidated"] == 0 and snap["overlayBlocks"] == 0
    assert log["retire"] == sorted(set(
        min(len(base), k + window) for k in range(0, len(base), window)))
    # the senders' nonces were served from the overlay mid-window
    _, addrs = sender_keys()
    assert any(addrs[1] in ov for _, ov in log["overlay"])


def test_collector_death_invalidates_the_same_blocks():
    """A ``die`` at ``collector.persist`` in window 2, with
    ``degrade_on_collector_death=False``: the replay raises
    CollectorDied, and the overlay loses the same blocks in both
    packages."""
    base, _ = chain_wire()
    out = {}
    for name in ("port", "jax"):
        ns = _namespace(name)
        cfg = _config(name, 2)
        bc = _node(name, cfg)
        view = _pkg(name)["ReadView"](bc)
        log = record(view)
        driver = _driver(name, bc, cfg, view)
        bc, plan, raised = kill(ns, _blocks(name, base), cfg,
                                "collector.persist", 1, 2, "persist",
                                expect=ns.CollectorDied, bc=bc,
                                driver=driver)
        out[name] = (log["invalidate"], log["retire"], view.snapshot(),
                     bc.best_block_number)
    assert out["port"] == out["jax"]
    invalidate, retire, snap, best = out["port"]
    assert invalidate == [best] and retire == [2]
    assert snap["invalidated"] > 0 and snap["overlayBlocks"] == 0
    assert snap["published"] == snap["retired"] + snap["invalidated"]


def test_fused_dispatch_error_invalidates_and_escapes():
    """The port stops where the reference degrades: an error at
    ``fused.dispatch`` escapes ``replay`` and the overlay holds nothing
    above the durable chain."""
    base, _ = chain_wire()
    ns = _namespace("port")
    cfg = _config("port", 2)
    bc = port_node(cfg)
    view = _pkg("port")["ReadView"](bc)
    log = record(view)
    bc, _, _ = kill(ns, port_blocks(base), cfg, "fused.dispatch", 0, 1,
                    "seal", kind="raise", expect=ns.InjectedFault, bc=bc,
                    driver=_driver("port", bc, cfg, view))
    snap = view.snapshot()
    assert bc.best_block_number == 0 and log["retire"] == []
    assert log["invalidate"] == [0]
    assert snap["published"] >= 2 and snap["overlayBlocks"] == 0
    assert snap["invalidated"] == snap["published"]
    assert view.head_number() == 0


def test_concurrent_load_sees_no_regressed_read():
    """A windowed import on a thread (throttled) under mixed load through
    the plane: the checker sees no regressed nonce or balance and no
    error, the load ran mid-import, every block retired."""
    p = _pkg("port")
    base, _ = chain_wire()
    cfg = _config("port", 2)
    bc = port_node(cfg)
    pool = p["PendingTransactionsPool"]()
    plane = p["serving"].ServingPlane.build(bc, cfg, tx_pool=pool)
    server = p["JsonRpcServer"](
        p["EthService"](bc, cfg, pool, read_view=plane.read_view,
                        serving=plane), serving=plane)
    driver = _driver("port", bc, cfg, plane.read_view)
    gate = threading.Event()
    done = threading.Event()
    failure = []

    def source():
        for i, b in enumerate(port_blocks(base)):
            if i == 1:
                gate.wait(WAIT_S)
            yield b
            time.sleep(0.02)

    def run():
        try:
            driver.replay(source())
        except BaseException as e:  # noqa: BLE001 — reported below
            failure.append(e)
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        _, addrs = sender_keys()
        gen = p["loadgen"].LoadGenerator(
            p["loadgen"].InProcessTransport(server), p["loadgen"].MIXED,
            clients=3, seed=5, max_requests=60,
            nonce_addresses=["0x" + a.hex() for a in addrs[:N_SENDERS]],
            balance_addresses=["0x" + MINER_A.hex()])
        gate.set()
        report = gen.run()
        mid = not done.is_set()
    finally:
        gate.set()
        t.join(WAIT_S)
    assert not t.is_alive() and not failure, failure
    assert report.violations == [] and report.errors == 0
    assert report.requests == 180 and mid
    snap = plane.read_view.snapshot()
    assert snap["published"] == snap["retired"] == len(base)
    assert snap["invalidated"] == 0


def test_mid_window_store_reads_answer():
    """A windowed chain stores each window's last state only, and the
    save stage advances best block by block through a window. Probes
    run on the save stage right after each mid-window block is saved:
    ``eth_call``, ``eth_getCode`` and ``eth_getBalance`` of an address
    no block touches, all at ``latest``. The port answers each from the
    last stored state at or below best (the value at best is the same);
    the reference reads best's state root and meets a missing node
    (ROADMAP §C, fixed in the port only)."""
    base, _ = chain_wire()
    idle = "0x" + (2**32 + 7).to_bytes(20, "big").hex()
    token = "0x" + token_address().hex()
    out = {}
    for name in ("port", "jax"):
        p = _pkg(name)
        cfg = _config(name, 4)
        bc = _node(name, cfg)
        view = p["ReadView"](bc)
        server = p["JsonRpcServer"](p["EthService"](bc, cfg,
                                                    read_view=view))
        probes = []
        save = bc.save_block

        def probing(block, *a, **kw):
            save(block, *a, **kw)
            if block.number % 4 and block.number != len(base):
                for method, params in (
                        ("eth_getBalance", [idle, "latest"]),
                        ("eth_getCode", [token, "latest"]),
                        ("eth_call", [{"to": idle, "value": "0x1"},
                                      "latest"])):
                    resp = server.handle({"jsonrpc": "2.0", "id": 1,
                                          "method": method,
                                          "params": params})
                    probes.append((block.number, method,
                                   resp.get("result"),
                                   resp.get("error", {}).get("code")))

        bc.save_block = probing
        _driver(name, bc, cfg, view).replay(_blocks(name, base))
        out[name] = probes
    port, jax = out["port"], out["jax"]
    assert [p[:2] for p in port] == [p[:2] for p in jax] and len(port) == 9
    assert all(code is None for *_, code in port)
    assert {r for n, m, r, _ in port if m == "eth_getBalance"} == {
        hex(genesis_alloc()[bytes.fromhex(idle[2:])])}
    assert any(code == -32603 for *_, code in jax)


@functools.lru_cache(maxsize=1)
def fork_tail_wire():
    """The fork of ``chain_wire`` (``MINER_B`` mines every block above
    ``FORK_ANCESTOR``) and four more blocks on top of it mined by
    ``MINER_A``, as block RLP."""
    blocks = _build(N_TRANSFER_BLOCKS + 1, diverge_at=FORK_ANCESTOR - 1,
                    tail=4)
    return [b.encode() for b in blocks]


@pytest.mark.parametrize("saved_by", ["switch", "per_block_import"])
def test_per_block_blocks_then_window_never_regress(saved_by):
    """Blocks saved one by one store every state and retire nothing from
    the view: a journaled switch's adoption (after its fence lowered the
    view to the ancestor), or a serial import. A windowed import follows
    them; probes run on its save stage after every block. ``MINER_B``,
    paid by the blocks saved one by one and by no block of the window,
    reads at ``latest`` as their last block left it, never older."""
    p = _pkg("port")
    base, fork = chain_wire()
    tail = fork_tail_wire()
    n = len(fork)
    cfg = _config("port", 4)
    bc = port_node(cfg)
    view = p["ReadView"](bc)
    server = p["JsonRpcServer"](p["EthService"](bc, cfg, read_view=view))
    if saved_by == "switch":
        driver = _driver("port", bc, cfg, view)
        driver.replay(port_blocks(base))
        p["ReorgManager"](bc, cfg, driver=driver, read_view=view).switch(
            FORK_ANCESTOR, port_blocks(fork[FORK_ANCESTOR:]))
    else:
        _driver("port", bc, _config("port", 1), None).replay(
            port_blocks(fork))
    assert bc.best_block_number == n
    paid = bc.get_account(MINER_B, bc.get_header_by_number(n).state_root)
    assert paid is not None and paid.balance > 0
    probes = []
    save = bc.save_block

    def probing(block, *a, **kw):
        save(block, *a, **kw)
        resp = server.handle({"jsonrpc": "2.0", "id": 1,
                              "method": "eth_getBalance",
                              "params": ["0x" + MINER_B.hex(), "latest"]})
        probes.append((block.number, resp.get("result"),
                       resp.get("error")))

    bc.save_block = probing
    _driver("port", bc, cfg, view).replay(port_blocks(tail[n:]))
    assert [b for b, *_ in probes] == list(range(n + 1, len(tail) + 1))
    assert all(r == hex(paid.balance) and e is None
               for _, r, e in probes), probes
    snap = view.snapshot()
    assert snap["published"] - snap["retired"] == 0


# ------------------------------------------------------ admission and SLO


class ScriptedClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t


METHODS = ("eth_blockNumber", "eth_getBalance", "eth_call",
           "eth_sendRawTransaction", "eth_getLogs", "khipu_metrics",
           "net_version", "personal_sign")


def _script(seed=7, n=600):
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            ops.append(("admit", rng.choice(METHODS)))
        elif r < 0.9:
            ops.append(("finish", rng.random(), rng.choice(
                (0.0004, 0.004, 0.03, 0.2, 0.6)), rng.random() < 0.1))
        elif r < 0.97:
            ops.append(("tick", rng.choice((0.01, 0.05, 0.2))))
        else:
            ops.append(("pressure", rng.choice((0.0, 0.5, 0.87, 0.92,
                                                 0.96, 1.5))))
    return ops


def _run_script(name, monkeypatch):
    p = _pkg(name)
    clock = ScriptedClock()
    monkeypatch.setattr(p["admission"], "time", clock)
    reg = p["MetricsRegistry"]()
    level = [0.0]

    def signal():
        return level[0]

    signal.signal_name = "scripted"
    cfg = p["ServingConfig"](max_queue=0)
    admission = p["admission"].AdmissionController(
        cfg, limits={"cheap": 3, "read": 2, "execute": 1, "write": 2},
        signals=[signal], registry=reg)
    plane = p["serving"].ServingPlane(
        cfg, admission=admission,
        slo=p["slo"].SloTracker(p["slo"].SloPolicy(objective=0.99),
                                registry=reg))
    held, outcomes = [], []
    for op in _script():
        if op[0] == "admit":
            try:
                held.append((op[1], plane.admit(op[1])))
                outcomes.append("ok")
            except p["admission"].ServerBusy as e:
                outcomes.append(str(e))
        elif op[0] == "finish" and held:
            method, ticket = held.pop(int(op[1] * len(held)))
            clock.t += op[2]
            plane.finish(method, ticket, error=op[3])
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "pressure":
            level[0] = op[1]
    return outcomes, plane.snapshot(), reg.families()


def test_admission_and_slo_on_scripted_completions(monkeypatch):
    got = {name: _run_script(name, monkeypatch) for name in ("port", "jax")}
    assert got["port"] == got["jax"]
    outcomes, snap, _ = got["port"]
    shed = [o for o in outcomes if o != "ok"]
    assert 0 < len(shed) < len(outcomes)
    assert any("pressure" in o for o in shed)
    assert any("saturated" in o for o in shed)
    budget = snap["slo"]["errorBudget"]
    assert budget["bad"] >= len(shed)
    assert {c["limit"] for k, c in snap["admission"].items()
            if k in ("cheap", "read", "execute", "write")} != {3, 2, 1}


# ------------------------------------------------------------- load gen


class RecordingTransport:
    """A server stand-in: records each client's calls, answers from the
    call's own bytes, mints a token a call."""

    supports_tokens = True

    def __init__(self, regress_after=None):
        self.calls = defaultdict(list)
        self.regress_after = regress_after

    def call(self, method, params, token=None):
        mine = self.calls[threading.current_thread().name]
        mine.append((method, json.dumps(params), token))
        n = len(mine)
        digest = hashlib.sha256(json.dumps(params).encode()).hexdigest()
        result = None
        if method == "eth_sendRawTransaction":
            result = "0x" + digest
        elif method == "eth_getTransactionByHash":
            result = {"hash": params[0]}
        elif method in ("eth_getTransactionCount", "eth_getBalance"):
            value = n if self.regress_after is None or n < \
                self.regress_after else n - self.regress_after
            result = hex(value)
        elif method == "eth_blockNumber":
            result = hex(n)
        return {"jsonrpc": "2.0", "id": 1, "result": result,
                "khipuToken": "0x" + digest[:32]}


@pytest.mark.parametrize("profile,clients,requests", [
    ("MIXED", 1, 150), ("READ_ONLY", 4, 40), ("MIXED", 3, 30)],
    ids=["mixed_1x150", "read_only_4x40", "mixed_3x30_no_lookups"])
def test_same_seed_same_request_stream(profile, clients, requests):
    """Per client, the same method, params (raw transactions byte for
    byte) and echoed token in both packages. With several clients the
    pool lookups draw from a list the clients share, so that case drops
    ``eth_getTransactionByHash`` from the mix."""
    _, addrs = sender_keys()
    got = {}
    for name in ("port", "jax"):
        lg = _pkg(name)["loadgen"]
        prof = getattr(lg, profile)
        if clients > 1 and profile == "MIXED":
            prof = lg.WorkloadProfile("mixed_no_lookups", {
                m: w for m, w in prof.weights.items()
                if m != "eth_getTransactionByHash"})
        transport = RecordingTransport()
        report = lg.LoadGenerator(
            transport, prof, clients=clients, seed=11,
            max_requests=requests,
            nonce_addresses=["0x" + a.hex() for a in addrs],
            balance_addresses=["0x" + MINER_A.hex(),
                               "0x" + token_address().hex()],
            chain_id=1).run()
        assert report.requests == clients * requests
        got[name] = (dict(transport.calls), report.summary()["violations"])
    assert got["port"] == got["jax"]
    calls = got["port"][0]
    assert len(calls) == clients
    methods = {m for stream in calls.values() for m, _, _ in stream}
    assert len(methods) >= 3


def test_checker_reports_the_same_violations():
    """Reads that go backwards are caught the same way in both
    packages: the same clients, methods and regressing pairs."""
    _, addrs = sender_keys()
    got = {}
    for name in ("port", "jax"):
        lg = _pkg(name)["loadgen"]
        report = lg.LoadGenerator(
            RecordingTransport(regress_after=20), lg.READ_ONLY, clients=2,
            seed=3, max_requests=40,
            nonce_addresses=["0x" + addrs[0].hex()],
            balance_addresses=["0x" + MINER_A.hex()]).run()
        got[name] = [(v.client, v.method, v.detail)
                     for v in report.violations]
    assert got["port"] == got["jax"] and got["port"]


# -------------------------------------------------------------- filters


def test_filters_retract_orphaned_logs():
    """A log filter and a block filter, polled before a depth-2 switch to
    the fork: the next poll gives every delivered log of the orphaned
    blocks with ``removed: true``, then the adopted branch's logs; the
    block filter rewinds to the fork point. Equal JSON in both
    packages."""
    base, fork = chain_wire()
    token = "0x" + token_address().hex()
    out = {}
    for name in ("port", "jax"):
        p = _pkg(name)
        cfg = _config(name, 1)
        bc = (port_node(cfg, base) if name == "port"
              else jax_node(cfg, base))
        mgr = p["ReorgManager"](bc, cfg, driver=_driver(name, bc, cfg,
                                                        None))
        server = p["JsonRpcServer"](p["EthService"](bc, cfg,
                                                    reorg_manager=mgr))

        def call(method, *params):
            resp = server.handle({"jsonrpc": "2.0", "id": 1,
                                  "method": method, "params": list(params)})
            return json.loads(json.dumps(resp))["result"]

        logs = call("eth_newFilter", {"fromBlock": "0x1", "address": token})
        blocks = call("eth_newBlockFilter")
        unfiltered = call("eth_newFilter", {"fromBlock": "0x4"})
        first = (call("eth_getFilterChanges", logs),
                 call("eth_getFilterChanges", unfiltered))
        mgr.switch(FORK_ANCESTOR, _blocks(name, fork[FORK_ANCESTOR:]))
        second = (call("eth_getFilterChanges", logs),
                  call("eth_getFilterChanges", blocks),
                  call("eth_getFilterChanges", unfiltered),
                  call("eth_getFilterChanges", logs))
        out[name] = (first, second, bc.best_block_number)
    assert out["port"] == out["jax"]
    (first_logs, _), (changes, block_hashes, unfiltered, again), best = \
        out["port"]
    orphaned = len(base) - FORK_ANCESTOR
    removed = [h for h in changes if h["removed"]]
    assert len(removed) == orphaned * N_SENDERS
    assert removed == [dict(h, removed=True) for h in first_logs
                       if int(h["blockNumber"], 16) > FORK_ANCESTOR]
    assert len(changes) - len(removed) == (best - FORK_ANCESTOR) * N_SENDERS
    assert len(block_hashes) == best - FORK_ANCESTOR
    assert again == [] and best == len(fork)
    assert sum(h["removed"] for h in unfiltered) == orphaned * N_SENDERS
