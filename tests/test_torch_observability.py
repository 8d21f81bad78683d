"""The port's observability plane (khipu_tpu_torch/observability/)
against the JAX package's, on the CPU.

* **Registry.** The same instrument writes and collectors give a
  byte-equal ``prometheus_text()`` and an equal ``snapshot()``.
* **Sampling.** ``trace_sampled`` keeps and drops the same seeded ids.
* **Export.** One span program and one movement ledger, run in each
  package on the same two threads with both modules' clocks patched to
  one deterministic counter, give equal ``chrome_trace`` documents
  (spans, flow pairs, the counter tracks and the cost tracks, with both
  cost models' floors set to the same values) and equal reports.
* **Lifecycle.** The JAX package's device-commit path on the CPU and
  the port's (``device="cpu"``) replay one small chain windowed (no
  device mirror; the card's phase gates the mirror's sites): each
  block's ``recorder.lifecycle`` has the same phases, in the same
  order. The port's ``fused.dispatch`` span carries its window's block
  range, so it joins the lifecycle (between ``window.pack`` and
  ``window.collect``); the JAX package's carries none and never does.
* **Ledger.** HOST bytes per (window, phase, site) are equal. Device
  bytes per site are equal except where the port moves other bytes
  than the reference, listed here:

  ==========================  =======================================
  site                        why the bytes differ
  ==========================  =======================================
  ``seal.upload`` H2D         the JAX package uploads 1024-row tiles
                              and pow-2 triple buckets; the port its
                              real rows (one filler row a rate class),
                              the level plan and the admit rows
  ``seal.dispatch_build``     the same buffers (HOST: the bytes the
  HOST                        build step packed)
  ``fused.collect`` D2H       the whole digest tile, padded alike
  ``seal.alias_gather`` H2D   int32 row indices there; int64 indices
                              and the host digest rows of the ext tile
                              here
  ``mirror.init`` H2D / D2H   the JAX package's filler tile and its
                              1024 digests; the port's filler row and
                              one digest
  ``ops.keccak`` H2D / D2H    1024-row tiles there; the ragged blob,
                              its header and 32 B a digest here
  ==========================  =======================================

* **Disabled mode.** With the plane off every seam returns its inert
  singleton and records nothing, and the replay is bit-exact with the
  traced one.
* **No synchronisation.** ``span``, ``LEDGER.transfer`` / ``record``
  and ``JOURNEY.record`` call neither ``torch.cuda.synchronize``, nor
  ``Tensor.item``, nor ``Tensor.cpu``.
"""

import dataclasses
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from khipu_tpu.observability import costmodel as jx_costmodel
from khipu_tpu.observability import export as jx_export
from khipu_tpu.observability import profiler as jx_profiler
from khipu_tpu.observability import recorder as jx_recorder
from khipu_tpu.observability import registry as jx_registry
from khipu_tpu.observability import trace as jx_trace

from khipu_tpu_torch.observability import costmodel as pt_costmodel
from khipu_tpu_torch.observability import export as pt_export
from khipu_tpu_torch.observability import profiler as pt_profiler
from khipu_tpu_torch.observability import recorder as pt_recorder
from khipu_tpu_torch.observability import registry as pt_registry
from khipu_tpu_torch.observability import trace as pt_trace
from khipu_tpu_torch.observability.journey import JOURNEY as PT_JOURNEY

SEED = 20261018
PKGS = {
    "port": SimpleNamespace(registry=pt_registry, trace=pt_trace,
                            profiler=pt_profiler, recorder=pt_recorder,
                            export=pt_export, costmodel=pt_costmodel),
    "jax": SimpleNamespace(registry=jx_registry, trace=jx_trace,
                           profiler=jx_profiler, recorder=jx_recorder,
                           export=jx_export, costmodel=jx_costmodel),
}


# --------------------------------------------------------------- registry


def _registry_program(reg_mod):
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("khipu_a_total", help="a \\ counter\nwith lines")
    c.inc()
    c.inc(41)
    reg.counter("khipu_b_total", labels={"site": 'x"y\\z\n'}).inc(3)
    reg.counter("khipu_b_total", labels={"site": "plain"}).inc(5)
    g = reg.gauge("khipu_g", help='quotes "kept" verbatim')
    g.set(2.5)
    g.inc(1)
    g.dec(0.25)
    group = reg.gauge_group("khipu_pipeline", {"depth": 0, "busy_s": 0.0},
                            help="a group")
    group["depth"] += 3
    group["busy_s"] = 1.234
    h = reg.histogram("khipu_lat_seconds", help="latency",
                      labels={"phase": "seal"})
    rng = np.random.default_rng(SEED)
    for i, v in enumerate(rng.exponential(0.05, 200)):
        h.observe(float(v), exemplar=f"{i:016x}" if i % 7 == 0 else None)
    h2 = reg.histogram("khipu_size_bytes", buckets=(10, 100, 1000))
    for v in (5, 50, 500, 5000):
        h2.observe(v)
    # an explicit layout on re-register applies only while empty
    reg.histogram("khipu_size_bytes", buckets=(1, 2))
    reg.histogram("khipu_new_bytes", buckets=(3, 30))
    reg.histogram("khipu_new_bytes", buckets=(4, 40)).observe(5)
    reg.register_collector("one", lambda: [
        ("khipu_pulled", "gauge", {"k": "v"}, 7),
        ("khipu_pulled", "gauge", {"k": "w"}, 8)])
    reg.register_collector("broken", lambda: 1 / 0)
    reg.register_collector("one", lambda: [
        ("khipu_pulled", "gauge", {"k": "v"}, 9)])  # replaces by key
    with pytest.raises(ValueError):
        reg.gauge("khipu_a_total")
    return reg


def test_prometheus_text_byte_equal():
    regs = {k: _registry_program(p.registry) for k, p in PKGS.items()}
    text = {k: r.prometheus_text() for k, r in regs.items()}
    assert text["port"] == text["jax"]
    assert text["port"].count("# TYPE khipu_b_total counter") == 1
    assert 'site="x\\"y\\\\z\\n"' in text["port"]
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert regs["port"].families() == regs["jax"].families()
    # one collector pull a scrape, however many exports share it
    for reg in regs.values():
        before = reg.collector_pulls
        with reg.scrape_pass():
            reg.snapshot()
            reg.prometheus_text()
        assert reg.collector_pulls - before == 2  # two collectors


@pytest.mark.parametrize("per_10k", [0, 1, 100, 2_500, 5_000, 9_999,
                                     10_000])
def test_trace_sampled_agrees(per_10k):
    rng = np.random.default_rng([SEED, per_10k])
    ids = [rng.bytes(8).hex() for _ in range(10_000)] + ["not-hex", ""]
    got = [pt_trace.trace_sampled(i, per_10k) for i in ids]
    assert got == [jx_trace.trace_sampled(i, per_10k) for i in ids]
    kept = sum(got[:10_000])
    assert kept == 0 if per_10k == 0 else abs(kept - per_10k) < 200 + per_10k // 10


def test_tracer_sample_rate_and_ring_agree():
    """Head sampling, drop-oldest and the recorded / dropped counters of
    both Tracers on one seeded program."""
    out = {}
    for name, p in PKGS.items():
        t = p.trace.Tracer(capacity=64)
        t.enable()
        t.trace_id = "00000000000000ff"
        t.set_sample_rate(300)  # 0xff = 255 < 300: kept
        for i in range(100):
            with t.span("w", i=i):
                pass
        t.event("e", i=-1)
        kept = (t.recorded, t.dropped, [s.tags for s in t.snapshot()])
        t.trace_id = "0000000000000fff"  # 4095 >= 300: dropped
        t.set_sample_rate(300)
        with t.span("x"):
            pass
        out[name] = (kept, t.enabled, t.recorded)
    assert out["port"] == out["jax"]
    assert out["port"][0][:2] == (101, 37)


# ----------------------------------------------------------------- export


class _Clock:
    """One deterministic clock for both packages' modules."""

    def __init__(self):
        self.ticks = itertools.count(1)

    def perf_counter(self):
        return 1000.0 + next(self.ticks) * 0.001

    def thread_time(self):
        return next(self.ticks) * 0.0001

    def time(self):
        return 1_700_000_000.0


def _span_program(p, worker):
    """A window's lifecycle in miniature: the driver's build and seal, a
    stage thread's pack (dispatch build, upload) and collect (root
    check), a stall, an instant event, a failed span; the movement
    ledger's crossings under their window and phase."""
    t = p.trace.Tracer()
    t.enable()
    t.trace_id = "0123456789abcdef"
    t.epoch_perf, t.epoch_wall = 1000.0, 1_700_000_000.0
    led = p.profiler.LEDGER
    led.reset()
    led.enable()
    H2D, D2H, HOST = p.profiler.H2D, p.profiler.D2H, p.profiler.HOST
    with p.trace.use_tracer(t):
        for lo in (1, 3):
            hi = lo + 1
            for n in (lo, hi):
                with p.trace.span("window.build", block=n, txs=2):
                    with p.trace.span("execute", block=n, txs=2):
                        pass
            led.note_window(lo, lo, hi)
            with p.trace.span("window.seal", block_lo=lo,
                              block_hi=hi) as seal, \
                    led.context(window=lo, phase="seal"):
                with p.trace.span("seal.journal", block_lo=lo, block_hi=hi):
                    pass
                led.record("seal.journal", HOST, 0, duration=0.0005)
                tok = seal.token

            def stage(lo=lo, hi=hi, tok=tok):
                with p.trace.use_tracer(t):
                    with p.trace.span("window.pack", parent=tok,
                                      block_lo=lo, block_hi=hi), \
                            led.context(window=lo, phase="seal"):
                        with p.trace.span("seal.pack", nodes=40) as sp:
                            sp.set_tag("depth", 3)
                        led.record("seal.pack", HOST, 4000,
                                   duration=0.001)
                        with p.trace.span("seal.dispatch_build", nodes=40):
                            pass
                        with p.trace.span("seal.upload", nbytes=9000):
                            with led.transfer("seal.upload", H2D, 9000):
                                pass
                    with p.trace.span("window.collect", parent=tok,
                                      block_lo=lo, block_hi=hi), \
                            led.context(window=lo, phase="collect"):
                        with p.trace.span("seal.rootcheck", blocks=2):
                            with led.transfer("seal.rootcheck", D2H, 64):
                                pass
                        p.trace.event("build", kind="hit",
                                      signature=b"\x01\x02")
                    with p.trace.span("window.persist", parent=tok,
                                      block_lo=lo, block_hi=hi), \
                            led.context(window=lo, phase="persist"):
                        led.record("window.store", HOST, 1234,
                                   duration=0.002)
                    with p.trace.span("window.save", parent=tok,
                                      block_lo=lo, block_hi=hi), \
                            led.context(window=lo, phase="save"):
                        led.record("block.save", HOST, 0, duration=0.0001)
                    led.note_blocks(2)

            worker.submit(stage).result()
            with p.trace.span("pipeline.stall", kind="submit"):
                pass
        with pytest.raises(KeyError):
            with p.trace.span("failing", block=9):
                raise KeyError("x")
    return t


def test_chrome_trace_and_reports_equal(monkeypatch):
    """The same span program in both packages, on the same two threads,
    with one deterministic clock patched into both modules' ``time``:
    equal Chrome trace documents (complete and instant events, the flow
    pairs of the cross-thread stage spans, the transfer counter tracks,
    the occupancy and cost tracks) and equal reports."""
    floors = {"DISPATCH_FLOOR_S": 0.002, "KERNEL_HASHES_PER_S": 1e7}
    monkeypatch.setattr(jx_costmodel, "TUNNEL_BYTES_PER_S", 1e6)
    monkeypatch.setattr(pt_costmodel, "H2D_BYTES_PER_S", 1e6)
    for k, v in floors.items():
        monkeypatch.setattr(jx_costmodel, k, v)
        monkeypatch.setattr(pt_costmodel, k, v)
    docs = {}
    with ThreadPoolExecutor(1, thread_name_prefix="stage") as worker:
        worker.submit(lambda: None).result()
        for name, p in PKGS.items():
            clock = _Clock()
            for mod in (p.trace, p.profiler, p.recorder):
                monkeypatch.setattr(mod, "time", clock)
            # the recorder's timelines read the module tracer's epoch
            monkeypatch.setattr(p.trace.tracer, "epoch_perf", 1000.0)
            try:
                t = _span_program(p, worker)
                spans = t.snapshot()
                docs[name] = {
                    "chrome": p.export.chrome_trace(spans, tracer_=t),
                    "tracks": p.export.counter_tracks(spans, tracer_=t),
                    "costs": p.costmodel.cost_tracks(tracer_=t),
                    "window_costs": [p.costmodel.window_costs(n, spans)
                                     for n in (1, 2, 3, 5)],
                    "report": [p.recorder.window_report(n, spans)
                               for n in (1, 3, 9)],
                    "lifecycle": [p.recorder.lifecycle(spans, n)
                                  for n in (1, 2, 3, 4)],
                    "pct": p.recorder.phase_percentiles(spans),
                    "breakdown": p.recorder.phase_breakdown(spans),
                    "decomposition": p.recorder.seal_decomposition(spans),
                    "occupancy": p.recorder.occupancy(spans),
                    "timeline": p.recorder.occupancy_timeline(spans, 12),
                    "nesting": p.recorder.nesting_violations(spans),
                    "totals": p.profiler.LEDGER.totals(include_host=True),
                    "per_block": p.profiler.LEDGER.phase_bytes_per_block(),
                    "sub_per_block":
                        p.profiler.LEDGER.subphase_bytes_per_block(),
                }
            finally:
                p.profiler.LEDGER.disable()
                p.profiler.LEDGER.reset()
    port, jax = docs["port"], docs["jax"]
    for wc in port["window_costs"] + jax["window_costs"]:
        floors_out = wc.pop("floors", {})
        floors_out.pop("tunnel_bytes_per_s", None)
        floors_out.pop("h2d_bytes_per_s", None)
    for key in port:
        assert port[key] == jax[key], key
    events = port["chrome"]["traceEvents"]
    flows = [e for e in events if e["ph"] in ("s", "f")]
    assert len(flows) == 2 * 8  # 4 stage spans a window, 2 windows
    assert {e["name"] for e in events if e["ph"] == "C"} >= {
        "transfer bytes in flight", "transfer bytes (cumulative)",
        "pipeline occupancy", "window cost model (s)"}
    assert port["costs"] and port["report"][0]["found"]
    assert not port["report"][2]["found"]
    assert port["nesting"] == []
    assert port["lifecycle"][0]["complete"]


def test_dump_chrome_trace_loads_back(tmp_path):
    import json

    t = pt_trace.Tracer()
    t.enable()
    with pt_trace.use_tracer(t):
        with pt_trace.span("window.seal", block_lo=1, block_hi=1) as s:
            tok = s.token
        th = threading.Thread(target=lambda: _child(t, tok), name="stage")
        th.start()
        th.join(timeout=10)
    path = pt_export.dump_chrome_trace(str(tmp_path / "t.json"),
                                       tracer_=t)
    doc = json.loads(open(path).read())
    phs = [e["ph"] for e in doc["traceEvents"]]
    assert phs.count("s") == phs.count("f") == 1
    assert pt_export.trace_block(1, t)["phaseOrder"] == [
        "window.seal", "window.collect"]
    snap = pt_export.snapshot(t)
    assert snap["blocks"] == [1] and snap["recorded"] == 2


def _child(t, tok):
    with pt_trace.use_tracer(t):
        with pt_trace.span("window.collect", parent=tok, block_lo=1,
                           block_hi=1):
            pass


def test_compile_log_carries_the_builds():
    log = pt_recorder.compile_log
    t = pt_trace.Tracer()
    t.enable()
    hits = log.hits
    with pt_trace.use_tracer(t):
        log.record("hit", "k5_fixpoint")
    snap = log.snapshot()
    assert snap["hits"] >= hits + 1
    assert snap["events"][-1]["signature"] == "k5_fixpoint"
    assert [s.name for s in t.snapshot()][-1] == "build"


# ----------------------------------------------------- replay (lifecycle)


def _chain():
    from tests.test_torch_reorg import _reorg_namespace, build

    from khipu_tpu.config import ObservabilityConfig as JxObservabilityConfig

    from khipu_tpu_torch.config import ObservabilityConfig

    out = {}
    for name in ("port", "jax"):
        ns = _reorg_namespace(name)
        _, ns.blocks = build(ns, 6)
        ns.ObservabilityConfig = (ObservabilityConfig if name == "port"
                                  else JxObservabilityConfig)
        out[name] = ns
    return out


WINDOW = 3
WINDOW_LOS = (1, 4)


def _traced_replay(name, ns):
    """One 6-block chain replayed at window 3 with the whole plane on:
    the JAX package on its device-commit path on the CPU (no adaptive
    controller: on a CPU backend it would hold host mode; no device
    mirror: the JAX mirror compiles a program a size class), the port
    on ``device="cpu"`` alike. Returns the spans, the ledger events, the
    window reports and costs, the journeys' edges and the chain."""
    from khipu_tpu.observability.journey import JOURNEY as JX_JOURNEY

    p = PKGS[name]
    journey = PT_JOURNEY if name == "port" else JX_JOURNEY
    obs = ns.ObservabilityConfig(enabled=True, ledger_enabled=True,
                                 journey_enabled=True)
    cfg = dataclasses.replace(
        ns.RCFG, observability=obs, sync=ns.SyncConfig(
            commit_window_blocks=WINDOW, pipeline_depth=2,
            parallel_tx=False, adaptive_commit=False,
            device_mirror_commit=False))
    bc = ns.Blockchain(ns.Storages(), cfg)
    bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
    t = p.trace.Tracer()
    p.profiler.LEDGER.reset()
    journey.reset()
    kw = {"device": "cpu"} if name == "port" else {}
    try:
        stats = ns.ReplayDriver(bc, cfg, device_commit=True, tracer=t,
                                **kw).replay(ns.blocks)
        spans = t.snapshot()
        return SimpleNamespace(
            spans=spans, events=p.profiler.LEDGER.events(),
            reports={n: p.recorder.window_report(n, spans)
                     for n in range(1, 8)},
            costs={n: p.costmodel.window_costs(n, spans)
                   for n in WINDOW_LOS},
            stats=stats, bc=bc, ns=ns,
            journeys={stx.hash: [e[1] for e in journey.get(stx.hash).events]
                      for b in ns.blocks for stx in b.body.transactions})
    finally:
        p.profiler.LEDGER.disable()
        p.profiler.LEDGER.reset()
        journey.disable()
        journey.reset()


@pytest.fixture(scope="module")
def chains():
    return _chain()


@pytest.fixture(scope="module")
def port_replay(chains):
    return _traced_replay("port", chains["port"])


PADDED_SITES = {"seal.upload", "seal.dispatch_build", "fused.collect",
                "seal.alias_gather", "mirror.init", "ops.keccak"}


def _by(events, host):
    out = {}
    for ev in events:
        if (ev.direction == "host") != host:
            continue
        key = ((ev.window, ev.phase, ev.site) if host
               else (ev.site, ev.direction))
        out[key] = out.get(key, 0) + ev.nbytes
    return out


def test_replay_matches_reference(chains, port_replay):
    """Lifecycle phases, ledger bytes, window reports and cost rows, and
    journeys against the JAX package's device-commit replay of the same
    chain (one test: the JAX fixpoint's compile on the CPU takes most of
    this file's time, and a test process pays it once)."""
    port, jax = port_replay, _traced_replay("jax", chains["jax"])
    assert port.stats.blocks == jax.stats.blocks == 6
    # lifecycle: the same phases, but the port's fused.dispatch
    for n in range(1, 7):
        got = pt_recorder.lifecycle(port.spans, n)
        want = jx_recorder.lifecycle(jax.spans, n)
        assert got["complete"] and want["complete"]
        assert [p for p in got["phaseOrder"] if p != "fused.dispatch"] \
            == want["phaseOrder"], n
    names = {s.name for s in port.spans}
    assert sorted(names & set(pt_recorder.LIFECYCLE_PHASES
                              + pt_recorder.SEAL_SUBPHASES
                              + pt_recorder.EXEC_SUBPHASES)) == sorted(
        {s.name for s in jax.spans} & set(jx_recorder.LIFECYCLE_PHASES
                                          + jx_recorder.SEAL_SUBPHASES
                                          + jx_recorder.EXEC_SUBPHASES))
    # the ledger: HOST bytes per (window, phase, site); device bytes per
    # site but where the port moves other bytes (PADDED_SITES)
    host_pt, host_jx = _by(port.events, True), _by(jax.events, True)
    assert {k: v for k, v in host_pt.items() if k[2] not in PADDED_SITES} \
        == {k: v for k, v in host_jx.items() if k[2] not in PADDED_SITES}
    assert set(host_pt) == set(host_jx)
    assert host_pt[(1, "seal", "seal.pack")] > 0
    assert host_pt[(1, "persist", "window.store")] > 0
    dev_pt, dev_jx = _by(port.events, False), _by(jax.events, False)
    assert {k: v for k, v in dev_pt.items() if k[0] not in PADDED_SITES} \
        == {k: v for k, v in dev_jx.items() if k[0] not in PADDED_SITES}
    assert dev_pt[("seal.rootcheck", "d2h")] == 32 * 6
    assert [n for n, r in port.reports.items() if r["found"]] \
        == [n for n, r in jax.reports.items() if r["found"]]
    for n in WINDOW_LOS:
        rep, ref = port.reports[n], jax.reports[n]
        assert (rep["window"], rep["block_lo"], rep["block_hi"]) \
            == (ref["window"], ref["block_lo"], ref["block_hi"])
        assert set(rep["phases"]) == set(ref["phases"])
        assert set(port.costs[n]["subphases"]) \
            == set(jax.costs[n]["subphases"])
    # journeys
    assert port.journeys == jax.journeys


def test_port_lifecycle_joins_the_stage_threads(port_replay):
    spans = port_replay.spans
    by_id = {s.sid: s for s in spans}
    for n in range(1, 7):
        rec = pt_recorder.lifecycle(spans, n)
        order = rec["phaseOrder"]
        assert rec["complete"]
        assert order.index("window.pack") < order.index("fused.dispatch") \
            < order.index("window.collect")
        for phase in ("window.pack", "window.collect", "window.persist",
                      "window.save"):
            (span,) = rec["phases"][phase]
            parent = by_id[span["parent"]]
            assert parent.name == "window.seal"
            assert parent.tags["block_lo"] == span["tags"]["block_lo"]
            assert span["thread"] != parent.thread_name
    assert pt_recorder.nesting_violations(spans) == []


def test_port_window_reports_and_costs(port_replay):
    reports = port_replay.reports
    assert [n for n, r in reports.items() if r["found"]] == list(range(1, 7))
    for n in WINDOW_LOS:
        rep = reports[n]
        assert (rep["window"], rep["block_lo"], rep["block_hi"]) \
            == (n, n, n + WINDOW - 1)
        rows = port_replay.costs[n]["subphases"]
        assert set(rows) >= {"seal.pack", "seal.dispatch_build",
                             "seal.upload", "seal.rootcheck", "seal.journal"}
        assert all(r["bound"] in ("bytes-bound", "dispatch-bound",
                                  "compute-bound", "fixed-overhead")
                   for r in rows.values())
    assert set(map(tuple, port_replay.journeys.values())) == {
        ("ingress", "seal", "journal.intent", "durable")}


# --------------------------------------------------- disabled / no sync


def test_disabled_replay_is_bit_exact_and_records_nothing(port_replay):
    ns = port_replay.ns
    cfg = dataclasses.replace(ns.RCFG, sync=ns.SyncConfig(
        commit_window_blocks=3, pipeline_depth=2, parallel_tx=False))
    bc = ns.Blockchain(ns.Storages(), cfg)
    bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
    t = pt_trace.Tracer()
    led = pt_profiler.LEDGER
    seen = led.recorded
    assert not (t.enabled or led.enabled or PT_JOURNEY.enabled)
    assert pt_trace.span("x", block=1) is pt_trace._NULL_SPAN
    assert led.transfer("ops.keccak", "h2d", 1) is pt_profiler._NULL_TRANSFER
    ns.ReplayDriver(bc, cfg, device_commit=True, device="cpu",
                    tracer=t).replay(ns.blocks)
    assert t.recorded == 0 and led.recorded == seen and len(PT_JOURNEY) == 0
    traced = port_replay.bc
    for n in range(1, 7):
        assert (bc.get_header_by_number(n).encode()
                == traced.get_header_by_number(n).encode())
        assert (bc.storages.receipts_storage.get(n)
                == traced.storages.receipts_storage.get(n))
    from tests.test_torch_window import _reachable

    root = bc.get_header_by_number(6).state_root
    assert _reachable(bc.storages, root) == _reachable(traced.storages, root)


def test_seams_never_synchronise(monkeypatch):
    calls = []

    def refuse(name):
        def fn(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called")
        return fn

    monkeypatch.setattr(torch.cuda, "synchronize", refuse("synchronize"))
    monkeypatch.setattr(torch.Tensor, "item", refuse("item"))
    monkeypatch.setattr(torch.Tensor, "cpu", refuse("cpu"))
    x = torch.zeros((128, 32), dtype=torch.uint8)
    t = pt_trace.Tracer()
    t.enable()
    led = pt_profiler.LEDGER
    led.reset()
    led.enable()
    PT_JOURNEY.reset()
    PT_JOURNEY.enable()
    try:
        with pt_trace.use_tracer(t):
            with pt_trace.span("window.seal", block_lo=1, block_hi=1,
                               rows=x.numel()) as s:
                s.set_tag("nbytes", x.numel() * x.element_size())
                with led.context(window=1, phase="seal"):
                    with led.transfer("seal.upload", "h2d",
                                      x.numel() * x.element_size()):
                        y = x + 1
                    led.record("seal.pack", "host", y.nbytes)
            pt_trace.event("chaos.fault", site="x")
            PT_JOURNEY.record(b"\x01" * 32, "ingress", source="import")
            PT_JOURNEY.record(b"\x01" * 32, "durable", block=1)
    finally:
        led.disable()
        led.reset()
        PT_JOURNEY.disable()
        PT_JOURNEY.reset()
    assert calls == []
    assert [sp.name for sp in t.snapshot()] == ["window.seal", "chaos.fault"]
