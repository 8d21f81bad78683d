"""The port's cluster telemetry plane (observability/telemetry.py) and
export's cluster half against the JAX package's.

* Federation: shards served through fake clients that answer with the
  same ``encode_metrics`` payloads (one set of bytes, decoded by each
  package's own codec), under one fake clock: after each scrape round
  (healthy; one shard failing; aligned and misaligned histograms; a
  shard aged past ``staleness_s``; a breaker open) ``cluster_text()``,
  every ``HealthScore``, ``pressure()`` and ``report()`` equal the
  reference's, and so do the telemetry's own registry samples.
* Watchdog: the same fake stage gauges, journal depth, scrape verdicts,
  rebalance progress and reorg counts under the same fake clock give the
  same trips, events and trip counters in both packages.
* The merged Chrome trace: a traced driver calling two traced shard
  bridges on loopback (the port's over HTTP, the reference's over gRPC)
  gives the same trace shape (event names, phases, processes, shard
  metadata keys) and every ``bridge.serve.*`` event nests inside its
  ``bridge.call`` span's interval.
* ``cluster_pressure`` / ``rebalance_pressure`` signals and
  ``ServingPlane.build(telemetry=)`` wire the federation into admission
  as in the reference.
"""

from tests.test_torch_bridge import _StoresOnly

DEADLINE_S = 10.0


def _pkg(name):
    if name == "port":
        from khipu_tpu_torch import bridge
        from khipu_tpu_torch.cluster import ShardedNodeClient
        from khipu_tpu_torch.config import KhipuConfig, TelemetryConfig
        from khipu_tpu_torch.observability import export, telemetry
        from khipu_tpu_torch.observability.registry import MetricsRegistry
        from khipu_tpu_torch.observability.trace import Tracer, use_tracer
        from khipu_tpu_torch.serving import (
            ServingPlane,
            cluster_pressure,
            rebalance_pressure,
        )
        from khipu_tpu_torch.storage.storages import Storages
    else:
        from khipu_tpu import bridge
        from khipu_tpu.cluster import ShardedNodeClient
        from khipu_tpu.config import KhipuConfig, TelemetryConfig
        from khipu_tpu.observability import export, telemetry
        from khipu_tpu.observability.registry import MetricsRegistry
        from khipu_tpu.observability.trace import Tracer, use_tracer
        from khipu_tpu.serving import (
            ServingPlane,
            cluster_pressure,
            rebalance_pressure,
        )
        from khipu_tpu.storage.storages import Storages
    return dict(locals())


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class PayloadClient:
    """A bridge stand-in answering ``get_metrics`` with fixed payload
    bytes, decoded by the package under test."""

    def __init__(self, decode, payload):
        self.decode = decode
        self.payload = payload
        self.fail = False

    def get_metrics(self):
        if self.fail:
            raise ConnectionError("shard down")
        return self.decode(self.payload)

    def close(self):
        pass


def _shard_payloads():
    """Three shards' GetMetrics payloads, made once by the JAX codec:
    counters, gauges, one histogram family with aligned buckets and one
    whose bounds differ on shard c."""
    jx = _pkg("jax")
    out = {}
    for i, ep in enumerate(("a:1", "b:1", "c:1")):
        reg = jx["MetricsRegistry"]()
        reg.gauge("khipu_pipeline_in_flight").set(i + 1)
        reg.gauge("khipu_journal_depth").set(2 * i)
        c = reg.counter("khipu_blocks_total", "blocks imported")
        for _ in range(10 + i):
            c.inc()
        h = reg.histogram("khipu_rpc_seconds", "rpc latency",
                          buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05 * (i + 1), 0.5):
            h.observe(v)
        bounds = (0.5, 5.0) if ep == "c:1" else (0.1, 1.0)
        h2 = reg.histogram("khipu_odd_seconds", "odd", buckets=bounds)
        h2.observe(0.3)
        out[ep] = jx["telemetry"].encode_metrics(reg)
    return out


class _Breakers:
    """A cluster stand-in whose breaker states the test sets."""

    def __init__(self, states):
        self.states = states

        class B:
            def __init__(self, s):
                self.state = s

        self.breakers = {ep: B(s) for ep, s in states.items()}

    def set(self, ep, state):
        self.breakers[ep].state = state


def _federation_run(name):
    p = _pkg(name)
    payloads = _shard_payloads()
    decode = p["telemetry"].decode_metrics
    shards = {ep: PayloadClient(decode, pl) for ep, pl in payloads.items()}
    clock = FakeClock()
    cluster = _Breakers({ep: "closed" for ep in shards})
    tel = p["telemetry"].ClusterTelemetry(
        list(shards), config=p["TelemetryConfig"](
            enabled=True, scrape_interval=1.0, staleness_s=3.0),
        client_factory=lambda ep: shards[ep], cluster=cluster,
        registry=p["MetricsRegistry"](), clock=clock)

    def view():
        return (tel.cluster_text(),
                {ep: s.as_dict() for ep, s in tel.health_scores().items()},
                tel.pressure(), tel.report(), tel.dead_shards(),
                sorted((n, k, tuple(sorted(lb.items())), v)
                       for n, k, lb, v in tel._registry_samples()))

    trail = [view()]  # never scraped: optimistic
    tel.scrape_once()
    trail.append(view())
    shards["b:1"].fail = True
    clock.t = 1.0
    tel.scrape_once()
    trail.append(view())
    cluster.set("a:1", "open")
    clock.t = 2.5
    shards["b:1"].fail = False
    tel.scrape_once()
    trail.append(view())
    shards["c:1"].fail = True
    clock.t = 7.0  # c's last good scrape is now past staleness_s
    tel.scrape_once()
    trail.append(view())
    return trail, tel.bucket_mismatches, tel.scrapes, tel.scrape_failures


def test_federation_equals_the_reference():
    port = _federation_run("port")
    jax = _federation_run("jax")
    for i, (mine, ref) in enumerate(zip(port[0], jax[0])):
        for j, (a, b) in enumerate(zip(mine, ref)):
            assert a == b, (i, j)
    assert port[1:] == jax[1:]
    trail, mismatches, _scrapes, failures = port
    text = trail[1][0]
    assert 'shard="a:1"' in text and "khipu_rpc_seconds_bucket" in text
    assert mismatches > 0 and failures == 2
    assert trail[2][1]["b:1"]["score"] == 0.0  # unreachable: zero
    assert "c:1" in trail[-1][4]


def _dog_run(name):
    p = _pkg(name)
    clock = FakeClock()
    shards = {ep: PayloadClient(p["telemetry"].decode_metrics, pl)
              for ep, pl in _shard_payloads().items()}
    tel = p["telemetry"].ClusterTelemetry(
        list(shards), config=p["TelemetryConfig"](
            enabled=True, scrape_interval=1.0, staleness_s=3.0),
        client_factory=lambda ep: shards[ep],
        registry=p["MetricsRegistry"](), clock=clock)
    tel.scrape_once()
    gauges = {"stage_persist_depth": 1, "stage_persist_busy_s": 2.0,
              "stage_seal_depth": 0, "stage_seal_busy_s": 0.0}
    depth = [0]
    reb = [(False, 0)]
    reorgs = [0]
    dog = p["telemetry"].Watchdog(
        config=p["TelemetryConfig"](enabled=True, stall_after_s=5.0,
                                    journal_runaway_depth=4,
                                    reorg_storm_count=3,
                                    reorg_storm_window_s=60.0),
        pipeline=gauges, journal_depth=lambda: depth[0], telemetry=tel,
        registry=p["MetricsRegistry"](), clock=clock,
        rebalance=lambda: reb[0], reorg=lambda: reorgs[0])
    dog._phase_share_src = lambda: ({}, 0.0)
    trail = []
    script = [
        (0.0, {}, 0, (False, 0), 0, None),
        (4.0, {}, 5, (True, 10), 1, None),
        (5.0, {}, 9, (True, 10), 2, "b:1"),
        (9.0, {"stage_persist_busy_s": 2.5}, 1, (True, 10), 3, None),
        (15.0, {}, 6, (True, 10), 3, None),
        (16.0, {}, 6, (True, 40), 3, "heal"),
        (30.0, {}, 0, (False, 40), 3, None),
    ]
    for t, bump, jd, rb, rg, event in script:
        clock.t = t
        gauges.update(bump)
        depth[0] = jd
        reb[0] = rb
        reorgs[0] = rg
        if event == "b:1":
            shards["b:1"].fail = True
        elif event == "heal":
            shards["b:1"].fail = False
        tel.scrape_once()  # keeps the live shards fresh
        trail.append(dog.check_once(now=t))
    samples = sorted((n, k, tuple(sorted(lb.items())), v)
                     for n, k, lb, v in dog._registry_samples())
    return trail, dict(dog.trips), list(dog.events), samples


def test_watchdog_trips_equal_the_reference():
    port = _dog_run("port")
    jax = _dog_run("jax")
    assert port == jax
    trail, trips, events, _ = port
    assert trips["stage_stall"] >= 1 and trips["journal_runaway"] >= 1
    assert trips["scrape_dead"] == 1 and trips["reorg_storm"] == 1
    assert trips["rebalance_stuck"] >= 1


def _trace_shape(name, tmp_path):
    """A traced driver calls two traced shard bridges on loopback; the
    merged trace of both rings, reduced to its shape."""
    import json

    p = _pkg(name)
    servers = []
    cl = None
    try:
        eps = []
        for _ in range(2):
            kw = {"device": "cpu"} if name == "port" else {}
            srv = p["bridge"].BridgeServer(
                _StoresOnly(p["Storages"]()), p["KhipuConfig"](), **kw)
            srv.tracer.enable()
            eps.append(f"127.0.0.1:{srv.start(port=0)}")
            servers.append(srv)
        names = ["shard-0:1", "shard-1:1"]
        addr = dict(zip(names, eps))
        cl = p["ShardedNodeClient"](
            names, replication=2, vnodes=16,
            channel_factory=lambda ep: p["bridge"].BridgeClient(
                addr[ep], deadline=DEADLINE_S))
        driver = p["Tracer"]()
        driver.enable()
        with p["use_tracer"](driver):
            cl.replicate({b"\x01" * 32: b"not verified, not admitted"})
            cl.fetch([b"\x02" * 32])
            for ep in names:
                cl.ping(ep)
        shards = cl.collect_traces(probe_samples=3)
        path = tmp_path / f"merged_{name}.json"
        p["export"].dump_merged_chrome_trace(str(path), shards,
                                             driver.snapshot(),
                                             tracer_=driver)
        doc = json.loads(path.read_text())
    finally:
        if cl is not None:
            cl.close()
        for srv in servers:
            srv.stop()
    events = doc["traceEvents"]
    by_token = {}
    for e in events:
        # the clock probes ran outside the driver's tracer: unlinked
        if (e.get("pid", 1) > 1 and e["name"].startswith("bridge.serve.")
                and e["args"].get("remote_parent") is not None):
            by_token.setdefault(e["args"]["remote_parent"], []).append(e)
    nested = sum(len(v) for v in by_token.values())
    # every serve event lies inside its call span's exported interval
    for s in driver.snapshot():
        if s.name != "bridge.call" or s.token not in by_token:
            continue
        c0 = p["export"]._us(s.t0, driver)
        c1 = p["export"]._us(s.t1, driver)
        for e in by_token[s.token]:
            assert c0 - 1e-3 <= e["ts"]
            assert e["ts"] + e.get("dur", 0) <= c1 + 1e-3
    shape = sorted({(e["name"], e["ph"], min(e.get("pid", 1), 2))
                    for e in events if e["ph"] != "C"})
    meta = [sorted(m) for m in doc["otherData"]["shards"]]
    return shape, meta, nested, len(shards)


def test_merged_chrome_trace_has_the_reference_shape(tmp_path):
    port = _trace_shape("port", tmp_path)
    jax = _trace_shape("jax", tmp_path)
    assert port == jax
    shape, meta, nested, n_shards = port
    assert n_shards == 2 and nested >= 4
    assert ("bridge.serve.Ping", "X", 2) in shape


def test_admission_signals_wire_as_the_reference():
    from tests.test_torch_serving import _config, _node

    out = {}
    for name in ("port", "jax"):
        p = _pkg(name)

        class Tel:
            def pressure(self):
                return 0.75

        class Reb:
            def pressure(self):
                return 0.88

        cfg = _config(name, 1)
        plane = p["ServingPlane"].build(_node(name, cfg), cfg,
                                        telemetry=Tel())
        sig_c = p["cluster_pressure"](Tel())
        sig_r = p["rebalance_pressure"](Reb())
        out[name] = (
            [getattr(s, "signal_name", None)
             for s in plane.admission.signals],
            sig_c.signal_name, sig_c(), sig_r.signal_name, sig_r())
    assert out["port"] == out["jax"]
    assert "cluster" in out["port"][0]
