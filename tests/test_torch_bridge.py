"""The port's bridge (bridge.py) against the JAX package's gRPC bridge.

The two bridges speak different wires (the port's is HTTP/1.1, the
reference's gRPC), so the comparison is of what a caller sees: the same
request bytes sent to both give the same response bytes, or the same
status name. Each test starts one server of each package on loopback
and stops both in ``finally``; every client call has a deadline.

* ``ExecuteBlocks`` on the JAX-built ERC-20 chain of
  ``tests/test_torch_rpc.py`` at window 1 and window 3, in two batches
  (the port commits with its device commit on the CPU: the plain K1r and
  K5): equal responses, and equal node stores after.
* ``GetNodeData`` (known and unknown), ``PutNodeData`` with one forged
  value, paged and range-filtered ``StreamNodeData``, ``EngineInfo`` and
  ``StreamSegments`` on kesque stores holding the same nodes, ``Ping``
  and the clock probe, the decode of ``GetTraceSpans`` and
  ``GetMetrics``.
* The same bad requests give the same status names.
* A ``bridge.serve.*`` latency rule past the client's deadline gives
  ``DEADLINE_EXCEEDED``; a ``fused.dispatch`` raise inside
  ``ExecuteBlocks`` gives ``INTERNAL`` and then ``UNAVAILABLE`` until
  ``ReplayDriver.recover`` has run (the port's rule; the reference
  answers every replay error with ``FAILED_PRECONDITION``).
* A server span links to its client span across the wire, and 200
  small calls on one connection take under 2 s (a Nagle + delayed-ACK
  stall costs 40 ms a call).
* Every kernel wrapper's launch counter loses no count when two
  threads (two bridges' batches) raise it at once.
"""

import time

import pytest
from khipu_tpu.base.crypto.keccak import keccak256 as jx_keccak
from khipu_tpu.base.rlp import rlp_encode as jx_rlp_encode

from tests.test_torch_rpc import chain_wire
from tests.test_torch_serving import _config, _node

grpc = pytest.importorskip("grpc")

DEADLINE_S = 10.0  # every call in this file
WINDOWS = (1, 3)


def _bridge_pkg(name):
    if name == "port":
        from khipu_tpu_torch import bridge
        from khipu_tpu_torch.chaos import FaultPlan, FaultRule, active
        from khipu_tpu_torch.cluster.ring import RING_SIZE
        from khipu_tpu_torch.observability import telemetry
        from khipu_tpu_torch.observability.trace import Tracer, use_tracer
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.replay import ReplayDriver
    else:
        from khipu_tpu import bridge
        from khipu_tpu.chaos import FaultPlan, FaultRule, active
        from khipu_tpu.cluster.ring import RING_SIZE
        from khipu_tpu.observability import telemetry
        from khipu_tpu.observability.trace import Tracer, use_tracer
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.replay import ReplayDriver
    return dict(locals())


def status(e) -> str:
    """A failed call's status name, from either package's error."""
    code = e.code()
    return code if isinstance(code, str) else code.name


def _server(name, bc, cfg, **kw):
    p = _bridge_pkg(name)
    if name == "port":
        kw.setdefault("device", "cpu")
    return p["bridge"].BridgeServer(bc, cfg, **kw)


class Pair:
    """One server of each package over the same chain state, with a
    client each; ``call`` sends the same bytes to both."""

    def __init__(self, nodes, cfgs, deadline=DEADLINE_S, **kw):
        self.servers, self.clients = {}, {}
        try:
            for name in ("port", "jax"):
                srv = _server(name, nodes[name], cfgs[name], **kw)
                port = srv.start(port=0)
                self.servers[name] = srv
                self.clients[name] = _bridge_pkg(name)["bridge"].BridgeClient(
                    f"127.0.0.1:{port}", deadline=deadline)
        except BaseException:
            self.close()
            raise

    def call(self, method, payload):
        out = {}
        for name, cl in self.clients.items():
            try:
                out[name] = ("ok", cl._call(method, payload))
            except Exception as e:
                out[name] = ("error", status(e))
        return out

    def close(self):
        for cl in self.clients.values():
            cl.close()
        for srv in self.servers.values():
            srv.stop()


def _pair_on(window=1, wire=None, storages=None, **kw):
    cfgs = {name: _config(name, window) for name in ("port", "jax")}
    nodes = {}
    for name in ("port", "jax"):
        if storages is None:
            nodes[name] = _node(name, cfgs[name])
        else:
            nodes[name] = storages(name, cfgs[name])
    if wire:
        p = _bridge_pkg("port")
        p["ReplayDriver"](nodes["port"], cfgs["port"], device_commit=True,
                          device="cpu").replay(_blocks_of("port", wire))
        _bridge_pkg("jax")["ReplayDriver"](nodes["jax"], cfgs["jax"]).replay(
            _blocks_of("jax", wire))
    return Pair(nodes, cfgs, **kw), nodes


def _blocks_of(name, wire):
    from tests.test_torch_rpc import jax_blocks, port_blocks

    return port_blocks(wire) if name == "port" else jax_blocks(wire)


def _stores(storages):
    return [dict(s.source._map) for s in (
        storages.account_node_storage, storages.storage_node_storage,
        storages.evmcode_storage)]


def _batch(wire):
    """The ExecuteBlocks request: rlp([block_rlp, ...]) as raw bytes
    (the block RLPs are lists already, so their concatenation is the
    list payload)."""
    body = b"".join(wire)
    return _list_prefix(len(body)) + body


def _list_prefix(n):
    if n < 56:
        return bytes([0xC0 + n])
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"w{w}")
def test_execute_blocks_answers_as_the_reference(window):
    base, _ = chain_wire()
    pair, nodes = _pair_on(window)
    try:
        first = pair.call("ExecuteBlocks", _batch(base[:2]))
        second = pair.call("ExecuteBlocks", _batch(base[2:]))
        best = pair.call("BestBlock", b"")
        roots = [pair.call("GetStateRoot", jx_rlp_encode(bytes([n])))
                 for n in (1, len(base), len(base) + 7)]
    finally:
        pair.close()
    for out in (first, second, best, *roots):
        assert out["port"] == out["jax"]
        assert out["port"][0] == "ok"
    assert roots[-1]["port"] == ("ok", b"")  # unknown block
    assert _stores(nodes["port"].storages) == _stores(nodes["jax"].storages)
    assert nodes["port"].best_block_number == len(base)


@pytest.fixture(scope="module")
def served():
    """Both packages' nodes replayed through the base chain, served."""
    base, _ = chain_wire()
    pair, nodes = _pair_on(1, wire=base)
    try:
        yield pair, nodes
    finally:
        pair.close()


def test_node_data_reads_and_writes_equal(served):
    pair, nodes = served
    known = list(_stores(nodes["jax"].storages)[0])[:20]
    unknown = [jx_keccak(b"nobody has %d" % i) for i in range(3)]
    req = jx_rlp_encode(known[:7] + unknown + known[7:])
    got = pair.call("GetNodeData", req)
    assert got["port"] == got["jax"] and got["port"][0] == "ok"
    # two honest values and one forged under a real key: 2 admitted
    vals = [b"replicated value %d" % i for i in range(2)]
    pairs = [[jx_keccak(v), v] for v in vals] + [[known[0], b"forged"]]
    put = pair.call("PutNodeData", jx_rlp_encode(pairs))
    assert put["port"] == put["jax"] == ("ok", b"\x02")
    back = pair.call("GetNodeData", jx_rlp_encode([p[0] for p in pairs]))
    assert back["port"] == back["jax"]
    assert _stores(nodes["port"].storages) == _stores(nodes["jax"].storages)


def test_stream_node_data_pages_equal(served):
    pair, _ = served
    ring = _bridge_pkg("port")["RING_SIZE"]
    for ranges in ([], [[0, ring // 3], [ring // 2, ring - 1]]):
        cursor, pages = b"", 0
        while True:
            req = jx_rlp_encode([
                cursor, b"\x07",
                [[lo.to_bytes(8, "big").lstrip(b"\x00"),
                  hi.to_bytes(8, "big").lstrip(b"\x00")]
                 for lo, hi in ranges]])
            out = pair.call("StreamNodeData", req)
            assert out["port"] == out["jax"] and out["port"][0] == "ok"
            pages += 1
            done, cursor, _ = _bridge_pkg("port")["bridge"].rlp_decode(
                out["port"][1])
            if done or pages > 500:
                break
        assert 1 < pages <= 500


class _StoresOnly:
    """A Blockchain stand-in for the bridge methods that read storages
    only (the node and segment RPCs)."""

    def __init__(self, storages):
        self.storages = storages
        self.best_block_number = 0


def test_kesque_segments_equal(tmp_path):
    vals = [b"kesque node %04d" % i * 3 for i in range(300)]
    nodes_in = {jx_keccak(v): v for v in vals}

    def storages(name, cfg):
        st = _bridge_pkg(name)["Storages"]("kesque", str(tmp_path / name))
        st.account_node_storage.update([], nodes_in)
        return _StoresOnly(st)

    pair, nodes = _pair_on(1, storages=storages)
    try:
        info = pair.call("EngineInfo", b"")
        assert info["port"] == info["jax"] and info["port"][0] == "ok"
        name, manifest = _bridge_pkg("port")["bridge"].rlp_decode(
            info["port"][1])
        assert name == b"kesque" and manifest
        chunks = 0
        for topic, seq, _size in manifest:
            off = b""
            while True:
                out = pair.call("StreamSegments",
                                jx_rlp_encode([topic, seq, off, b"\x04\x00"]))
                assert out["port"] == out["jax"] and out["port"][0] == "ok"
                chunks += 1
                done, off, _raw = _bridge_pkg("port")["bridge"].rlp_decode(
                    out["port"][1])
                if done or chunks > 1000:
                    break
        assert 1 < chunks <= 1000
        missing = pair.call("StreamSegments",
                            jx_rlp_encode([b"nodes", b"\x63", b"", b""]))
        assert missing["port"] == missing["jax"]
    finally:
        pair.close()
        for n in nodes.values():
            n.storages.stop()


def test_ping_and_clock_probe(served):
    pair, _ = served
    p = _bridge_pkg("port")["bridge"]
    for payload in (b"", b"ping", bytes(range(256))):
        out = pair.call("Ping", payload)
        assert out["port"] == out["jax"] == ("ok", payload)
    assert p.CLOCK_PROBE == _bridge_pkg("jax")["bridge"].CLOCK_PROBE
    for name, cl in pair.clients.items():
        offset, rtt = cl.clock_probe(samples=3)
        # one process, one clock: the offset is within the round trip
        assert abs(offset) <= rtt / 2 + 1e-3, name
        assert 0 <= rtt < 1.0


def test_trace_spans_and_metrics_decode_across_packages(served):
    pair, _ = served
    port, jax = _bridge_pkg("port"), _bridge_pkg("jax")
    for name in ("port", "jax"):
        pair.servers[name].tracer.enable()
    try:
        pair.call("Ping", b"traced")
        spans = pair.call("GetTraceSpans", b"")
        metrics = pair.call("GetMetrics", b"")
    finally:
        for name in ("port", "jax"):
            pair.servers[name].tracer.disable()
            pair.servers[name].tracer.reset()
    for name in ("port", "jax"):
        raw = spans[name][1]
        mine = port["bridge"].decode_trace_spans(raw)
        assert mine == jax["bridge"].decode_trace_spans(raw)
        names = [s["name"] for s in mine["spans"]]
        assert "bridge.serve.Ping" in names
        assert set(mine["spans"][0]) == {
            "sid", "parent", "name", "t0_wall", "t1_wall", "tid",
            "thread_name", "error", "tags"}
        fams = port["telemetry"].decode_metrics(metrics[name][1])
        assert fams == jax["telemetry"].decode_metrics(metrics[name][1])
        assert fams


def _invalid_block_wire():
    """Block 1 of the base chain with its state root replaced: the
    header validates, the replay refuses the root."""
    import dataclasses

    from khipu_tpu_torch.domain.block import Block

    base, _ = chain_wire()
    b = Block.decode(base[0])
    header = dataclasses.replace(b.header, state_root=b"\x11" * 32)
    return dataclasses.replace(b, header=header).encode()


BAD_REQUESTS = {
    "execute_garbage": ("ExecuteBlocks", b"\xff\x00garbage"),
    "execute_not_blocks": ("ExecuteBlocks", jx_rlp_encode([b"x", b"y"])),
    "execute_bad_root": ("ExecuteBlocks", None),
    "nodes_garbage": ("GetNodeData", b"\xff"),
    "put_garbage": ("PutNodeData", b"\xf9"),
    "stream_garbage": ("StreamNodeData", jx_rlp_encode([b"", b"\x01"])),
    "segments_on_memory": ("StreamSegments",
                           jx_rlp_encode([b"nodes", b"", b"", b""])),
    "state_root_garbage": ("GetStateRoot", b"\xff"),
    "no_such_method": ("NoSuchMethod", b""),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_requests_give_the_same_status(case):
    method, payload = BAD_REQUESTS[case]
    if payload is None:
        payload = _batch([_invalid_block_wire()])
    pair, nodes = _pair_on(1)
    try:
        out = pair.call(method, payload)
        best = pair.call("BestBlock", b"")
    finally:
        pair.close()
    assert out["port"][0] == "error"
    assert out["port"] == out["jax"]
    assert best["port"] == best["jax"]  # a refusal commits nothing


def test_deadline_exceeded_on_a_slow_shard():
    """A 1.5 s ``bridge.serve.Ping`` latency rule against a 0.3 s
    deadline: both clients see DEADLINE_EXCEEDED within 1.2 s, and the
    next call (rule spent) succeeds."""
    pair, _ = _pair_on(1, deadline=0.3)
    try:
        for name in ("port", "jax"):
            p = _bridge_pkg(name)
            plan = p["FaultPlan"](seed=1, rules=[p["FaultRule"](
                "bridge.serve.Ping", "latency", times=1, latency_s=1.5)])
            with p["active"](plan):
                t0 = time.monotonic()
                with pytest.raises(Exception) as e:
                    pair.clients[name].ping(b"slow")
                took = time.monotonic() - t0
                assert status(e.value) == "DEADLINE_EXCEEDED", name
                assert took < 1.2, (name, took)
            time.sleep(1.3)  # let the held handler finish its sleep
            assert pair.clients[name].ping(b"ok") == b"ok"
    finally:
        pair.close()


def test_device_error_is_internal_then_unavailable_until_recover():
    """The port's rule: a ``fused.dispatch`` raise inside a windowed
    ``ExecuteBlocks`` answers INTERNAL (never a host fallback), every
    later batch UNAVAILABLE, until ``ReplayDriver.recover`` settles the
    torn window; then the chain resumes from best and ends on the
    reference's roots. A refused block stays FAILED_PRECONDITION."""
    base, _ = chain_wire()
    p = _bridge_pkg("port")
    cfg = _config("port", 3)
    bc = _node("port", cfg)
    srv = _server("port", bc, cfg)
    cl = None
    try:
        port = srv.start(port=0)
        cl = p["bridge"].BridgeClient(f"127.0.0.1:{port}",
                                      deadline=DEADLINE_S)
        plan = p["FaultPlan"](seed=1, rules=[p["FaultRule"](
            "fused.dispatch", "raise", times=1)])
        with p["active"](plan):
            with pytest.raises(p["bridge"].BridgeError) as e:
                cl._call("ExecuteBlocks", _batch(base))
        assert e.value.code() == "INTERNAL"
        assert "InjectedFault" in e.value.details()
        with pytest.raises(p["bridge"].BridgeError) as e:
            cl._call("ExecuteBlocks", _batch(base))
        assert e.value.code() == "UNAVAILABLE"
        assert cl.ping(b"up") == b"up"  # only ExecuteBlocks is fenced
        p["ReplayDriver"](bc, cfg, device_commit=True,
                          device="cpu").recover()
        best = bc.best_block_number
        out = cl.execute_blocks(_blocks_of("port", base[best:]))
        assert [n for n, _ in out] == list(range(best + 1, len(base) + 1))
        with pytest.raises(p["bridge"].BridgeError) as e:
            cl._call("ExecuteBlocks", _batch([_invalid_block_wire()]))
        assert e.value.code() == "FAILED_PRECONDITION"
    finally:
        if cl is not None:
            cl.close()
        srv.stop()
    ref = _node("jax", _config("jax", 1))
    _bridge_pkg("jax")["ReplayDriver"](ref, _config("jax", 1)).replay(
        _blocks_of("jax", base))
    assert [h.state_root for h in map(bc.get_header_by_number,
                                      range(1, len(base) + 1))] == [
        h.state_root for h in map(ref.get_header_by_number,
                                  range(1, len(base) + 1))]


def test_serve_span_nests_under_its_call_span(served):
    """The client's ``bridge.call`` span token rides as
    ``khipu-parent-token``; the server's ``bridge.serve.Ping`` records it
    as ``remote_parent`` with the caller's trace id, in both
    packages."""
    pair, _ = served
    seen = {}
    for name in ("port", "jax"):
        p = _bridge_pkg(name)
        srv = pair.servers[name]
        caller = p["Tracer"]()
        caller.enable()
        srv.tracer.enable()
        try:
            with p["use_tracer"](caller):
                pair.clients[name].ping(b"linked")
            call = [s for s in caller.snapshot() if s.name == "bridge.call"]
            serve = [s for s in srv.tracer.snapshot()
                     if s.name == "bridge.serve.Ping"]
        finally:
            srv.tracer.disable()
            srv.tracer.reset()
        assert len(call) == 1 and len(serve) == 1, name
        tags = serve[0].tags
        assert tags["remote_trace"] == caller.trace_id
        assert tags["remote_parent"] == call[0].token
        seen[name] = sorted(tags)
    assert seen["port"] == seen["jax"]


def test_small_calls_do_not_stall(served):
    """200 Pings on one keep-alive connection in under 2 s: one write a
    message and TCP_NODELAY on both ends (a Nagle + delayed-ACK stall is
    ~40 ms a call, 8 s for 200)."""
    pair, _ = served
    cl = pair.clients["port"]
    cl.ping(b"warm")
    t0 = time.monotonic()
    for i in range(200):
        assert cl.ping(b"%d" % i) == b"%d" % i
    assert time.monotonic() - t0 < 2.0


@pytest.mark.parametrize("module,counter", [
    ("khipu_tpu_torch.ops.keccak_cuda", "FIXED_LAUNCHES"),
    ("khipu_tpu_torch.ops.keccak_cuda", "RAGGED_LAUNCHES"),
    ("khipu_tpu_torch.trie.fixpoint_cuda", "LAUNCHES"),
    ("khipu_tpu_torch.storage.mirror_cuda", "HASH_LAUNCHES"),
    ("khipu_tpu_torch.storage.mirror_cuda", "VERIFY_LAUNCHES"),
    ("khipu_tpu_torch.trie.exec_validate_cuda", "LAUNCHES"),
])
def test_launch_counters_survive_two_threads(module, counter):
    """Two bridges launch kernels from two threads at once: every
    wrapper's counter, raised through ``build.count_launch``, loses no
    launch (2 x 20,000 counts, the switch interval at 1 us)."""
    import importlib

    from khipu_tpu_torch.ops import build
    from tests.test_torch_ledger import _hammer

    mod = importlib.import_module(module)
    before = getattr(mod, counter)
    _hammer(lambda: build.count_launch(module, counter), 20_000)
    assert getattr(mod, counter) - before == 40_000
