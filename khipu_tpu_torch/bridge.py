"""The bridge: block batches in, verified state roots back.

The port's copy of ``khipu_tpu.bridge``, with its own transport. Parity:
SURVEY §2.9 north-star channel — "Akka regular-sync actors stream block
batches to the TPU host over a thin gRPC bridge". The service is
schema-light by design (raw-bytes methods, RLP payloads): every method
is a unary call of opaque bytes, and every payload is byte-equal to the
reference's for the same request.

Methods (all request/response = opaque bytes):
  ExecuteBlocks: rlp([block_rlp, ...]) -> rlp([[number_be, root], ...])
                 — executes + persists through the replay driver on the
                 server's device (at ``commit_window_blocks > 1`` the
                 windowed commit: one K5 launch a window on the card,
                 K1r for the sender batches), all roots gated.
  BestBlock:     b"" -> rlp([number_be, hash])
  GetStateRoot:  rlp(number_be) -> root (32 bytes) | b"" if unknown
  GetNodeData:   rlp([hash, ...]) -> rlp([value-or-empty, ...]) — the
                 served node cache: remote hosts heal missing trie nodes
                 through it
  PutNodeData:   rlp([[hash, value], ...]) -> rlp(admitted_be) — the
                 write-replication half; values are content-address
                 verified before admission
  StreamNodeData, EngineInfo, StreamSegments — the live-rebalance pull
                 paths (cluster/rebalance.py)
  Ping:          x -> x, EXCEPT the clock-probe sentinel
                 (``CLOCK_PROBE``) which answers rlp(shard_wall_us_be)
  GetTraceSpans: b"" -> rlp([trace_id, [span...]]) — the shard's span
                 ring with ABSOLUTE shard-wall microsecond stamps
  GetMetrics:    b"" -> the shard registry's families
                 (observability/telemetry.encode_metrics)

The transport (the one difference from the reference, whose wire is
gRPC: a gRPC client cannot call this bridge, nor this client a gRPC
bridge). A call is a POST of the request bytes to
``/khipu.Bridge/<Method>`` over HTTP/1.1 keep-alive, with
``TCP_NODELAY`` on both ends and each message sent in one write. The
three trace metadata keys ride as headers. A failed call answers with
a ``khipu-status`` header naming the gRPC status (``INVALID_ARGUMENT``,
``FAILED_PRECONDITION``, ``NOT_FOUND``, ``INTERNAL``, ``UNAVAILABLE``,
``UNKNOWN``, ...) and the details as the body; the client raises a
``BridgeError`` whose ``.code()`` is that name. The client's
``deadline`` is the socket timeout, raised as ``DEADLINE_EXCEEDED``; a
refused or dropped connection is ``UNAVAILABLE``. Nothing retries inside
the transport: the cluster client owns retries.

``ExecuteBlocks`` always commits through the device path on the
server's ``device`` (the card unless the caller names the CPU, where the
plain versions run), windowed at ``commit_window_blocks > 1``; the
reference's ``device_commit`` switch and its host hasher have no
counterpart. Refusals that are the caller's fault (validation,
execution, RLP, signature, a missing node, a window root the
re-execution refutes) answer ``FAILED_PRECONDITION`` as in the
reference. Any other error (a failed launch, a wrapper's
``ValueError``, an injected device fault) answers ``INTERNAL``, and every
later ``ExecuteBlocks`` answers ``UNAVAILABLE`` until the torn window has
been settled by ``sync/journal.recover`` (``ReplayDriver.recover``, or a
board's boot pass): a device error never falls back to the host hasher.

Trace propagation (Dapper-style): every BridgeClient call carries
``khipu-trace-id`` / ``khipu-parent-token`` / ``khipu-sampled``; the
server opens a ``bridge.serve.<Method>`` span in its OWN tracer ring
tagged with the remote linkage, so the driver can pull the ring and nest
shard work under the exact RPC span that caused it.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.chaos import fault_point, fault_value
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes
from khipu_tpu_torch.observability.trace import (
    Tracer,
    apply_config as apply_trace_config,
    current_tracer,
    use_tracer,
)

SERVICE = "khipu.Bridge"

# metadata keys the client attaches on EVERY call (values are the
# caller's tracer identity; khipu-sampled is "1" (record+link), "0"
# (head sampler dropped this trace id; server skips its serve span
# too), or "" (tracing off on the caller, no decision))
MD_TRACE_ID = "khipu-trace-id"
MD_PARENT_TOKEN = "khipu-parent-token"
MD_SAMPLED = "khipu-sampled"
# the response header naming a failed call's status (absent on success)
STATUS_HEADER = "khipu-status"

# Ping clock-probe sentinel: any other payload echoes verbatim; this one
# answers the shard's wall clock in microseconds so one timed Ping
# yields (offset, rtt)
CLOCK_PROBE = b"\x00khipu-clock-probe\x00"

class BridgeError(Exception):
    """A failed bridge call: ``code()`` is the gRPC status name,
    ``details()`` the server's (or the transport's) message."""

    def __init__(self, code: str, details: str = ""):
        super().__init__(f"{code}: {details}")
        self._code = code
        self._details = details

    def code(self) -> str:
        return self._code

    def details(self) -> str:
        return self._details


class _Context:
    """The handler-side call context: the reference's method bodies
    call ``abort`` and ``invocation_metadata`` as on a gRPC context."""

    def __init__(self, metadata):
        self._metadata = metadata

    def invocation_metadata(self):
        return self._metadata

    def abort(self, code: str, details: str):
        raise BridgeError(code, details)


def _encode_trace_spans(tracer_: Tracer) -> bytes:
    """The GetTraceSpans response: the ring as RLP with absolute
    shard-wall microsecond stamps (the driver re-anchors them with the
    Ping offset estimate). Tags ship as JSON — values are display-only
    on the far side; bytes become hex."""
    rows = []
    for s in tracer_.snapshot():
        tags = {
            k: (v.hex() if isinstance(v, bytes) else v)
            for k, v in s.tags.items()
        }
        rows.append([
            to_minimal_bytes(s.sid),
            to_minimal_bytes(s.parent) if s.parent else b"",
            s.name.encode(),
            to_minimal_bytes(int(tracer_.to_wall(s.t0) * 1e6)),
            to_minimal_bytes(int(tracer_.to_wall(s.t1) * 1e6)),
            to_minimal_bytes(s.tid),
            (s.thread_name or "").encode(),
            b"\x01" if s.error else b"",
            json.dumps(tags).encode(),
        ])
    return rlp_encode([tracer_.trace_id.encode(), rows])


def decode_trace_spans(payload: bytes) -> dict:
    """Inverse of ``_encode_trace_spans``: {traceId, spans:[{...}]}
    with ``t0_wall``/``t1_wall`` back in float seconds."""
    trace_id, rows = rlp_decode(payload)
    spans = []
    for row in rows:
        (sid, parent, name, t0, t1, tid, tname, err, tags) = row
        spans.append({
            "sid": from_bytes(sid),
            "parent": from_bytes(parent) if parent else None,
            "name": name.decode(),
            "t0_wall": from_bytes(t0) / 1e6,
            "t1_wall": from_bytes(t1) / 1e6,
            "tid": from_bytes(tid),
            "thread_name": tname.decode(),
            "error": bool(err),
            "tags": json.loads(tags.decode() or "{}"),
        })
    return {"traceId": trace_id.decode(), "spans": spans}


def _on_device(device):
    """The driver's card as this handler thread's current device (its
    kernels launch on the same ``cuda:<index>``)."""
    if device.type == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _nodelay(sock) -> None:
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


class _HttpServer(ThreadingHTTPServer):
    """One thread a connection; the connections are tracked so ``stop``
    can drop the keep-alive ones (a stopped shard must stop answering,
    not keep serving the clients that were already connected)."""

    daemon_threads = True
    block_on_close = False

    def __init__(self, addr, handler):
        super().__init__(addr, handler)
        self.conns = set()
        self.conns_lock = threading.Lock()


class BridgeServer:
    def __init__(self, blockchain: Blockchain, config: KhipuConfig,
                 max_workers: int = 4,
                 tracer: Optional[Tracer] = None, registry=None,
                 device=None):
        self.blockchain = blockchain
        self.config = config
        # where ExecuteBlocks commits (None means the card)
        self.device = device
        # a bound on concurrent handlers, as the reference's thread pool
        self.max_workers = max_workers
        self._workers = threading.BoundedSemaphore(max_workers)
        self._exec_lock = threading.Lock()  # blocks apply serially
        # set by an ExecuteBlocks that failed on the device path: the
        # journal's recovery count then, refused until it moves
        self._torn_at: Optional[int] = None
        self._httpd: Optional[_HttpServer] = None
        self._thread: Optional[threading.Thread] = None
        # the SHARD's own span ring (per-instance: two in-process
        # servers — the 2-shard tests — must not interleave rings),
        # served raw over GetTraceSpans. Enabled by config or by the
        # operator poking ``server.tracer.enable()``.
        self.tracer = tracer if tracer is not None else Tracer()
        apply_trace_config(config.observability, self.tracer)
        # the registry GetMetrics serves: the process REGISTRY by
        # default; in-process multi-shard tests hand each server its
        # own MetricsRegistry so the scraped families stay per-shard
        if registry is None:
            from khipu_tpu_torch.observability.registry import REGISTRY
            registry = REGISTRY
        self.registry = registry
        self._methods = {
            "ExecuteBlocks": self._execute_blocks,
            "BestBlock": self._best_block,
            "GetStateRoot": self._get_state_root,
            "GetNodeData": self._get_node_data,
            "PutNodeData": self._put_node_data,
            "StreamNodeData": self._stream_node_data,
            "EngineInfo": self._engine_info,
            "StreamSegments": self._stream_segments,
            "Ping": self._ping,
            "GetTraceSpans": self._get_trace_spans,
            "GetMetrics": self._get_metrics,
        }

    # ------------------------------------------------------------ methods

    def _execute_blocks(self, request: bytes, context) -> bytes:
        from khipu_tpu_torch.ledger.window import WindowMismatch
        from khipu_tpu_torch.sync.regular_sync import _BLOCK_REFUSED
        from khipu_tpu_torch.sync.replay import (
            ReplayDriver,
            WindowNeedsByzantium,
        )

        try:
            items = rlp_decode(request)
            blocks = [Block.decode(rlp_encode(item)) for item in items]
        except Exception as e:
            context.abort("INVALID_ARGUMENT", f"bad batch: {e}")
        with self._exec_lock:
            journal = self.blockchain.storages.window_journal
            if (self._torn_at is not None
                    and journal.recoveries == self._torn_at):
                context.abort(
                    "UNAVAILABLE",
                    "a device error tore the last batch: settle it with "
                    "recover() before executing more",
                )
            self._torn_at = None
            driver = ReplayDriver(
                self.blockchain, self.config,
                device_commit=True, device=self.device,
                tracer=self.tracer,
            )
            try:
                with _on_device(driver.device):
                    driver.replay(blocks)
            except (_BLOCK_REFUSED + (WindowMismatch,
                                      WindowNeedsByzantium)) as e:
                # the caller's blocks are at fault (a window persists
                # nothing before its roots pass)
                context.abort(
                    "FAILED_PRECONDITION", f"{type(e).__name__}: {e}"
                )
            except Exception as e:
                self._torn_at = journal.recoveries
                context.abort("INTERNAL", f"{type(e).__name__}: {e}")
        out = [
            [to_minimal_bytes(b.number), b.header.state_root]
            for b in blocks
        ]
        return rlp_encode(out)

    def _best_block(self, request: bytes, context) -> bytes:
        n = self.blockchain.best_block_number
        header = self.blockchain.get_header_by_number(n)
        return rlp_encode(
            [to_minimal_bytes(n), header.hash if header else b""]
        )

    def _get_state_root(self, request: bytes, context) -> bytes:
        n = from_bytes(rlp_decode(request))
        header = self.blockchain.get_header_by_number(n)
        return header.state_root if header else b""

    def _get_node_data(self, request: bytes, context) -> bytes:
        """Serve trie nodes / code blobs by hash — the cluster-wide
        node-cache endpoint. Request rlp([hash, ...]), response
        rlp([value-or-empty, ...]) positionally."""
        try:
            hashes = rlp_decode(request)
        except Exception as e:
            context.abort("INVALID_ARGUMENT", f"bad: {e}")
        storages = self.blockchain.storages
        out = []
        for h in hashes[:384]:  # reference caps node batches (conf:100)
            v = storages.get_node_any(h)
            out.append(v if v is not None else b"")
        return rlp_encode(out)

    def _put_node_data(self, request: bytes, context) -> bytes:
        """Admit replicated nodes (cluster write path). Every value is
        verified against its key before it touches the store. Returns
        the count actually admitted."""
        from khipu_tpu_torch.native.keccak import keccak256_batch

        try:
            pairs = rlp_decode(request)
            pairs = [(bytes(h), bytes(v)) for h, v in pairs[:384]]
        except Exception as e:
            context.abort("INVALID_ARGUMENT", f"bad: {e}")
        storages = self.blockchain.storages
        admitted = 0
        good = {}
        # one native batch hash a request (the host library's)
        digests = keccak256_batch([v for _, v in pairs])
        for (h, v), d in zip(pairs, digests):
            if len(h) == 32 and v and d == h:
                good[h] = v
                admitted += 1
        if good:
            # the server cannot know which trie the node belongs to,
            # and get_node_any serves from either store; one update a
            # store a request (one batch append on a segment engine)
            storages.account_node_storage.update([], good)
            storages.storage_node_storage.update([], good)
        return rlp_encode(to_minimal_bytes(admitted))

    def _stream_node_data(self, request: bytes, context) -> bytes:
        """Cursor-paged, range-filtered node export — the live-
        rebalance pull path. Request ``rlp([cursor, count, [[lo, hi],
        ...]])`` (half-open 64-bit ring-point ranges); response
        ``rlp([done, next_cursor, [[hash, value], ...]])`` with at most
        ``count`` pairs whose key hashes into one of the ranges and
        sorts after ``cursor``. Restartable from any cursor."""
        from khipu_tpu_torch.cluster.ring import _point

        try:
            cursor, count_b, raw_ranges = rlp_decode(request)
            count = min(from_bytes(count_b) or 384, 1024)
            ranges = [
                (from_bytes(lo), from_bytes(hi))
                for lo, hi in raw_ranges
            ]
        except Exception as e:
            context.abort("INVALID_ARGUMENT", f"bad: {e}")
        storages = self.blockchain.storages
        try:
            keys = storages.node_keys()
        except Exception as e:
            context.abort(
                "FAILED_PRECONDITION", f"node store cannot stream: {e}"
            )
        out = []
        done = b"\x01"
        for k in keys:
            if cursor and k <= cursor:
                continue
            if ranges:
                pt = _point(k)
                if not any(lo <= pt < hi for lo, hi in ranges):
                    continue
            if len(out) >= count:
                done = b""  # more matching keys remain
                break
            v = storages.get_node_any(k)
            if v is not None:
                out.append([k, v])
        nxt = out[-1][0] if out else bytes(cursor)
        return rlp_encode([done, nxt, out])

    def _engine_info(self, request: bytes, context) -> bytes:
        """Capability negotiation for segment-ship: ``rlp([engine,
        [[topic, seq, size], ...]])``. Non-Kesque engines answer with
        their name and an empty manifest — the caller falls back to the
        paged ``StreamNodeData`` path."""
        storages = self.blockchain.storages
        engine = getattr(storages, "kesque_engine", None)
        if engine is None:
            name = getattr(storages, "engine", "unknown")
            return rlp_encode([name.encode(), []])
        manifest = [
            [topic.encode(), to_minimal_bytes(seq), to_minimal_bytes(size)]
            for topic, seq, size in engine.list_segments()
        ]
        return rlp_encode([b"kesque", manifest])

    def _stream_segments(self, request: bytes, context) -> bytes:
        """Raw whole-frame segment chunks — the bulk-movement unit.
        Request ``rlp([topic, seq, offset, max_bytes])``; response
        ``rlp([done, next_offset, raw])``. Restartable from any offset;
        the RECEIVER verifies every record by content address."""
        storages = self.blockchain.storages
        engine = getattr(storages, "kesque_engine", None)
        if engine is None:
            context.abort(
                "FAILED_PRECONDITION",
                "segment streaming requires the kesque engine",
            )
        try:
            topic_b, seq_b, off_b, max_b = rlp_decode(request)
            topic = topic_b.decode()
            seq = from_bytes(seq_b)
            offset = from_bytes(off_b)
            max_bytes = min(from_bytes(max_b) or (1 << 20), 8 << 20)
        except Exception as e:
            context.abort("INVALID_ARGUMENT", f"bad: {e}")
        try:
            raw, nxt, done = engine.read_chunk(topic, seq, offset,
                                               max_bytes)
        except KeyError as e:
            # compacted away mid-stream: NOT_FOUND tells the puller to
            # refetch the manifest and restart
            context.abort("NOT_FOUND", str(e))
        return rlp_encode([
            b"\x01" if done else b"", to_minimal_bytes(nxt), raw,
        ])

    def _ping(self, request: bytes, context) -> bytes:
        if request == CLOCK_PROBE:
            # shard wall clock, anchored through the tracer epoch so a
            # test can inject a known offset by shifting epoch_wall
            now = self.tracer.to_wall(time.perf_counter())
            return rlp_encode(to_minimal_bytes(int(now * 1e6)))
        return request

    def _get_trace_spans(self, request: bytes, context) -> bytes:
        return _encode_trace_spans(self.tracer)

    def _get_metrics(self, request: bytes, context) -> bytes:
        from khipu_tpu_torch.observability.telemetry import encode_metrics

        return encode_metrics(self.registry)

    # ------------------------------------------------------------- server

    def serve(self, name: str, request: bytes, metadata=()) -> bytes:
        """One call of method ``name``, as the transport dispatches it:
        the chaos seam, the linked serve span, the handler. Raises
        ``BridgeError`` for a failed call."""
        fn = self._methods.get(name)
        if fn is None:
            raise BridgeError("UNIMPLEMENTED", f"unknown method {name}")
        context = _Context(tuple(metadata))
        # chaos seam per served method: a `latency` rule here models a
        # slow shard (what the client's rpc_deadline exists for), a
        # `raise` rule a shard-side failure
        fault_point(f"bridge.serve.{name}")
        tr = self.tracer
        if not tr.enabled:
            return fn(request, context)
        # server-side span, linked to the remote parent from the
        # propagated metadata (tags, not a local parent id — the token
        # lives in the CALLER's id space)
        tags = {"method": name}
        md = dict(metadata)
        sampled = md.get(MD_SAMPLED)
        if sampled == "0":
            # the caller's head sampler dropped this trace id: no
            # server span, so one trace is whole or absent fleet-wide
            return fn(request, context)
        if sampled == "1":
            tags["remote_trace"] = md.get(MD_TRACE_ID, "")
            tok = md.get(MD_PARENT_TOKEN, "")
            if tok.isdigit():
                tags["remote_parent"] = int(tok)
        with use_tracer(tr), tr.span(f"bridge.serve.{name}", **tags):
            return fn(request, context)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        outer = self
        prefix = f"/{SERVICE}/"

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                _nodelay(self.connection)
                with self.server.conns_lock:
                    self.server.conns.add(self.connection)

            def finish(self):
                with self.server.conns_lock:
                    self.server.conns.discard(self.connection)
                try:
                    super().finish()
                except OSError:
                    pass

            def _reply(self, body: bytes, status: Optional[str]) -> None:
                # status line, headers and body in ONE write: a split
                # write meets Nagle + delayed ACK on the peer
                head = [
                    "HTTP/1.1 200 OK" if status is None
                    else "HTTP/1.1 500 Internal Server Error",
                    "Content-Type: application/octet-stream",
                    f"Content-Length: {len(body)}",
                ]
                if status is not None:
                    head.append(f"{STATUS_HEADER}: {status}")
                msg = ("\r\n".join(head) + "\r\n\r\n").encode() + body
                self.wfile.write(msg)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                request = self.rfile.read(length)
                if self.path.startswith(prefix):
                    name = self.path[len(prefix):]
                else:
                    name = ""
                metadata = tuple(
                    (k, self.headers.get(k, ""))
                    for k in (MD_TRACE_ID, MD_PARENT_TOKEN, MD_SAMPLED)
                    if k in self.headers
                )
                with outer._workers:
                    try:
                        body, status = outer.serve(
                            name, request, metadata
                        ), None
                    except BridgeError as e:
                        body, status = e.details().encode(), e.code()
                    except Exception as e:
                        # what a gRPC server answers for an uncaught
                        # handler exception
                        body = (
                            f"Exception calling application: {e}"
                        ).encode()
                        status = "UNKNOWN"
                try:
                    self._reply(body, status)
                except OSError:
                    # the caller gave up (its deadline) and closed
                    self.close_connection = True

            def log_message(self, *args):
                pass  # quiet

        self._httpd = _HttpServer((host, port), Handler)
        bound = self._httpd.server_port  # resolves port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"bridge-{bound}",
        )
        self._thread.start()
        return bound

    def stop(self, grace: float = 0.5) -> None:
        """Stop accepting, drop every open connection (their handler
        threads end), and release the port. ``grace`` bounds the wait
        for the accept loop to end."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        with httpd.conns_lock:
            conns = list(httpd.conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=grace)
            self._thread = None


class BridgeClient:
    """The JVM-side caller's shape, for the cluster and local tooling:
    one keep-alive connection per calling thread."""

    def __init__(self, target: str, deadline: Optional[float] = None):
        # ``deadline``: per-RPC timeout in seconds
        # (ClusterConfig.rpc_deadline) — a hung shard surfaces as
        # DEADLINE_EXCEEDED into the caller's retry/breaker machinery
        # instead of blocking a reader forever. None = no deadline.
        host, _, port = target.rpartition(":")
        self.target = target
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self.deadline = deadline
        self._local = threading.local()
        self._conns = []
        self._conns_lock = threading.Lock()
        self._closed = False

    def _conn(self) -> http.client.HTTPConnection:
        if self._closed:
            raise BridgeError("CANCELLED", "client closed")
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self.deadline
            )
            conn.connect()
            _nodelay(conn.sock)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def _drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            conn.close()

    def _post(self, method: str, payload: bytes, md) -> bytes:
        try:
            conn = self._conn()
            # http.client sends headers and a bytes body in one write
            conn.request(
                "POST", f"/{SERVICE}/{method}", body=payload,
                headers=dict(md, **{
                    "Content-Type": "application/octet-stream",
                }),
            )
            resp = conn.getresponse()
            body = resp.read()
            status = resp.getheader(STATUS_HEADER)
        except BridgeError:
            raise
        except (socket.timeout, TimeoutError) as e:
            self._drop()
            raise BridgeError("DEADLINE_EXCEEDED",
                              f"{self.target}: {e}") from None
        except (OSError, http.client.HTTPException) as e:
            self._drop()
            raise BridgeError(
                "UNAVAILABLE", f"{self.target}: {type(e).__name__}: {e}"
            ) from None
        if status is not None:
            raise BridgeError(status, body.decode(errors="replace"))
        return body

    def _call(self, method: str, payload: bytes) -> bytes:
        fault_point(f"bridge.call.{method}")
        # Dapper propagation: the caller's tracer identity + innermost
        # span token ride on EVERY call (sampled="0" when the head
        # sampler dropped the trace). The ``bridge.call`` span is the
        # client half of the RPC edge; its token is what the server
        # records as remote_parent, so the merged trace nests the
        # server span inside exactly this one.
        t = current_tracer()
        with t.span("bridge.call", method=method) as sp:
            md = (
                (MD_TRACE_ID, t.trace_id),
                (MD_PARENT_TOKEN, str(sp.token or "")),
                (
                    MD_SAMPLED,
                    "1" if t.enabled
                    else ("0" if getattr(t, "_on", False) else ""),
                ),
            )
            return self._post(method, payload, md)

    def execute_blocks(self, blocks: List[Block]):
        payload = rlp_encode(
            [rlp_decode(b.encode()) for b in blocks]
        )
        out = rlp_decode(self._call("ExecuteBlocks", payload))
        return [(from_bytes(n), root) for n, root in out]

    def best_block(self):
        n, h = rlp_decode(self._call("BestBlock", b""))
        return from_bytes(n), h

    def get_state_root(self, number: int) -> Optional[bytes]:
        out = self._call(
            "GetStateRoot", rlp_encode(to_minimal_bytes(number))
        )
        return out if out else None

    def get_node_data(self, hashes: List[bytes]):
        """Fetch nodes by hash from the served node cache; returns
        {hash: value} for the ones the server had. Chunks at the
        server's 384-hash cap."""
        hashes = list(hashes)
        result = {}
        for start in range(0, len(hashes), 384):
            chunk = hashes[start : start + 384]
            out = rlp_decode(self._call("GetNodeData", rlp_encode(chunk)))
            # data seam: a `corrupt` rule bit-flips a fetched node —
            # the caller's content-address check MUST reject it
            result.update(
                (h, fault_value("bridge.node.value", v))
                for h, v in zip(chunk, out) if v
            )
        return result

    def put_node_data(self, nodes) -> int:
        """Replicate {hash: value} onto this shard; returns the number
        of nodes the server verified and admitted. Chunks at the
        server's 384-pair cap."""
        pairs = [[h, v] for h, v in nodes.items()]
        admitted = 0
        for start in range(0, len(pairs), 384):
            out = self._call(
                "PutNodeData", rlp_encode(pairs[start : start + 384])
            )
            admitted += from_bytes(rlp_decode(out))
        return admitted

    def stream_node_data(self, ranges, cursor: bytes = b"",
                         count: int = 384):
        """One page of the shard's nodes whose ring points fall in
        ``ranges``, resuming after ``cursor``: ``(done, next_cursor,
        [(hash, value), ...])``. The caller MUST verify each value by
        content address before forwarding it anywhere."""
        payload = rlp_encode([
            bytes(cursor),
            to_minimal_bytes(count),
            [[to_minimal_bytes(lo), to_minimal_bytes(hi)]
             for lo, hi in ranges],
        ])
        done, nxt, pairs = rlp_decode(
            self._call("StreamNodeData", payload)
        )
        return (
            bool(done),
            nxt,
            [(h, fault_value("bridge.node.value", v))
             for h, v in pairs],
        )

    def engine_info(self):
        """``(engine_name, [(topic, seq, size), ...])`` — the shard's
        storage engine and (for Kesque) its segment manifest."""
        name, manifest = rlp_decode(self._call("EngineInfo", b""))
        return (
            name.decode(),
            [
                (topic.decode(), from_bytes(seq), from_bytes(size))
                for topic, seq, size in manifest
            ],
        )

    def stream_segments(self, topic: str, seq: int, offset: int = 0,
                        max_bytes: int = 1 << 20):
        """One raw whole-frame chunk of a shard's segment:
        ``(raw, next_offset, done)``. The caller MUST verify every
        record by content address before admitting it."""
        done, nxt, raw = rlp_decode(self._call(
            "StreamSegments",
            rlp_encode([
                topic.encode(), to_minimal_bytes(seq),
                to_minimal_bytes(offset), to_minimal_bytes(max_bytes),
            ]),
        ))
        return (
            fault_value("bridge.segment.raw", raw),
            from_bytes(nxt),
            bool(done),
        )

    def ping(self, payload: bytes = b"ping") -> bytes:
        return self._call("Ping", payload)

    def clock_probe(self, samples: int = 5):
        """NTP-style clock estimate from timed Ping probes: ``(offset_s,
        rtt_s)`` for the MINIMUM-RTT probe, ``offset = shard_clock -
        local_clock``, true offset within ±rtt/2 of the estimate."""
        best = None
        for _ in range(max(1, samples)):
            t0 = time.time()
            out = self._call("Ping", CLOCK_PROBE)
            t1 = time.time()
            shard_s = from_bytes(rlp_decode(out)) / 1e6
            rtt = max(0.0, t1 - t0)
            offset = shard_s - (t0 + t1) / 2.0
            if best is None or rtt < best[1]:
                best = (offset, rtt)
        return best

    def get_trace_spans(self) -> dict:
        """Pull the shard's span ring: {traceId, spans:[{...}]} with
        absolute shard-wall second stamps (see decode_trace_spans)."""
        return decode_trace_spans(self._call("GetTraceSpans", b""))

    def get_metrics(self):
        """Pull one consistent snapshot of the shard's metric families:
        ``{name: (kind, help, [(labels_dict, value)])}``."""
        from khipu_tpu_torch.observability.telemetry import decode_metrics

        return decode_metrics(self._call("GetMetrics", b""))

    def close(self) -> None:
        self._closed = True
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()
