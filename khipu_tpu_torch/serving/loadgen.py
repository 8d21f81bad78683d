"""Seeded open/closed-loop JSON-RPC load generator with a built-in
read-your-writes checker.

The first non-replay workload in the repo: thousands of concurrent
``eth_call`` / ``eth_getBalance`` / ``eth_getTransactionCount`` /
``eth_sendRawTransaction`` clients driving a node WHILE the windowed
pipeline is importing blocks — the millions-of-users scenario the
ROADMAP names, scaled to a harness.

Design points (and why):

* SEEDED — every client owns a ``random.Random(seed + index)``; the
  same seed replays the same request sequence (the chaos-suite
  determinism contract extended to traffic).
* CLOSED loop (default): each client issues its next request when the
  previous answers — models a connection pool, measures capacity.
  OPEN loop: exponential inter-arrival at a target rate per client,
  never waiting for responses to schedule the next arrival — models
  independent users and is the mode that exposes latency collapse
  (closed loops self-throttle exactly when the server melts; Dean &
  Barroso's tail argument needs open arrivals to show).
* TRANSPORTS — in-process (``JsonRpcServer.handle``: no socket noise,
  what the consistency checker wants) and HTTP (the real wire path).
* CHECKER — per-client, per-address monotonicity: account nonces may
  never decrease across polls, balances of accumulate-only addresses
  (pure receivers, the coinbase) may never decrease, and a tx accepted
  by ``eth_sendRawTransaction`` must be IMMEDIATELY visible to
  ``eth_getTransactionByHash`` as pending. Violations carry the
  method, address and the regressing pair.

The port's copy of ``khipu_tpu.serving.loadgen``: the same seed gives
the same request stream as the reference's.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from khipu_tpu_torch.domain.transaction import Transaction, sign_transaction


def _request(method: str, params: list, token: Optional[str]) -> dict:
    req = {"jsonrpc": "2.0", "id": 1, "method": method,
           "params": params}
    if token is not None:
        req["khipuToken"] = token
    return req


class InProcessTransport:
    """Dispatch straight into a JsonRpcServer (admission + SLO hooks
    included) — zero socket overhead, deterministic."""

    supports_tokens = True

    def __init__(self, server):
        self.server = server

    def call(self, method: str, params: list,
             token: Optional[str] = None) -> dict:
        return self.server.handle(_request(method, params, token))

    def call_batch(self, calls: List[tuple],
                   token: Optional[str] = None) -> list:
        return self.server.handle(
            [_request(m, p, token) for m, p in calls]
        )


class HttpTransport:
    """The wire path: one PERSISTENT keep-alive connection per worker
    thread (``http.client.HTTPConnection`` in a ``threading.local``),
    reconnect-on-``RemoteDisconnected``, pipelined batch POSTs, and
    the transport's own overhead measured separately from server time.

    Connection-per-request (the old urllib shape) hides the number
    that matters at fleet scale — with keep-alive the TCP+framing cost
    is paid once per worker and each request's ``transport overhead``
    is wall time minus the server's ``X-Khipu-Served-Ms`` header, the
    honest wire tax the bench reports as ``transport_overhead_ms``."""

    supports_tokens = True

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        parts = urllib.parse.urlsplit(url)
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._path = parts.path or "/"
        self._local = threading.local()
        self._lock = threading.Lock()
        # transport overhead samples (seconds), bounded; reconnect
        # count proves the keep-alive path actually rode one socket
        self._overhead: List[float] = []
        self.reconnects = 0

    # ------------------------------------------------------- connection

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self.timeout
            )
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        self._local.conn = None

    def _post(self, payload: bytes):
        """POST on the worker's persistent connection; one reconnect
        retry when the server closed the idle socket under us (the
        legal keep-alive race — the request was not yet sent, so the
        retry cannot double-execute a write)."""
        headers = {"Content-Type": "application/json"}
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request("POST", self._path, payload, headers)
                resp = conn.getresponse()
                body = resp.read()  # fully drain: keeps the conn reusable
                return resp, body
            except (http.client.RemoteDisconnected,
                    http.client.BadStatusLine,
                    BrokenPipeError,
                    ConnectionResetError):
                self._drop_conn()
                with self._lock:
                    self.reconnects += 1
                if attempt:
                    raise
            except Exception:
                self._drop_conn()
                raise

    def _record_overhead(self, wall_s: float, resp) -> None:
        served = resp.getheader("X-Khipu-Served-Ms")
        if served is None:
            return
        try:
            overhead = wall_s - float(served) / 1e3
        except ValueError:
            return
        with self._lock:
            if len(self._overhead) < 200_000:
                self._overhead.append(max(0.0, overhead))

    # ------------------------------------------------------------ calls

    def call(self, method: str, params: list,
             token: Optional[str] = None) -> dict:
        payload = json.dumps(_request(method, params, token)).encode()
        t0 = time.perf_counter()
        resp, body = self._post(payload)
        self._record_overhead(time.perf_counter() - t0, resp)
        return json.loads(body)

    def call_batch(self, calls: List[tuple],
                   token: Optional[str] = None) -> list:
        """One pipelined POST carrying a JSON-RPC batch array."""
        payload = json.dumps(
            [_request(m, p, token) for m, p in calls]
        ).encode()
        t0 = time.perf_counter()
        resp, body = self._post(payload)
        self._record_overhead(time.perf_counter() - t0, resp)
        return json.loads(body)

    # ---------------------------------------------------------- surface

    def overhead_stats(self) -> Optional[dict]:
        """p50/p99/mean transport overhead in ms (wall minus
        server-reported dispatch time), plus the reconnect count."""
        with self._lock:
            samples = sorted(self._overhead)
            reconnects = self.reconnects
        if not samples:
            return None

        def pct(q):
            i = min(len(samples) - 1, int(q * len(samples)))
            return samples[i]

        return {
            "samples": len(samples),
            "p50Ms": round(pct(0.50) * 1e3, 3),
            "p99Ms": round(pct(0.99) * 1e3, 3),
            "meanMs": round(sum(samples) / len(samples) * 1e3, 3),
            "reconnects": reconnects,
        }


@dataclass
class WorkloadProfile:
    """Method mix as weights; drawn per request from the client RNG."""

    name: str
    weights: Dict[str, float]

    def methods(self) -> List[str]:
        return list(self.weights)

    def cumulative(self):
        total = sum(self.weights.values())
        acc, out = 0.0, []
        for m, w in self.weights.items():
            acc += w / total
            out.append((acc, m))
        return out


# the mixed serving profile the bench drives: read-heavy with a real
# write fraction, the shape public RPC fleets report
MIXED = WorkloadProfile("mixed", {
    "eth_getBalance": 0.34,
    "eth_getTransactionCount": 0.22,
    "eth_blockNumber": 0.14,
    "eth_call": 0.10,
    "eth_sendRawTransaction": 0.10,
    "eth_getTransactionByHash": 0.05,
    "eth_getBlockByNumber": 0.05,
})

READ_ONLY = WorkloadProfile("read_only", {
    "eth_getBalance": 0.5,
    "eth_getTransactionCount": 0.3,
    "eth_blockNumber": 0.2,
})


@dataclass
class Violation:
    client: int
    method: str
    detail: str


@dataclass
class LoadReport:
    requests: int = 0
    ok: int = 0
    shed: int = 0
    errors: int = 0
    seconds: float = 0.0
    # per-method sorted latency samples of ADMITTED requests
    latencies: Dict[str, List[float]] = field(default_factory=dict)
    violations: List[Violation] = field(default_factory=list)
    # HttpTransport only: wall-minus-served overhead percentiles
    transport_overhead: Optional[dict] = None

    @property
    def qps(self) -> float:
        return self.requests / self.seconds if self.seconds else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.requests if self.requests else 0.0

    def _all_sorted(self) -> List[float]:
        out: List[float] = []
        for v in self.latencies.values():
            out.extend(v)
        out.sort()
        return out

    @staticmethod
    def _pct(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
        return sorted_vals[i]

    def p50(self, method: Optional[str] = None) -> float:
        vals = (
            sorted(self.latencies.get(method, []))
            if method else self._all_sorted()
        )
        return self._pct(vals, 0.50)

    def p99(self, method: Optional[str] = None) -> float:
        vals = (
            sorted(self.latencies.get(method, []))
            if method else self._all_sorted()
        )
        return self._pct(vals, 0.99)

    def summary(self) -> dict:
        out = {
            "requests": self.requests,
            "ok": self.ok,
            "shed": self.shed,
            "errors": self.errors,
            "qps": round(self.qps, 1),
            "shedRate": round(self.shed_rate, 4),
            "p50Ms": round(self.p50() * 1e3, 3),
            "p99Ms": round(self.p99() * 1e3, 3),
            "violations": len(self.violations),
        }
        if self.transport_overhead is not None:
            out["transportOverhead"] = self.transport_overhead
        return out


class _Client(threading.Thread):
    """One concurrent RPC client: seeded request stream + local
    consistency ledger (highest nonce / balance seen per address)."""

    def __init__(self, index: int, gen: "LoadGenerator"):
        super().__init__(name=f"loadgen-{index}", daemon=True)
        self.index = index
        self.gen = gen
        self.rng = random.Random(gen.seed * 100_003 + index)
        self.latencies: Dict[str, List[float]] = {}
        self.ok = self.shed = self.errors = self.requests = 0
        self.violations: List[Violation] = []
        # checker state: addr -> highest nonce / balance observed
        self._nonce_seen: Dict[str, int] = {}
        self._balance_seen: Dict[str, int] = {}
        self._tx_nonce = 0
        # consistent-read token: echoed on every request when the
        # transport supports it, refreshed from every response — this
        # is what makes the monotone checks above hold across a
        # replica fleet (the router honors the floor or redirects)
        self._token: Optional[str] = None
        self._tokens = getattr(gen.transport, "supports_tokens", False)

    # ------------------------------------------------------ request gen

    def _pick_address(self, pool: List[str]) -> str:
        if not pool:  # address-less runs still exercise the method
            return "0x" + "00" * 20
        return pool[self.rng.randrange(len(pool))]

    def _build(self, method: str):
        g = self.gen
        if method == "eth_getBalance":
            return [self._pick_address(g.balance_addresses), "latest"]
        if method == "eth_getTransactionCount":
            return [self._pick_address(g.nonce_addresses), "latest"]
        if method == "eth_call":
            return [
                {"to": self._pick_address(g.balance_addresses),
                 "value": "0x1"},
                "latest",
            ]
        if method == "eth_getBlockByNumber":
            return ["latest", False]
        if method == "eth_getTransactionByHash":
            h = g._sent_hashes
            if not h:
                return [
                    "0x" + bytes(32).hex()
                ]  # nothing sent yet: a miss is a valid answer
            return [h[self.rng.randrange(len(h))]]
        if method == "eth_sendRawTransaction":
            return [self._raw_tx()]
        return []

    def _raw_tx(self) -> str:
        g = self.gen
        key = g.client_keys[self.index % len(g.client_keys)]
        nonce = self._tx_nonce
        self._tx_nonce += 1
        to = bytes.fromhex(
            self._pick_address(g.balance_addresses)[2:]
        )
        stx = sign_transaction(
            Transaction(nonce, 10**9, 21_000, to, 1 + self.index),
            key, chain_id=g.chain_id,
        )
        return "0x" + stx.encode().hex()

    # --------------------------------------------------------- checking

    def _check(self, method: str, params, result) -> None:
        if result is None:
            return
        if method == "eth_getTransactionCount":
            addr = params[0]
            nonce = int(result, 16)
            last = self._nonce_seen.get(addr, -1)
            if nonce < last:
                self.violations.append(Violation(
                    self.index, method,
                    f"nonce of {addr} regressed {last} -> {nonce}",
                ))
            else:
                self._nonce_seen[addr] = nonce
        elif method == "eth_getBalance":
            addr = params[0]
            bal = int(result, 16)
            last = self._balance_seen.get(addr, -1)
            if bal < last:
                self.violations.append(Violation(
                    self.index, method,
                    f"balance of {addr} regressed {last} -> {bal}",
                ))
            else:
                self._balance_seen[addr] = bal

    def _check_pending_visible(self, tx_hash: str) -> None:
        """Read-your-writes for the pool: the tx we JUST sent must
        already resolve (as pending or mined)."""
        if self._tokens:
            resp = self.gen.transport.call(
                "eth_getTransactionByHash", [tx_hash],
                token=self._token,
            )
        else:
            resp = self.gen.transport.call(
                "eth_getTransactionByHash", [tx_hash]
            )
        err = resp.get("error")
        if err is not None:
            if err.get("code") == -32005:
                return  # shed lookups prove nothing either way
            self.violations.append(Violation(
                self.index, "eth_getTransactionByHash",
                f"lookup of own pending tx errored: {err}",
            ))
            return
        if resp.get("result") is None:
            self.violations.append(Violation(
                self.index, "eth_getTransactionByHash",
                f"own tx {tx_hash} invisible right after accept",
            ))

    # ------------------------------------------------------------- loop

    def run(self) -> None:
        g = self.gen
        cum = g.profile.cumulative()
        next_at = time.perf_counter()
        while not g._stop.is_set():
            if g.rate_per_client is not None:  # open loop
                next_at += self.rng.expovariate(g.rate_per_client)
                delay = next_at - time.perf_counter()
                if delay > 0:
                    if g._stop.wait(delay):
                        break
            r = self.rng.random()
            method = next(m for edge, m in cum if r <= edge)
            params = self._build(method)
            t0 = time.perf_counter()
            try:
                if self._tokens:
                    resp = g.transport.call(
                        method, params, token=self._token
                    )
                else:
                    resp = g.transport.call(method, params)
            except Exception as e:
                self.requests += 1
                self.errors += 1
                self.violations.append(Violation(
                    self.index, method, f"transport error: {e}"
                ))
                continue
            dt = time.perf_counter() - t0
            self.requests += 1
            if self._tokens:
                fresh = resp.get("khipuToken")
                if fresh is not None:
                    self._token = fresh
            err = resp.get("error")
            if err is not None and err.get("code") == -32005:
                self.shed += 1
            elif err is not None:
                self.errors += 1
                self.latencies.setdefault(method, []).append(dt)
            else:
                self.ok += 1
                self.latencies.setdefault(method, []).append(dt)
                self._check(method, params, resp.get("result"))
                if method == "eth_sendRawTransaction":
                    g._sent_hashes.append(resp["result"])
                    self._check_pending_visible(resp["result"])
            if g.max_requests and self.requests >= g.max_requests:
                break


class LoadGenerator:
    """Drive ``clients`` concurrent workers for ``duration`` seconds
    (or ``max_requests`` per client, whichever first).

    ``rate`` (total requests/s across all clients) switches to the
    open loop. ``nonce_addresses`` are checked for monotone nonces;
    ``balance_addresses`` must be accumulate-only (pure receivers /
    coinbase) and are checked for monotone balances."""

    def __init__(
        self,
        transport,
        profile: WorkloadProfile = MIXED,
        clients: int = 8,
        duration: float = 2.0,
        seed: int = 0,
        rate: Optional[float] = None,
        max_requests: int = 0,
        nonce_addresses: Optional[List[str]] = None,
        balance_addresses: Optional[List[str]] = None,
        client_keys: Optional[List[bytes]] = None,
        chain_id: int = 1,
    ):
        self.transport = transport
        self.profile = profile
        self.clients = clients
        self.duration = duration
        self.seed = seed
        self.rate_per_client = rate / clients if rate else None
        self.max_requests = max_requests
        self.nonce_addresses = nonce_addresses or []
        self.balance_addresses = balance_addresses or []
        # keys funding eth_sendRawTransaction streams (one per client,
        # reused round-robin; distinct from the checker addresses)
        self.client_keys = client_keys or [
            (0x5EED_0000 + i).to_bytes(32, "big")
            for i in range(clients)
        ]
        self.chain_id = chain_id
        self._stop = threading.Event()
        self._sent_hashes: List[str] = []  # append-only (GIL-atomic)

    def run(self) -> LoadReport:
        workers = [_Client(i, self) for i in range(self.clients)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        if self.max_requests:
            for w in workers:
                w.join()  # bounded by max_requests per client
            self._stop.set()
        else:
            time.sleep(self.duration)
            self._stop.set()
            for w in workers:
                w.join(timeout=30.0)
        report = LoadReport(seconds=time.perf_counter() - t0)
        for w in workers:
            report.requests += w.requests
            report.ok += w.ok
            report.shed += w.shed
            report.errors += w.errors
            report.violations.extend(w.violations)
            for m, vals in w.latencies.items():
                report.latencies.setdefault(m, []).extend(vals)
        stats_fn = getattr(self.transport, "overhead_stats", None)
        if callable(stats_fn):
            report.transport_overhead = stats_fn()
        return report
