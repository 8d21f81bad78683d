"""ShardedNodeClient: replica-failover reads over the bridge shards.

Parity: DistributedNodeStorage.scala:13-57 — the reference resolves a
node hash to a cluster shard and lets Akka handle delivery, retry and
failover. Explicit here: the ring picks [primary, replicas...] per
key, the client walks that order with bounded exponential-backoff
retries and a per-endpoint circuit breaker (the Akka failure detector
role), verifies every returned value by content address before
admitting it, and falls back to a local store callback when the whole
replica set is down — a read NEVER returns wrong bytes and only
returns None when no copy is reachable anywhere.

Writes replicate: PutNodeData goes to every replica of each key so a
loopback cluster stays consistent when one shard is killed mid-run.

The transport is injectable (``channel_factory``); production uses
the port's bridge.BridgeClient (HTTP), tests plug fakes with scripted
failures. The port's copy of ``khipu_tpu.cluster.client``: the same
ring, retries, seeded jitter, breakers and content-address checks.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.chaos import fault_point, fault_value
from khipu_tpu_torch.cluster.ring import HashRing
from khipu_tpu_torch.observability.trace import span

# breaker states (CircuitBreaker pattern; Akka failure-detector role)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Per-endpoint breaker: ``failure_threshold`` consecutive failures
    open it; after ``reset_timeout`` one probe call is let through
    (half-open) — success closes, failure re-opens the full window."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False  # a half-open probe is in flight

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return CLOSED
            if self._clock() - self._opened_at >= self.reset_timeout:
                return HALF_OPEN
            return OPEN

    def allow(self) -> bool:
        """May a call go to this endpoint right now? Half-open admits
        exactly ONE probe until its outcome is recorded."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._clock() - self._opened_at < self.reset_timeout:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            self._failures += 1
            if self._failures >= self.failure_threshold:
                # re-arm the full window (also on a failed probe)
                self._opened_at = self._clock()


class ShardMetrics:
    """Per-endpoint counters (NodeEntity.scala:28's served-read stats
    role), snapshotted into the khipu_metrics RPC."""

    def __init__(self) -> None:
        self.requests = 0  # RPC calls attempted (incl. retries)
        self.served = 0  # keys answered with verified bytes
        self.missing = 0  # keys the shard did not have
        self.corrupt = 0  # keys whose bytes failed the hash check
        self.failures = 0  # RPC errors (timeouts, resets, refusals)
        self.failovers = 0  # key-groups handed to the next replica
        self.replicated = 0  # keys write-replicated to this shard
        self.backfilled = 0  # keys re-replicated at re-join (anti-entropy)
        self.rebalanced = 0  # keys streamed onto this shard (rebalance)
        self.latency_ns = 0  # total RPC wall time

    def snapshot(self, breaker: CircuitBreaker, alive: bool) -> dict:
        return {
            "alive": alive,
            "breakerState": breaker.state,
            "requests": self.requests,
            "served": self.served,
            "missing": self.missing,
            "corrupt": self.corrupt,
            "failures": self.failures,
            "failovers": self.failovers,
            "replicated": self.replicated,
            "backfilled": self.backfilled,
            "rebalanced": self.rebalanced,
            "latencySeconds": round(self.latency_ns / 1e9, 6),
            "hitRate": round(
                self.served / max(1, self.served + self.missing), 4
            ),
        }


class ShardedNodeClient:
    """NodeDataSource read-through contract over N bridge endpoints.

    ``fetch(hashes) -> {hash: verified bytes}`` plugs directly into
    RemoteReadThroughNodeStorage, the regular-sync heal path and the
    fast-sync download pool. ``replicate(nodes)`` is the write side.
    """

    def __init__(
        self,
        endpoints: Sequence[str],
        replication: int = 2,
        vnodes: int = 64,
        local_get: Optional[Callable[[bytes], Optional[bytes]]] = None,
        max_retries: int = 2,
        backoff_base: float = 0.05,
        backoff_max: float = 1.0,
        breaker_failures: int = 5,
        breaker_reset: float = 30.0,
        channel_factory: Optional[Callable[[str], object]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rpc_deadline: Optional[float] = None,
        missed_cap: int = 100_000,
        jitter_seed: int = 0,
    ):
        if not endpoints:
            raise ValueError("cluster needs at least one endpoint")
        self.ring = HashRing(endpoints, replication, vnodes)
        # the CONFIGURED membership, never shrunk by health verdicts —
        # what a dead endpoint OWNS while it is out of the live ring
        # (the anti-entropy backfill's source of truth)
        self._full_ring = HashRing(endpoints, replication, vnodes)
        self.rpc_deadline = rpc_deadline
        self.local_get = local_get
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._clock = clock
        self._sleep = sleep
        self.breaker_failures = breaker_failures
        self.breaker_reset = breaker_reset
        # retry-backoff jitter from a per-client seeded stream
        # (ClusterConfig.jitter_seed): chaos replay of a retry schedule
        # is bit-reproducible — module-level random would diverge per
        # run and break deterministic fault replay (KL003)
        self._jitter_rng = random.Random(jitter_seed)
        self._channel_factory = channel_factory or self._bridge_factory
        self._channels: Dict[str, object] = {}
        self._channel_lock = threading.Lock()
        self.breakers: Dict[str, CircuitBreaker] = {
            ep: CircuitBreaker(breaker_failures, breaker_reset, clock)
            for ep in endpoints
        }
        self.metrics: Dict[str, ShardMetrics] = {
            ep: ShardMetrics() for ep in endpoints
        }
        self.local_fallbacks = 0  # keys served by the local store
        self.unreachable = 0  # keys no copy could serve
        self._health = None  # attached by HealthMonitor
        self._rebalancer = None  # attached by Rebalancer
        # keys owed to an endpoint that could not take its replica
        # (dead at placement time, or the batch RPC failed) — drained
        # by ``backfill`` when the endpoint re-joins. Bounded: beyond
        # ``missed_cap`` total keys new debts are dropped and counted
        # (the endpoint then needs an offline re-sync, not a backfill)
        self.missed_cap = missed_cap
        self.missed_dropped = 0
        self._missed: Dict[str, Dict[bytes, None]] = {}
        self._missed_total = 0
        self._missed_lock = threading.Lock()
        # unified-registry pull source: the newest client owns the
        # process's cluster telemetry slot (replace-by-key — tests
        # build many short-lived clients)
        try:
            from khipu_tpu_torch.observability.registry import REGISTRY

            REGISTRY.register_collector(
                "cluster", self._registry_samples
            )
        except Exception:
            pass

    # -------------------------------------------------------- transport

    def _bridge_factory(self, endpoint: str):
        from khipu_tpu_torch.bridge import BridgeClient

        return BridgeClient(endpoint, deadline=self.rpc_deadline)

    def _channel(self, endpoint: str):
        with self._channel_lock:
            ch = self._channels.get(endpoint)
            if ch is None:
                ch = self._channels[endpoint] = self._channel_factory(
                    endpoint
                )
            return ch

    def _drop_channel(self, endpoint: str) -> None:
        """Forget a (likely broken) channel so the next call redials."""
        with self._channel_lock:
            ch = self._channels.pop(endpoint, None)
        if ch is not None:
            try:
                ch.close()
            except Exception:
                pass

    def _call(self, endpoint: str, op: Callable[[object], object]):
        """One guarded RPC with bounded retry + expo backoff + jitter.
        Raises the last error after ``max_retries`` extra attempts."""
        breaker = self.breakers[endpoint]
        m = self.metrics[endpoint]
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if not breaker.allow():
                raise ShardUnavailable(f"{endpoint}: breaker open")
            m.requests += 1
            t0 = self._clock()
            try:
                # chaos seam: a `raise` rule (site "cluster.call:*" or
                # per-endpoint) is indistinguishable from an RPC error —
                # it feeds the same retry/backoff/breaker machinery
                fault_point(f"cluster.call:{endpoint}")
                with span(
                    "cluster.call", endpoint=endpoint, attempt=attempt
                ):
                    out = op(self._channel(endpoint))
            except Exception as e:  # bridge.BridgeError or fake failures
                m.latency_ns += int((self._clock() - t0) * 1e9)
                m.failures += 1
                breaker.record_failure()
                self._drop_channel(endpoint)
                last = e
                if attempt < self.max_retries:
                    delay = min(
                        self.backoff_max,
                        self.backoff_base * (2**attempt),
                    )
                    self._sleep(
                        delay * (0.5 + self._jitter_rng.random() / 2)
                    )
                continue
            m.latency_ns += int((self._clock() - t0) * 1e9)
            breaker.record_success()
            return out
        raise last  # type: ignore[misc]

    # ------------------------------------------------------------ reads

    def fetch(self, hashes: List[bytes]) -> Dict[bytes, bytes]:
        """Read-through fetch: {hash: value} for every hash some healthy
        copy holds, every value content-address verified. Missing keys
        are simply absent — the caller's miss semantics apply."""
        remaining = list(dict.fromkeys(bytes(h) for h in hashes))
        result: Dict[bytes, bytes] = {}
        with span("cluster.fetch", keys=len(remaining)) as fetch_sp:
            # per-request shard selection: group keys by their replica
            # chain so one RPC serves each shard's share of the batch
            # read_chain = replicas_for outside a transition; mid-
            # rebalance it tries the NEXT epoch's owners first and
            # falls back to the committed owners, so a half-streamed
            # move can never make a key unreadable
            groups: Dict[tuple, List[bytes]] = {}
            for h in remaining:
                groups.setdefault(
                    tuple(self.ring.read_chain(h)), []
                ).append(h)
            for chain, keys in groups.items():
                want = keys
                for rank, endpoint in enumerate(chain):
                    if not want:
                        break
                    m = self.metrics[endpoint]
                    if rank > 0:
                        m.failovers += 1
                    try:
                        with span(
                            "cluster.replica", endpoint=endpoint,
                            rank=rank, keys=len(want),
                            failover=rank > 0,
                        ):
                            got = self._call(
                                endpoint,
                                lambda ch, w=tuple(want): (
                                    ch.get_node_data(list(w))
                                ),
                            )
                    except Exception:
                        continue  # next replica
                    still: List[bytes] = []
                    for h in want:
                        v = got.get(h)
                        if v is not None:
                            # data seam: `corrupt` rules bit-flip the
                            # fetched bytes — the admission check below
                            # MUST catch every one
                            v = fault_value("cluster.fetch.value", v)
                        if v is None:
                            m.missing += 1
                            still.append(h)
                        elif keccak256(v) != h:
                            m.corrupt += 1  # never admit wrong bytes
                            still.append(h)
                        else:
                            m.served += 1
                            result[h] = v
                    want = still
                for h in want:  # replica set exhausted: local fallback
                    v = self.local_get(h) if self.local_get else None
                    if v is not None and keccak256(v) == h:
                        self.local_fallbacks += 1
                        result[h] = v
                    else:
                        self.unreachable += 1
            fetch_sp.set_tag("served", len(result))
        return result

    # ----------------------------------------------------------- writes

    def replicate(self, nodes: Mapping[bytes, bytes]) -> int:
        """Write-replicate nodes to every replica of each key; returns
        the number of (key, endpoint) placements that succeeded. A dead
        replica is skipped (its breaker records the failure) — the
        read path's failover covers the gap until it heals, and the
        keys the skip left un-placed are remembered per FULL-ring owner
        so ``backfill`` squares the debt at re-join (anti-entropy)."""
        fault_point("cluster.replicate")
        alive = set(self.ring.members)
        per_endpoint: Dict[str, Dict[bytes, bytes]] = {}
        for h, v in nodes.items():
            hb = bytes(h)
            # write_chains = replicas_for outside a transition; mid-
            # rebalance it is the UNION of both epochs' owners, so
            # neither cutover nor rollback can lose a live write
            for endpoint in self.ring.write_chains(hb):
                per_endpoint.setdefault(endpoint, {})[hb] = bytes(v)
            # an out-of-ring CONFIGURED owner missed this write — it
            # comes back with a stale cache unless backfilled
            for endpoint in self._full_ring.replicas_for(hb):
                if endpoint not in alive:
                    self._record_missed(endpoint, (hb,))
        placed = 0
        for endpoint, batch in per_endpoint.items():
            try:
                self._call(
                    endpoint,
                    lambda ch, b=batch: ch.put_node_data(b),
                )
            except Exception:
                # the batch never landed: same debt as a dead owner
                self._record_missed(endpoint, batch)
                continue
            self.metrics[endpoint].replicated += len(batch)
            placed += len(batch)
        return placed

    # ---------------------------------------------------- anti-entropy

    def _record_missed(self, endpoint: str, keys) -> None:
        with self._missed_lock:
            bucket = self._missed.setdefault(endpoint, {})
            for h in keys:
                if h in bucket:
                    continue
                if self._missed_total >= self.missed_cap:
                    self.missed_dropped += 1
                    continue
                bucket[h] = None
                self._missed_total += 1

    def backfill(self, endpoint: str) -> int:
        """Anti-entropy at re-join (HealthMonitor dead->alive): push
        every key the endpoint missed while out of the ring. Values
        come from the local store first, then a cluster fetch; keys no
        copy can produce are dropped (nothing left to replicate).
        Returns keys re-replicated. Failed pushes re-enter the debt."""
        with self._missed_lock:
            bucket = self._missed.pop(endpoint, None)
            if bucket:
                self._missed_total -= len(bucket)
        if not bucket:
            return 0
        keys = list(bucket)
        placed = 0
        for start in range(0, len(keys), 384):
            chunk = keys[start : start + 384]
            batch: Dict[bytes, bytes] = {}
            missing: List[bytes] = []
            for h in chunk:
                v = self.local_get(h) if self.local_get else None
                if v is not None and keccak256(v) == h:
                    batch[h] = v
                else:
                    missing.append(h)
            if missing:
                batch.update(self.fetch(missing))
            if not batch:
                continue
            try:
                self._call(
                    endpoint,
                    lambda ch, b=batch: ch.put_node_data(b),
                )
            except Exception:
                self._record_missed(endpoint, batch)
                continue
            self.metrics[endpoint].backfilled += len(batch)
            placed += len(batch)
        return placed

    # ----------------------------------------------------- membership

    def mark_dead(self, endpoint: str) -> None:
        """Health verdict: take the endpoint out of placement. In-flight
        reads keep their (old-snapshot) replica chains — they fail over
        normally — new reads stop selecting it. An open rebalance
        transition is aborted FIRST (the staged plan assumed the dead
        member), so the committed epoch stays authoritative."""
        rb = self._rebalancer
        if rb is not None:
            rb.on_membership_event(endpoint, alive=False)
        self.ring.remove(endpoint)
        self._drop_channel(endpoint)

    def mark_alive(self, endpoint: str) -> None:
        if endpoint in self.metrics:
            rb = self._rebalancer
            if rb is not None:
                rb.on_membership_event(endpoint, alive=True)
            self.ring.add(endpoint)

    # ------------------------------------------------------- rebalance

    def attach_rebalancer(self, rebalancer) -> None:
        """The live-rebalance driver (cluster/rebalance.py) hooks
        membership verdicts so a shard dying mid-rebalance aborts the
        transition instead of wedging it."""
        self._rebalancer = rebalancer

    def admit_endpoint(self, endpoint: str) -> None:
        """Create the breaker/metrics slots a joining endpoint needs
        before any RPC can address it. Idempotent; does NOT add the
        endpoint to any ring — that is the rebalance cutover's job."""
        if endpoint not in self.breakers:
            self.breakers[endpoint] = CircuitBreaker(
                self.breaker_failures, self.breaker_reset, self._clock
            )
        if endpoint not in self.metrics:
            self.metrics[endpoint] = ShardMetrics()

    def forget_endpoint(self, endpoint: str) -> None:
        """Drop a retired endpoint's channel. Breaker/metrics history
        stays (counters are cumulative-by-contract); the rings were
        already updated by the rebalance cutover."""
        self._drop_channel(endpoint)

    def stream_node_data(self, endpoint: str, ranges, cursor: bytes,
                         count: int):
        """One StreamNodeData page from ``endpoint`` through the
        retry/breaker machinery: ``(done, next_cursor, pairs)``."""
        return self._call(
            endpoint,
            lambda ch: ch.stream_node_data(ranges, cursor, count),
        )

    def engine_info(self, endpoint: str):
        """The shard's storage-engine capability + segment manifest:
        ``(engine_name, [(topic, seq, size), ...])`` — the rebalance
        segment-ship negotiation probe."""
        return self._call(endpoint, lambda ch: ch.engine_info())

    def stream_segments(self, endpoint: str, topic: str, seq: int,
                        offset: int, max_bytes: int):
        """One raw segment chunk through the retry/breaker machinery:
        ``(raw, next_offset, done)``."""
        return self._call(
            endpoint,
            lambda ch: ch.stream_segments(topic, seq, offset, max_bytes),
        )

    def push_nodes(self, endpoint: str, nodes: Mapping[bytes, bytes]) -> int:
        """Rebalance write path: place a verified batch onto a gaining
        owner (server re-verifies by content address before admitting,
        same as the backfill path)."""
        admitted = self._call(
            endpoint, lambda ch, b=dict(nodes): ch.put_node_data(b)
        )
        self.metrics[endpoint].rebalanced += len(nodes)
        return admitted

    def ping(self, endpoint: str) -> bool:
        """Health probe primitive (bypasses retries: one shot)."""
        try:
            ch = self._channel(endpoint)
            ch.ping(b"hb")
        except Exception:
            self._drop_channel(endpoint)
            return False
        return True

    # ------------------------------------------------------ observability

    def metrics_snapshot(self) -> dict:
        """Everything khipu_metrics surfaces about the cluster."""
        alive = set(self.ring.members)
        rb = self._rebalancer
        return {
            "replication": self.ring.replication,
            "members": list(self.ring.members),
            "epoch": self.ring.epoch,
            "inTransition": self.ring.in_transition,
            "rebalance": rb.status() if rb is not None else None,
            "localFallbacks": self.local_fallbacks,
            "unreachable": self.unreachable,
            "missedKeys": self._missed_total,
            "missedDropped": self.missed_dropped,
            "shards": {
                ep: m.snapshot(self.breakers[ep], ep in alive)
                for ep, m in self.metrics.items()
            },
        }

    def _registry_samples(self) -> list:
        """The same counters as ``metrics_snapshot``, flattened into
        registry sample tuples — per-endpoint families labeled
        ``{endpoint=...}``, cluster-wide ones unlabeled."""
        alive = set(self.ring.members)
        out = [
            ("khipu_cluster_local_fallbacks_total", "counter", {},
             self.local_fallbacks),
            ("khipu_cluster_unreachable_total", "counter", {},
             self.unreachable),
            ("khipu_cluster_missed_keys", "gauge", {},
             self._missed_total),
            ("khipu_cluster_missed_dropped_total", "counter", {},
             self.missed_dropped),
            ("khipu_cluster_members", "gauge", {},
             len(self.ring.members)),
            ("khipu_cluster_epoch", "gauge", {}, self.ring.epoch),
        ]
        per_ep = (
            ("khipu_shard_requests_total", "counter", "requests"),
            ("khipu_shard_served_total", "counter", "served"),
            ("khipu_shard_missing_total", "counter", "missing"),
            ("khipu_shard_corrupt_total", "counter", "corrupt"),
            ("khipu_shard_failures_total", "counter", "failures"),
            ("khipu_shard_failovers_total", "counter", "failovers"),
            ("khipu_shard_replicated_total", "counter", "replicated"),
            ("khipu_shard_backfilled_total", "counter", "backfilled"),
            ("khipu_shard_rebalanced_total", "counter", "rebalanced"),
        )
        for ep, m in self.metrics.items():
            lb = {"endpoint": ep}
            for name, kind, attr in per_ep:
                out.append((name, kind, lb, getattr(m, attr)))
            out.append((
                "khipu_shard_latency_seconds_total", "counter", lb,
                round(m.latency_ns / 1e9, 6),
            ))
            out.append(
                ("khipu_shard_alive", "gauge", lb, int(ep in alive))
            )
        return out

    def collect_traces(self, probe_samples: int = 5) -> list:
        """Pull every live shard's span ring + clock estimate (the
        ``merged_chrome_trace`` input; observability/export.py). Shards
        whose channel lacks the trace RPCs — or that fail mid-pull —
        are skipped: a trace dump must never take the cluster down."""
        from khipu_tpu_torch.observability.export import shard_timeline

        shards = []
        for ep in list(self.ring.members):
            try:
                shards.append(shard_timeline(
                    self._channel(ep), endpoint=ep,
                    probe_samples=probe_samples,
                ))
            except Exception:
                continue
        return shards

    def close(self) -> None:
        with self._channel_lock:
            channels, self._channels = dict(self._channels), {}
        for ch in channels.values():
            try:
                ch.close()
            except Exception:
                pass


class ShardUnavailable(Exception):
    """Raised by _call when the breaker refuses the endpoint."""
