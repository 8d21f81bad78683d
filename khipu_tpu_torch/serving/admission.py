"""SLO-aware admission control: per-method cost classes behind bounded
queues with an AIMD concurrency limiter and pressure-driven shedding.

The anti-pattern this replaces is the ThreadingHTTPServer default:
thread-per-request with no bound anywhere, so overload turns into
unbounded queueing and every request gets slow together (latency
collapse). Welsh's SEDA argument is the fix applied here — explicit
staged admission with BOUNDED queues, rejecting (``-32005 server
busy``) what cannot be served within the SLO instead of degrading
everything:

* every method maps to a COST CLASS (cheap / read / execute / write);
* each class holds an adaptive concurrency limit: additive increase
  while completions land under the class's p99 target, multiplicative
  decrease (x beta, once per cooldown) when they land over — TCP's
  AIMD congestion control transplanted to RPC concurrency;
* a request past the limit waits in a bounded queue for a bounded
  time; past either bound it is shed immediately;
* PRESSURE SIGNALS from the rest of the node — window-pipeline
  occupancy (sync/replay.PIPELINE_GAUGES), commit-journal depth,
  txpool fill — shed classes preemptively (writes first, cheap reads
  last) when the background collector or the pool saturates, BEFORE
  the latency signal would notice.

The port's copy of ``khipu_tpu.serving.admission``. The pipeline signal
reads the port's ``PIPELINE_GAUGES`` (``depth`` is the last run's
pipeline depth, ``in_flight`` the windows sealed and not yet saved, as
in the reference). The rebalance and cluster signals need the sharded
cluster and its telemetry (ROADMAP A11): their factories raise
``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from khipu_tpu_torch.config import ServingConfig
from khipu_tpu_torch.jsonrpc.eth_service import RpcError
from khipu_tpu_torch.observability.registry import REGISTRY

COST_CLASSES = ("cheap", "read", "execute", "write")

# method -> cost class; anything unlisted classifies by prefix below.
_METHOD_CLASS = {
    "eth_call": "execute",
    "eth_estimateGas": "execute",
    "eth_getLogs": "execute",
    "eth_getFilterLogs": "execute",
    "eth_sendRawTransaction": "write",
    "eth_sendTransaction": "write",
    "eth_blockNumber": "cheap",
    "eth_chainId": "cheap",
    "eth_gasPrice": "cheap",
    "eth_protocolVersion": "cheap",
    "eth_syncing": "cheap",
    "eth_mining": "cheap",
    "eth_hashrate": "cheap",
    "eth_accounts": "cheap",
}

_PREFIX_CLASS = (
    ("net_", "cheap"),
    ("web3_", "cheap"),
    ("personal_", "write"),
    ("khipu_", "read"),
)

# default starting concurrency per class (AIMD moves it from here)
DEFAULT_LIMITS = {"cheap": 256, "read": 128, "execute": 16, "write": 32}
_MIN_LIMIT = 2
_MAX_LIMIT = 4096


def classify_method(method: str) -> str:
    cls = _METHOD_CLASS.get(method)
    if cls is not None:
        return cls
    for prefix, cls in _PREFIX_CLASS:
        if method.startswith(prefix):
            return cls
    return "read"  # state reads are the bulk of unknown eth_* traffic


class ServerBusy(RpcError):
    """The JSON-RPC reject the spec-shaped dispatcher already renders:
    -32005 is the de-facto 'limit exceeded' code (geth/infura use it
    for rate/resource rejects; eth_getLogs range caps here already
    do)."""

    def __init__(self, message: str = "server busy"):
        super().__init__(-32005, message)


class _ClassLimiter:
    """One cost class: AIMD limit + in-flight count + bounded waiter
    queue under a single condition variable."""

    __slots__ = (
        "name", "limit", "inflight", "waiting", "max_queue",
        "queue_timeout", "target", "beta", "cooldown",
        "_last_decrease", "cv", "shed_full", "shed_timeout",
        "shed_pressure", "admitted", "peak_inflight",
    )

    def __init__(self, name: str, limit: float, target: float,
                 cfg: ServingConfig):
        self.name = name
        self.limit = float(limit)
        self.inflight = 0
        self.waiting = 0
        self.max_queue = cfg.max_queue
        self.queue_timeout = cfg.queue_timeout
        self.target = target
        self.beta = cfg.aimd_beta
        self.cooldown = cfg.decrease_cooldown
        self._last_decrease = 0.0
        self.cv = threading.Condition()
        self.shed_full = 0
        self.shed_timeout = 0
        self.shed_pressure = 0
        self.admitted = 0
        self.peak_inflight = 0

    def acquire(self) -> bool:
        """Take a slot; False = shed (queue full or wait timed out)."""
        with self.cv:
            if self.inflight < int(self.limit):
                self.inflight += 1
                self.admitted += 1
                if self.inflight > self.peak_inflight:
                    self.peak_inflight = self.inflight
                return True
            if self.waiting >= self.max_queue:
                self.shed_full += 1
                return False
            self.waiting += 1
            deadline = time.monotonic() + self.queue_timeout
            try:
                while self.inflight >= int(self.limit):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.shed_timeout += 1
                        return False
                    self.cv.wait(timeout=remaining)
                self.inflight += 1
                self.admitted += 1
                if self.inflight > self.peak_inflight:
                    self.peak_inflight = self.inflight
                return True
            finally:
                self.waiting -= 1

    def release(self, seconds: float) -> None:
        """Return the slot and feed AIMD with the completion latency."""
        with self.cv:
            self.inflight -= 1
            if seconds > self.target:
                now = time.monotonic()
                if now - self._last_decrease >= self.cooldown:
                    self._last_decrease = now
                    self.limit = max(_MIN_LIMIT, self.limit * self.beta)
            else:
                # +1 slot per `limit` successes — TCP's 1/cwnd shape
                self.limit = min(
                    _MAX_LIMIT, self.limit + 1.0 / max(self.limit, 1.0)
                )
            self.cv.notify()


class AdmissionController:
    """The admission hook ``JsonRpcServer`` calls before dispatch.

    ``signals`` are callables returning a saturation level in [0, 1]
    (see the ``*_pressure`` factories below); the max across them is
    THE pressure, compared against each class's shed threshold.
    ``acquire`` raises :class:`ServerBusy`; the caller maps that to the
    wire error and records the shed in the SLO tracker."""

    def __init__(self, config: Optional[ServingConfig] = None,
                 targets: Optional[Dict[str, float]] = None,
                 limits: Optional[Dict[str, int]] = None,
                 signals: Optional[List[Callable[[], float]]] = None,
                 registry=REGISTRY):
        from khipu_tpu_torch.serving.slo import DEFAULT_P99_TARGETS

        cfg = config or ServingConfig()
        self.config = cfg
        targets = {**DEFAULT_P99_TARGETS, **(targets or {})}
        limits = {**DEFAULT_LIMITS, **(limits or {})}
        self._classes = {
            name: _ClassLimiter(name, limits[name], targets[name], cfg)
            for name in COST_CLASSES
        }
        self.signals = list(signals or [])
        # per-signal shed attribution: when a pressure shed fires, the
        # ARGMAX signal gets the blame — "we shed 400 writes" is
        # useless without "because the cluster was dying"
        self.shed_by_signal: Dict[str, int] = {}
        # >1 disables: pressure is clamped to [0,1] so it never trips
        self._shed_at = {
            "cheap": 2.0,
            "read": cfg.shed_read_at,
            "execute": cfg.shed_execute_at,
            "write": cfg.shed_write_at,
        }
        registry.register_collector("admission", self._registry_samples)

    # ---------------------------------------------------------- pressure

    def add_signal(self, signal: Callable[[], float]) -> None:
        """Attach a pressure signal after construction (the telemetry
        plane starts later than the serving plane)."""
        self.signals.append(signal)

    def pressure_detail(self) -> tuple:
        """``(pressure, {signal_name: value})`` — the max AND the
        per-signal breakdown behind it. Signal names come from the
        factory-stamped ``signal_name`` attribute (``sig_N`` for
        anonymous callables)."""
        detail: Dict[str, float] = {}
        p, worst = 0.0, None
        for i, sig in enumerate(self.signals):
            try:
                v = sig()
            except Exception:
                continue  # a broken signal must not take serving down
            name = getattr(sig, "signal_name", f"sig_{i}")
            detail[name] = min(1.0, max(0.0, v))
            if v > p or worst is None:
                p, worst = max(p, v), name
        return min(1.0, max(0.0, p)), detail

    def pressure(self) -> float:
        p, _detail = self.pressure_detail()
        return p

    # ----------------------------------------------------------- acquire

    def acquire(self, method: str):
        """Admission ticket ``(limiter, t0)`` or :class:`ServerBusy`."""
        cls = self._classes[classify_method(method)]
        if self.signals and self._shed_at[cls.name] <= 1.0:
            p, detail = self.pressure_detail()
            if p >= self._shed_at[cls.name]:
                cls.shed_pressure += 1
                blame = max(detail, key=detail.get) if detail else "none"
                self.shed_by_signal[blame] = (
                    self.shed_by_signal.get(blame, 0) + 1
                )
                raise ServerBusy(
                    f"server busy: load shed ({cls.name} class, "
                    f"pressure {p:.2f}, signal {blame})"
                )
        if not cls.acquire():
            raise ServerBusy(
                f"server busy: {cls.name} class saturated "
                f"(limit {int(cls.limit)})"
            )
        return (cls, time.perf_counter())

    def release(self, ticket) -> float:
        """Finish an admitted request; returns its latency (seconds)."""
        cls, t0 = ticket
        dt = time.perf_counter() - t0
        cls.release(dt)
        return dt

    # ----------------------------------------------------------- surface

    def snapshot(self) -> dict:
        out = {}
        for name, cls in self._classes.items():
            out[name] = {
                "limit": round(cls.limit, 1),
                "inflight": cls.inflight,
                "waiting": cls.waiting,
                "admitted": cls.admitted,
                "peakInflight": cls.peak_inflight,
                "shed": {
                    "queueFull": cls.shed_full,
                    "queueTimeout": cls.shed_timeout,
                    "pressure": cls.shed_pressure,
                },
            }
        pressure, detail = self.pressure_detail()
        out["pressure"] = round(pressure, 4)
        out["pressureBySignal"] = {
            k: round(v, 4) for k, v in detail.items()
        }
        out["shedBySignal"] = dict(self.shed_by_signal)
        return out

    def _registry_samples(self) -> list:
        samples = []
        for name, cls in self._classes.items():
            lb = {"class": name}
            samples.append(
                ("khipu_admission_limit", "gauge", lb,
                 round(cls.limit, 1))
            )
            samples.append(
                ("khipu_admission_inflight", "gauge", lb, cls.inflight)
            )
            for reason, v in (
                ("queue_full", cls.shed_full),
                ("queue_timeout", cls.shed_timeout),
                ("pressure", cls.shed_pressure),
            ):
                samples.append((
                    "khipu_admission_shed_total", "counter",
                    {"class": name, "reason": reason}, v,
                ))
        pressure, detail = self.pressure_detail()
        samples.append(
            ("khipu_admission_pressure", "gauge", {}, round(pressure, 4))
        )
        for sig, v in sorted(detail.items()):
            samples.append((
                "khipu_admission_signal_pressure", "gauge",
                {"signal": sig}, round(v, 4),
            ))
        for sig, v in sorted(self.shed_by_signal.items()):
            samples.append((
                "khipu_admission_shed_by_signal_total", "counter",
                {"signal": sig}, v,
            ))
        return samples


# ------------------------------------------------------ pressure signals


def pipeline_pressure() -> Callable[[], float]:
    """Window-pipeline saturation: sealed-but-uncollected windows over
    depth+1, so a full-but-flowing pipeline (in_flight == depth) reads
    below 1.0 and only a stalled collector pins the signal high."""
    from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES

    def signal() -> float:
        depth = PIPELINE_GAUGES["depth"] or 1
        return PIPELINE_GAUGES["in_flight"] / (depth + 1)

    signal.signal_name = "pipeline"
    return signal


def journal_pressure(storages, pipeline_depth: int = 2) -> Callable[[], float]:
    """Commit-journal backlog: pending intents normally stay under the
    pipeline depth (pruned each drain); a dead or wedged collector
    leaves them standing — depth+ pending = saturated."""
    scale = max(1, pipeline_depth)

    def signal() -> float:
        try:
            return storages.window_journal.depth / (scale + 1)
        except Exception:
            return 0.0

    signal.signal_name = "journal"
    return signal


def txpool_pressure(pool) -> Callable[[], float]:
    def signal() -> float:
        return len(pool) / max(1, pool.capacity)

    signal.signal_name = "txpool"
    return signal


def rebalance_pressure(rebalancer) -> Callable[[], float]:
    """Live-rebalance shed signal: the cluster's rebalancer is not
    ported (ROADMAP A11)."""
    raise NotImplementedError(
        "the cluster rebalancer is not ported (ROADMAP A11)"
    )


def replica_lag_pressure(replica,
                         max_lag_blocks: Optional[int] = None
                         ) -> Callable[[], float]:
    """Follower-staleness shed signal (serving/replica.py): the
    replica's committed-height lag behind the primary over
    ``ServingConfig.max_replica_lag_blocks``. Installed on each
    REPLICA's admission plane, so a wedged or far-behind follower
    sheds the reads the FleetRouter sends it (read class sheds at
    ``shed_read_at`` — lag past ~95% of the bound) instead of serving
    stale state, with ``replica_lag`` taking the shed blame the same
    way the other signals attribute theirs. A healthy tail holds this
    at ~0 (it catches up within one poll interval)."""
    if max_lag_blocks is None:
        max_lag_blocks = replica.config.serving.max_replica_lag_blocks
    scale = max(1, max_lag_blocks)

    def signal() -> float:
        try:
            return replica.lag_blocks() / scale
        except Exception:
            return 0.0

    signal.signal_name = "replica_lag"
    return signal


def cluster_pressure(telemetry) -> Callable[[], float]:
    """Per-shard health folded into admission: the cluster telemetry
    plane is not ported (ROADMAP A11)."""
    raise NotImplementedError(
        "the cluster telemetry plane is not ported (ROADMAP A11)"
    )
