"""Cluster telemetry plane: shard metrics federation, health scoring,
and the pipeline stall watchdog.

The port's copy of ``khipu_tpu.observability.telemetry``: the metrics
wire codec (``encode_metrics`` / ``decode_metrics``, byte-equal to the
reference's payloads; a read replica's ``get_metrics`` answers in it),
``HealthScore``, ``ClusterTelemetry`` (scraping the port's bridge) and
the ``Watchdog``.

Monarch's model (Adams et al., VLDB '20) applied to this node: metrics
stay REGION-LOCAL — every shard owns its ``MetricsRegistry`` and pays
nothing to be scrapeable — and queries federate at the edge. The
``GetMetrics`` bridge RPC (bridge.py) serializes one consistent
``families()`` pull; :class:`ClusterTelemetry` polls every shard on a
seeded-jitter interval and merges the results into ONE shard-labeled
exposition, the same treatment the traces get (``GetTraceSpans`` →
merged chrome timeline).

Merge semantics (never a crash, never a double-count):

* counters and gauges gain a ``shard`` label — per-shard series, NEVER
  summed (rates and maxima are the scraper's job; summing gauges lies);
* histograms merge only when every shard's bucket bounds align — then
  counts/sums add bucket-wise into one unlabeled family. Mismatched
  bounds degrade to per-shard ``shard``-labeled series and increment
  ``khipu_telemetry_bucket_mismatch_total``;
* a shard whose last successful scrape is older than
  ``TelemetryConfig.staleness_s`` stops contributing samples (age-out)
  — stale truth is worse than absence.

On top of the merged view sit the two feedback consumers:

* :class:`HealthScore` — per-shard [0,1] from scrape freshness,
  circuit-breaker state (cluster/client.py), error rate, and scrape
  latency trend; exported as ``khipu_shard_health{endpoint=}`` and
  wrapped by ``serving.admission.cluster_pressure`` so overload on ANY
  replica set sheds writes at the driver before queues back up.
* :class:`Watchdog` — one daemon thread on ``time.monotonic()``
  (KL003) that turns gauge anomalies into typed events: collector-stage
  starvation (stage ``depth`` held while ``busy_s`` is flat),
  journal-depth runaway, and scrape-dead shards. Each trip lands in the
  flight recorder as a ``watchdog.<kind>`` instant event (chrome-trace
  ``i`` phase via export.py) and in
  ``khipu_watchdog_trips_total{kind=}``.

Zero-cost contract: nothing in this module runs unless constructed —
``TelemetryConfig.enabled=False`` (the default) means
``ServiceBoard.start_telemetry()`` returns ``None``: no threads, no
RPCs, bit-exact replay.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from random import Random
from typing import Callable, Dict, List, Optional, Tuple

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.config import TelemetryConfig
from khipu_tpu_torch.observability.registry import (
    REGISTRY,
    MetricsRegistry,
    render_exposition,
)

__all__ = [
    "encode_metrics",
    "decode_metrics",
    "HealthScore",
    "ClusterTelemetry",
    "Watchdog",
]

# watchdog trip kinds — the full label set is exported (zero-valued
# until tripped) so the khipu_watchdog_trips_total family exists from
# the first scrape
WATCHDOG_KINDS = ("stage_stall", "journal_runaway", "scrape_dead",
                  "rebalance_stuck", "phase_anomaly", "reorg_storm")

# collector-pipeline stages the watchdog reads from PIPELINE_GAUGES
# (sync/replay.py: stage_<name>_depth / stage_<name>_busy_s)
_STAGES = ("seal", "collect", "persist", "save")

# HealthScore component weights (must sum to 1.0)
_W_FRESH, _W_BREAKER, _W_ERRORS, _W_LATENCY = 0.4, 0.3, 0.2, 0.1


# ------------------------------------------------------------------ codec


def _decode_value(v):
    # histogram bucket keys rode through JSON as strings; restore the
    # float ``le`` bounds so merged rendering matches local rendering
    if isinstance(v, dict) and "buckets" in v:
        v = dict(v)
        v["buckets"] = {
            float(k): c for k, c in v["buckets"].items()
        }
    return v


def encode_metrics(registry: MetricsRegistry) -> bytes:
    """The GetMetrics response: one consistent ``families()`` pull as
    RLP rows ``[name, kind, help, [[labels_json, value_json], ...]]``.
    Values ship as JSON — ints, floats, and histogram dicts all
    round-trip; RLP frames the rows the same way GetTraceSpans does."""
    rows = []
    for name, (kind, help, samples) in sorted(
        registry.families().items()
    ):
        srows = [
            [
                json.dumps(lb, sort_keys=True).encode(),
                json.dumps(v).encode(),
            ]
            for lb, v in samples
        ]
        rows.append([name.encode(), kind.encode(), help.encode(), srows])
    return rlp_encode(rows)


def decode_metrics(payload: bytes) -> dict:
    """Inverse of :func:`encode_metrics`:
    ``{name: (kind, help, [(labels_dict, value)])}`` — the exact shape
    ``MetricsRegistry.families()`` returns locally."""
    fams = {}
    for name, kind, help, srows in rlp_decode(payload):
        samples = []
        for lb, v in srows:
            labels = json.loads(lb.decode() or "{}")
            value = _decode_value(json.loads(v.decode()))
            samples.append((labels, value))
        fams[name.decode()] = (kind.decode(), help.decode(), samples)
    return fams


# ------------------------------------------------------------ health score


class HealthScore:
    """One shard's health in [0, 1], with the component breakdown kept
    for ``khipu_cluster_report`` (a bare number is undebuggable).

    Components (weights 0.4 / 0.3 / 0.2 / 0.1):

    * ``freshness`` — 1.0 while the last good scrape is within one
      interval, linear decay to 0.0 at ``staleness_s``;
    * ``breaker`` — the cluster client's circuit breaker for this
      endpoint: closed 1.0, half-open 0.5, open 0.0 (1.0 when no
      cluster client is attached);
    * ``errors`` — fraction of recent scrape attempts that succeeded;
    * ``latency`` — last scrape duration vs. its EWMA (a shard whose
      scrape RTT is exploding is about to miss its deadline).

    A shard whose LAST scrape attempt failed scores 0.0 outright —
    unreachable is unhealthy regardless of history, which is what lets
    the admission signal react within ONE scrape interval of a kill."""

    __slots__ = ("endpoint", "score", "components")

    def __init__(self, endpoint: str, score: float,
                 components: Dict[str, float]):
        self.endpoint = endpoint
        self.score = score
        self.components = components

    def as_dict(self) -> dict:
        return {
            "endpoint": self.endpoint,
            "score": round(self.score, 4),
            "components": {
                k: round(v, 4) for k, v in self.components.items()
            },
        }


class _ShardState:
    """Per-endpoint scrape bookkeeping (mutated only under the
    telemetry lock)."""

    __slots__ = (
        "families", "last_ok", "last_attempt", "last_error", "ok",
        "history", "ewma_s", "last_s",
    )

    def __init__(self):
        self.families: Optional[dict] = None
        self.last_ok: Optional[float] = None  # monotonic stamp
        self.last_attempt: Optional[float] = None
        self.last_error: Optional[str] = None
        self.ok = True  # optimistic until the first attempt fails
        self.history: deque = deque(maxlen=8)  # recent attempt bools
        self.ewma_s = 0.0  # scrape-duration EWMA
        self.last_s = 0.0


class ClusterTelemetry:
    """Scrapes every shard's registry over the bridge and serves the
    merged, shard-labeled cluster view.

    ``client_factory(endpoint)`` must return an object with
    ``get_metrics()`` and ``close()`` — ``bridge.BridgeClient`` by
    default; tests plug fakes. ``cluster`` (a
    ``cluster.ShardedNodeClient``, optional) contributes breaker state
    to the health score. All RPCs run OUTSIDE the lock (KL004); state
    updates are brief critical sections."""

    def __init__(self, endpoints, config: Optional[TelemetryConfig] = None,
                 client_factory: Optional[Callable] = None,
                 cluster=None, registry: MetricsRegistry = REGISTRY,
                 tracer=None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or TelemetryConfig(enabled=True)
        self.cluster = cluster
        self.registry = registry
        self.tracer = tracer
        self._clock = clock
        self._factory = client_factory or self._default_factory
        self._lock = threading.Lock()
        self._shards: Dict[str, _ShardState] = {
            ep: _ShardState() for ep in endpoints
        }
        self._clients: Dict[str, object] = {}
        self.scrapes = 0
        self.scrape_failures = 0
        self.bucket_mismatches = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        registry.register_collector(
            "cluster_telemetry", self._registry_samples
        )

    # --------------------------------------------------------- clients

    def _default_factory(self, endpoint: str):
        from khipu_tpu_torch.bridge import BridgeClient

        # a hung shard must surface as a failed scrape before the next
        # poll fires, not block the poller forever
        return BridgeClient(
            endpoint, deadline=self.config.scrape_interval
        )

    def _client(self, endpoint: str):
        cl = self._clients.get(endpoint)
        if cl is None:
            cl = self._clients[endpoint] = self._factory(endpoint)
        return cl

    # --------------------------------------------------------- scraping

    def scrape_once(self) -> int:
        """Scrape every endpoint once; returns how many succeeded.
        Called by the poller thread and directly by tests."""
        ok = 0
        for ep in list(self._shards):
            t0 = self._clock()
            try:
                fams = self._client(ep).get_metrics()
                err = None
            except Exception as e:
                fams, err = None, f"{type(e).__name__}: {e}"
            t1 = self._clock()
            with self._lock:
                st = self._shards[ep]
                st.last_attempt = t1
                st.history.append(err is None)
                if err is None:
                    st.families = fams
                    st.last_ok = t1
                    st.last_error = None
                    st.ok = True
                    st.last_s = t1 - t0
                    st.ewma_s = (
                        st.last_s if st.ewma_s == 0.0
                        else 0.8 * st.ewma_s + 0.2 * st.last_s
                    )
                    ok += 1
                else:
                    st.last_error = err
                    st.ok = False
            self.scrapes += 1
            if err is not None:
                self.scrape_failures += 1
        return ok

    # ---------------------------------------------------------- scoring

    def _score_locked(self, ep: str, st: _ShardState,
                      now: float) -> HealthScore:
        cfg = self.config
        if not st.ok:
            # unreachable beats every weighted component: the signal
            # must cross the shed threshold within ONE interval
            return HealthScore(ep, 0.0, {
                "freshness": 0.0, "breaker": 0.0,
                "errors": 0.0, "latency": 0.0,
            })
        if st.last_ok is None:
            # constructed but never scraped: optimistic, so starting
            # the plane never sheds traffic by itself
            return HealthScore(ep, 1.0, {
                "freshness": 1.0, "breaker": 1.0,
                "errors": 1.0, "latency": 1.0,
            })
        age = now - st.last_ok
        if age <= cfg.scrape_interval:
            fresh = 1.0
        else:
            span = max(1e-9, cfg.staleness_s - cfg.scrape_interval)
            fresh = max(0.0, 1.0 - (age - cfg.scrape_interval) / span)
        breaker = 1.0
        if self.cluster is not None:
            try:
                state = self.cluster.breakers[ep].state
                breaker = {"closed": 1.0, "half-open": 0.5}.get(
                    state, 0.0
                )
            except Exception:
                breaker = 1.0
        errors = (
            sum(st.history) / len(st.history) if st.history else 1.0
        )
        latency = 1.0
        if st.last_s > 0 and st.ewma_s > 0:
            latency = min(1.0, st.ewma_s / st.last_s)
        score = round(
            _W_FRESH * fresh + _W_BREAKER * breaker
            + _W_ERRORS * errors + _W_LATENCY * latency, 9
        )
        return HealthScore(ep, score, {
            "freshness": fresh, "breaker": breaker,
            "errors": errors, "latency": latency,
        })

    def health_scores(self) -> Dict[str, HealthScore]:
        now = self._clock()
        with self._lock:
            return {
                ep: self._score_locked(ep, st, now)
                for ep, st in self._shards.items()
            }

    def pressure(self) -> float:
        """The admission signal: worst-shard unhealth, in [0, 1]. An
        empty endpoint set reads 0.0 (no cluster, no cluster
        pressure)."""
        scores = self.health_scores()
        if not scores:
            return 0.0
        worst = max(1.0 - hs.score for hs in scores.values())
        return min(1.0, max(0.0, worst))

    def dead_shards(self) -> List[str]:
        """Endpoints that were scraped at least once and are now
        unreachable or stale — the watchdog's scrape_dead feed."""
        now = self._clock()
        out = []
        with self._lock:
            for ep, st in self._shards.items():
                if st.last_attempt is None:
                    continue
                stale = (
                    st.last_ok is not None
                    and now - st.last_ok > self.config.staleness_s
                )
                if not st.ok or stale:
                    out.append(ep)
        return out

    # ---------------------------------------------------------- merging

    def merged_families(self) -> dict:
        """Every live shard's families in one namespace:
        ``{name: (kind, help, [(labels, value)])}`` with the merge
        semantics from the module docstring."""
        now = self._clock()
        with self._lock:
            shard_fams = {
                ep: st.families
                for ep, st in self._shards.items()
                if st.families is not None and st.last_ok is not None
                and now - st.last_ok <= self.config.staleness_s
            }
        merged: dict = {}
        hists: dict = {}
        for ep in sorted(shard_fams):
            for name, (kind, help, samples) in shard_fams[ep].items():
                if kind == "histogram":
                    rows = hists.setdefault(name, (help, []))[1]
                    rows.extend(
                        (ep, lb, v) for lb, v in samples
                    )
                else:
                    _k, _h, out = merged.setdefault(
                        name, (kind, help, [])
                    )
                    for lb, v in samples:
                        lbl = dict(lb)
                        lbl["shard"] = ep
                        out.append((lbl, v))
        for name, (help, rows) in hists.items():
            _k, _h, out = merged.setdefault(
                name, ("histogram", help, [])
            )
            by_labels: dict = {}
            for ep, lb, v in rows:
                key = tuple(sorted(lb.items()))
                by_labels.setdefault(key, []).append((ep, lb, v))
            for key in sorted(by_labels):
                group = by_labels[key]
                bounds = {
                    tuple(sorted(v["buckets"])) for _, _, v in group
                }
                if len(bounds) == 1:
                    total = {"count": 0, "sum": 0.0, "buckets": {}}
                    for _, _, v in group:
                        total["count"] += v["count"]
                        total["sum"] = round(total["sum"] + v["sum"], 9)
                        for le in sorted(v["buckets"]):
                            total["buckets"][le] = (
                                total["buckets"].get(le, 0)
                                + v["buckets"][le]
                            )
                    out.append((dict(group[0][1]), total))
                else:
                    # bounds disagree: summing would lie about the
                    # distribution — degrade to per-shard series
                    self.bucket_mismatches += 1
                    for ep, lb, v in group:
                        lbl = dict(lb)
                        lbl["shard"] = ep
                        out.append((lbl, v))
        return merged

    def cluster_text(self) -> str:
        """The merged exposition (Prometheus text 0.0.4) — what
        ``khipu_cluster_metrics_text`` serves. Upholds the same
        one-TYPE-line-per-family invariant as a local registry."""
        return render_exposition(self.merged_families())

    # ----------------------------------------------------------- report

    def report(self) -> dict:
        """``khipu_cluster_report``: per-shard up/down, scrape
        staleness, health breakdown, and the configured key gauges."""
        now = self._clock()
        scores = self.health_scores()
        shards = {}
        with self._lock:
            for ep, st in self._shards.items():
                age = (
                    None if st.last_ok is None
                    else round(now - st.last_ok, 3)
                )
                gauges = {}
                if st.families:
                    for g in self.config.key_gauges:
                        fam = st.families.get(g)
                        if fam and fam[2]:
                            gauges[g] = fam[2][0][1]
                hs = scores[ep]
                shards[ep] = {
                    "up": st.ok,
                    "scrapeAgeSeconds": age,
                    "stale": (
                        age is None or age > self.config.staleness_s
                    ),
                    "health": hs.as_dict(),
                    "degraded": (
                        hs.score < self.config.health_threshold
                    ),
                    "lastError": st.last_error,
                    "keyGauges": gauges,
                }
        return {
            "shards": shards,
            "pressure": round(self.pressure(), 4),
            "scrapes": self.scrapes,
            "scrapeFailures": self.scrape_failures,
            "bucketMismatches": self.bucket_mismatches,
        }

    # ----------------------------------------------------------- poller

    def start(self) -> None:
        """Start the scrape poller (idempotent). The sleep is
        ``interval * (0.8..1.2)`` drawn from a SEEDED RNG stream
        (KL003): concurrent pollers de-phase deterministically, never
        from wall-clock entropy."""
        if self._thread is not None:
            return
        self._stop.clear()
        rng = Random(self.config.jitter_seed)

        def loop():
            while True:
                delay = self.config.scrape_interval * (
                    0.8 + 0.4 * rng.random()
                )
                if self._stop.wait(delay):
                    return
                try:
                    self.scrape_once()
                except Exception:
                    # a scrape pass must never kill the poller; the
                    # per-endpoint failures are already counted
                    pass

        self._thread = threading.Thread(
            target=loop, name="khipu-telemetry", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        for cl in self._clients.values():
            try:
                cl.close()
            except Exception:
                pass
        self._clients.clear()

    # --------------------------------------------------------- registry

    def _registry_samples(self) -> list:
        now = self._clock()
        samples = []
        with self._lock:
            scores = {
                ep: self._score_locked(ep, st, now)
                for ep, st in self._shards.items()
            }
            ages = {
                ep: now - st.last_ok
                for ep, st in self._shards.items()
                if st.last_ok is not None
            }
        for ep, hs in sorted(scores.items()):
            samples.append((
                "khipu_shard_health", "gauge", {"endpoint": ep},
                round(hs.score, 4),
            ))
        for ep, age in sorted(ages.items()):
            samples.append((
                "khipu_telemetry_scrape_age_seconds", "gauge",
                {"endpoint": ep}, round(age, 3),
            ))
        samples.append((
            "khipu_telemetry_scrapes_total", "counter", {},
            self.scrapes,
        ))
        samples.append((
            "khipu_telemetry_scrape_failures_total", "counter", {},
            self.scrape_failures,
        ))
        samples.append((
            "khipu_telemetry_bucket_mismatch_total", "counter", {},
            self.bucket_mismatches,
        ))
        return samples


# --------------------------------------------------------------- watchdog


class Watchdog:
    """Gauge anomalies → typed events. One daemon thread on
    ``time.monotonic()`` (KL003: never wall clock — a stall detector
    that NTP can fake out is worse than none), chaos-safe: the loop
    catches ``Exception`` only, so an ``InjectedDeath`` (BaseException)
    still kills it the way a real death would.

    Detections, all edge-triggered (one trip per episode, re-armed by
    progress):

    * ``stage_stall`` — a collector stage holds ``depth > 0`` while its
      ``busy_s`` gauge is flat for ``stall_after_s``: work is queued
      and NOTHING is completing (the starvation signature; a busy slow
      stage keeps advancing busy_s and never trips);
    * ``journal_runaway`` — window-journal pending depth beyond
      ``journal_runaway_depth``: the committer is wedged while the
      driver keeps sealing;
    * ``scrape_dead`` — a shard the telemetry plane scraped before is
      now unreachable or stale;
    * ``rebalance_stuck`` — a ring transition epoch is open while the
      rebalance progress gauge (keys streamed) stays flat for
      ``stall_after_s``: movement wedged mid-epoch (attach a source
      with ``attach_rebalance``; a progressing or closed transition
      re-arms);
    * ``phase_anomaly`` — one lifecycle phase's share of total
      canonical phase wall time exceeds its configured ceiling (e.g.
      ``window.seal`` > 0.6 — the seal-wall alarm): the pipeline has
      collapsed into one phase. Judged only after
      ``phase_share_min_total_s`` of phase time; re-armed when the
      share drops back under the ceiling.

    Every trip emits a ``watchdog.<kind>`` instant event into the
    flight recorder (zero-duration span → chrome-trace ``i`` phase) and
    increments ``khipu_watchdog_trips_total{kind=}``."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 pipeline=None,
                 journal_depth: Optional[Callable[[], int]] = None,
                 telemetry: Optional[ClusterTelemetry] = None,
                 tracer=None, registry: MetricsRegistry = REGISTRY,
                 clock: Callable[[], float] = time.monotonic,
                 rebalance: Optional[Callable[[], tuple]] = None,
                 reorg: Optional[Callable[[], int]] = None):
        self.config = config or TelemetryConfig(enabled=True)
        self.registry = registry
        self._pipeline = pipeline  # dict-like stage gauges (or lazy)
        self._journal_depth = journal_depth
        self.telemetry = telemetry
        self.tracer = tracer
        self._clock = clock
        self.trips: Dict[str, int] = {k: 0 for k in WATCHDOG_KINDS}
        # (kind, scenario_event_id) -> trips attributed to an injected
        # gameday hazard (chaos/scenario.py correlation)
        self.scenario_trips: Dict[Tuple[str, str], int] = {}
        self.events: deque = deque(maxlen=64)  # (kind, tags) recent
        self._stage: Dict[str, dict] = {}
        self._journal_over = False
        self._dead: set = set()
        self._rebalance_src = rebalance
        self._reb = {"prog": None, "since": 0.0, "tripped": False}
        self._reorg_src = reorg
        self._rg = {"samples": deque(), "tripped": False}
        self._phase_over: Dict[str, bool] = {}
        self._phase_share_src = None  # injectable: () -> (shares, total_s)
        # baseline snapshot: shares are judged over phase time accrued
        # AFTER this watchdog existed, not the process lifetime
        try:
            self._phase_base: Dict[str, float] = self._phase_sums()
        except Exception:
            self._phase_base = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        registry.register_collector("watchdog", self._registry_samples)

    # -------------------------------------------------------- detection

    def _gauges(self):
        if self._pipeline is None:
            from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES

            self._pipeline = PIPELINE_GAUGES
        return self._pipeline

    def _trip(self, kind: str, **tags) -> None:
        self.trips[kind] = self.trips.get(kind, 0) + 1
        # gameday correlation: when a chaos scenario is live, stamp
        # the most recent injected event's id onto the trip so the
        # trip is attributable to the hazard that (most plausibly)
        # caused it — surfaced as khipu_watchdog_trips_total{kind=,
        # scenario=} beside the unlabeled-by-scenario base family.
        try:
            from khipu_tpu_torch.chaos.scenario import current_event_id

            scenario = current_event_id()
        except Exception:  # pragma: no cover - chaos layer optional
            scenario = None
        if scenario is not None:
            tags = dict(tags, scenario=scenario)
            key = (kind, scenario)
            self.scenario_trips[key] = self.scenario_trips.get(key, 0) + 1
        self.events.append((kind, tags))
        tr = self.tracer
        if tr is not None:
            tr.event(f"watchdog.{kind}", **tags)

    def check_once(self, now: Optional[float] = None) -> List[str]:
        """One detection pass; returns the kinds tripped THIS pass.
        ``now`` is injectable so tests drive time explicitly."""
        now = self._clock() if now is None else now
        tripped: List[str] = []
        gauges = self._gauges()
        for stage in _STAGES:
            depth = gauges.get(f"stage_{stage}_depth", 0) or 0
            busy = gauges.get(f"stage_{stage}_busy_s", 0.0)
            st = self._stage.setdefault(
                stage, {"busy": busy, "since": now, "tripped": False}
            )
            if depth <= 0 or busy != st["busy"]:
                # empty stage or visible progress: re-arm
                st["busy"] = busy
                st["since"] = now
                st["tripped"] = False
            elif (not st["tripped"]
                  and now - st["since"] >= self.config.stall_after_s):
                st["tripped"] = True
                self._trip(
                    "stage_stall", stage=stage, depth=depth,
                    stalled_s=round(now - st["since"], 3),
                )
                tripped.append("stage_stall")
        if self._journal_depth is not None:
            try:
                d = self._journal_depth()
            except Exception:
                d = 0
            if d > self.config.journal_runaway_depth:
                if not self._journal_over:
                    self._journal_over = True
                    self._trip("journal_runaway", depth=d)
                    tripped.append("journal_runaway")
            else:
                self._journal_over = False
        if self.telemetry is not None:
            dead = set(self.telemetry.dead_shards())
            for ep in sorted(dead - self._dead):
                self._trip("scrape_dead", endpoint=ep)
                tripped.append("scrape_dead")
            self._dead = dead
        if self._rebalance_src is not None:
            try:
                open_, prog = self._rebalance_src()
            except Exception:
                open_, prog = False, None
            st = self._reb
            newly_open = open_ and not st.get("open", False)
            st["open"] = open_
            if not open_ or newly_open or prog != st["prog"]:
                # closed transition, a transition that JUST opened
                # (the flat-progress clock starts now, not at the
                # last idle pass), or visible progress: re-arm
                st["prog"] = prog
                st["since"] = now
                st["tripped"] = False
            elif (not st["tripped"]
                  and now - st["since"] >= self.config.stall_after_s):
                st["tripped"] = True
                self._trip(
                    "rebalance_stuck", keys_streamed=prog,
                    stalled_s=round(now - st["since"], 3),
                )
                tripped.append("rebalance_stuck")
        if self._reorg_src is not None:
            try:
                count = self._reorg_src()
            except Exception:
                count = None
            if count is not None:
                st = self._rg
                win = getattr(self.config, "reorg_storm_window_s", 60.0)
                thresh = getattr(self.config, "reorg_storm_count", 3)
                st["samples"].append((now, count))
                while (len(st["samples"]) > 1
                       and now - st["samples"][0][0] > win):
                    st["samples"].popleft()
                rate = count - st["samples"][0][1]
                if rate >= thresh:
                    # edge-triggered: one trip per storm, re-armed
                    # when the windowed rate falls back under the
                    # threshold (competing miners settling down)
                    if not st["tripped"]:
                        st["tripped"] = True
                        self._trip(
                            "reorg_storm", reorgs=rate,
                            window_s=win,
                        )
                        tripped.append("reorg_storm")
                else:
                    st["tripped"] = False
        ceilings = getattr(self.config, "phase_share_ceilings", ()) or ()
        if ceilings:
            shares, total = self._phase_shares()
            min_total = getattr(
                self.config, "phase_share_min_total_s", 5.0
            )
            if total >= min_total:
                for phase, ceiling in ceilings:
                    share = shares.get(phase, 0.0)
                    if share > ceiling:
                        if not self._phase_over.get(phase):
                            self._phase_over[phase] = True
                            self._trip(
                                "phase_anomaly", phase=phase,
                                share=round(share, 4), ceiling=ceiling,
                            )
                            tripped.append("phase_anomaly")
                    else:
                        self._phase_over[phase] = False
        return tripped

    def _phase_sums(self) -> dict:
        """Raw cumulative {phase: wall seconds} from the phase latency
        histograms (canonical phases + seal/execute sub-phases)."""
        from khipu_tpu_torch.observability.recorder import (
            EXEC_SUBPHASES,
            LIFECYCLE_PHASES,
            PHASE_HISTOGRAMS,
            PHASE_STALL,
            SEAL_SUBPHASES,
        )

        return {
            p: PHASE_HISTOGRAMS[p].value["sum"]
            for p in (LIFECYCLE_PHASES + (PHASE_STALL,) + SEAL_SUBPHASES
                      + EXEC_SUBPHASES)
            if p in PHASE_HISTOGRAMS
        }

    def _phase_shares(self) -> tuple:
        """(shares, total canonical seconds) accrued SINCE THIS
        WATCHDOG was constructed, or an injected source — tests drive
        anomalies without running a replay.

        The histograms are process-cumulative; judging the process
        lifetime would let hours of healthy history mask a pipeline
        that just collapsed (or phase time from before attach trip a
        freshly started dog). The baseline snapshot taken at
        construction makes the shares a per-watchdog window."""
        if self._phase_share_src is not None:
            return self._phase_share_src()
        try:
            from khipu_tpu_torch.observability.recorder import (
                LIFECYCLE_PHASES,
                PHASE_STALL,
            )

            sums = self._phase_sums()
            base = self._phase_base
            delta = {
                p: max(0.0, s - base.get(p, 0.0))
                for p, s in sums.items()
            }
            total = sum(
                delta.get(p, 0.0)
                for p in LIFECYCLE_PHASES + (PHASE_STALL,)
            )
            if total <= 0:
                return {}, 0.0
            return (
                {p: d / total for p, d in delta.items() if d > 0},
                total,
            )
        except Exception:
            return {}, 0.0

    def attach_rebalance(
        self, source: Callable[[], tuple]
    ) -> None:
        """Hook a rebalance progress source — ``() -> (transition
        open, keys streamed)`` (Rebalancer.watch_source). Attachable
        after construction: the board builds the rebalancer lazily."""
        self._rebalance_src = source

    def attach_reorg(self, source: Callable[[], int]) -> None:
        """Hook a reorg-rate source — ``() -> cumulative switch
        count`` (ReorgManager.watch_source). ``reorg_storm`` trips
        when ``reorg_storm_count`` switches land within
        ``reorg_storm_window_s``; attachable after construction (the
        board builds regular sync lazily)."""
        self._reorg_src = source

    # ----------------------------------------------------------- thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.watchdog_interval):
                try:
                    self.check_once()
                except Exception:
                    # a broken gauge source must not kill the dog;
                    # InjectedDeath (BaseException) still propagates
                    pass

        self._thread = threading.Thread(
            target=loop, name="khipu-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # --------------------------------------------------------- registry

    def _registry_samples(self) -> list:
        out = [
            ("khipu_watchdog_trips_total", "counter", {"kind": k},
             self.trips.get(k, 0))
            for k in WATCHDOG_KINDS
        ]
        # scenario-attributed trips ride the same family with an extra
        # label; the per-kind base samples above keep their exact
        # shape so pre-gameday pins stay byte-stable
        for (kind, scenario), n in sorted(self.scenario_trips.items()):
            out.append((
                "khipu_watchdog_trips_total", "counter",
                {"kind": kind, "scenario": scenario}, n,
            ))
        return out
