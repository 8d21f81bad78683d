"""Per-transaction lineage plane — the "tx passport".

The port's copy of ``khipu_tpu.observability.journey``: the same
edges, the same retention and sampling, stamped at the port's seams
(sync/replay.py, the ledger and its lanes, the pool, the journal and
the chain switch). The serving edges (``readview.publish``,
``replica.visible``) and the ``eth_sendRawTransaction`` ingress come
with the port's serving plane.

Every observability layer so far (flight recorder, transfer ledger,
cluster telemetry, seal microscope) watches the PIPELINE — phases,
windows, shards. This plane watches a TRANSACTION: a bounded event
record stamped at each lifecycle edge, keyed by tx hash, answering the
one question a production-node user actually asks: "where is my tx,
which lane executed it, when did it become durable, and when did every
replica see it?"

Edges (the passport's page order; a journey is the monotonically
ordered subset a tx actually crossed):

==================  ====================================================
edge                stamped at
==================  ====================================================
ingress             first sighting — eth_sendRawTransaction
                    (``source=rpc``, trace id attached) or the replay
                    driver's block loop (``source=import``)
pool.admit          TxPool.add accepted the tx (``replaced=True`` when
                    it outbid a pooled same-sender/nonce tx)
pool.evict          capacity eviction or replacement loss (PINNED —
                    a shed tx's journey must survive the ring)
pool.reject         underpriced replacement refused (PINNED)
schedule            plan_block's decision: ``batch`` id + predicted
                    ``lane`` (vector-transfer / vector-call / checked /
                    residue)
execute             the lane that ACTUALLY ran the tx — vector-transfer,
                    vector-call, checked, residue, or serial-fallback
                    (misprediction reruns stamp a second execute)
mispredict          a trusted/predicted lane escaped (PINNED)
seal                the tx's window was sealed into a collector job
journal.intent      the window's WAL intent fsynced (crash from here
                    replays forward)
durable             persist+save done, commit mark down — the
                    crash-survivable point (feeds the ``durable``
                    latency histogram)
journal.rollback    recovery rolled the tx's half-committed window
                    back out (PINNED — the truth a crash leaves behind)
reorg.retract       the tx's block was orphaned by a chain switch
                    (PINNED)
reorg.reinclude     the tx came back: ``via=mined`` (on the adopted
                    branch) or ``via=pool`` (recycled for re-mining)
readview.publish    the executed block's diff became visible to the
                    serving overlay (read-your-writes point)
replica.visible     a replica's tail caught up past the tx's block
                    (feeds the ``replica_visible`` latency histogram)
==================  ====================================================

Retention is tail-based: the ring holds ``capacity`` journeys evicted
oldest-first, but journeys that crossed a pinning edge (shed,
mispredicted, retracted, rolled back) or blew the slow-tail budget move
to a separate ``pinned_capacity`` ring and outlive the happy path.
Happy-path journeys are head-sampled deterministically in the tx hash
(``int % 10_000 < per_10k`` — never Python ``hash()``), so every
process tracks the same subset without coordination.

Cost model (the same contract as observability/trace.py):

* DISABLED (default): every seam is one attribute load + one branch
  (``if JOURNEY.enabled:`` guards the call, so not even the kwargs
  dict is built). No allocation, no clock read — replay is bit-exact
  identical to an uninstrumented build.
* ENABLED: one perf_counter read + one small-lock append per stamp.
  ``_lock`` is a LEAF lock (KL004): ``record`` never calls out while
  holding it — histogram observation happens after release.

``khipu_tx_commit_latency_seconds{edge=durable|replica_visible}``
histograms carry exemplar trace ids in the text exposition, linking a
latency bucket to the flight-recorder ring (chrome trace) that owns
the span timeline for that journey.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

from khipu_tpu_torch.observability.registry import REGISTRY

__all__ = [
    "Journey",
    "JourneyBoard",
    "JOURNEY",
    "use_node",
    "current_node",
    "apply_config",
    "journey_sampled",
]

# edges that pin a journey into the tail-retention ring
PIN_EDGES = {
    "pool.evict": "shed",
    "pool.reject": "shed",
    "mispredict": "mispredicted",
    "reorg.retract": "retracted",
    "journal.rollback": "rolled-back",
}

# edges kept even when a journey's event list is full: terminal /
# lifecycle-defining stamps are bounded in count per tx, so admitting
# them past ``max_events`` cannot unbound the record
_ALWAYS_KEEP = {
    "durable", "replica.visible", "reorg.retract", "reorg.reinclude",
    "journal.rollback", "mispredict", "pool.evict",
}


def journey_sampled(tx_hash: bytes, per_10k: int) -> bool:
    """Deterministic head-sampling in the tx hash — the same
    no-coordination story as trace_sampled (observability/trace.py):
    every process that sees this hash makes the same keep/drop call."""
    if per_10k >= 10_000:
        return True
    if per_10k <= 0:
        return False
    return int.from_bytes(tx_hash[:8], "big") % 10_000 < per_10k


class Journey:
    """One tx's ordered event record. Events are
    ``(t_perf, edge, node, trace_id, detail_dict_or_None)`` tuples,
    appended under the board lock in stamp order (perf_counter is
    process-monotonic, so list order IS time order)."""

    __slots__ = ("tx_hash", "events", "pin_reason", "ingress_t",
                 "truncated")

    def __init__(self, tx_hash: bytes):
        self.tx_hash = tx_hash
        self.events: List[tuple] = []
        self.pin_reason: Optional[str] = None
        self.ingress_t: Optional[float] = None
        self.truncated = 0


# which node's plane is stamping on THIS thread: "primary" by default,
# a replica driver activates ``use_node("replica:<name>")`` around its
# tail imports so re-execution events stay distinguishable on the
# shared process board
_node_local = threading.local()


def current_node() -> str:
    return getattr(_node_local, "node", "primary")


@contextmanager
def use_node(name: str):
    prev = getattr(_node_local, "node", None)
    _node_local.node = name
    try:
        yield
    finally:
        if prev is None:
            del _node_local.node
        else:
            _node_local.node = prev


class JourneyBoard:
    """Fixed-capacity ring of tx journeys with tail-based retention."""

    DEFAULT_CAPACITY = 4096
    DEFAULT_PINNED = 1024
    DEFAULT_MAX_EVENTS = 64
    DEFAULT_SLOW_MS = 250.0

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 pinned_capacity: int = DEFAULT_PINNED,
                 sample_per_10k: int = 10_000,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 slow_ms: float = DEFAULT_SLOW_MS):
        self.enabled = False
        self.capacity = capacity
        self.pinned_capacity = pinned_capacity
        self.sample_per_10k = sample_per_10k
        self.max_events = max_events
        self.slow_ms = slow_ms
        self._lock = threading.Lock()  # LEAF lock — never call out held
        self._ring: "OrderedDict[bytes, Journey]" = OrderedDict()
        self._pinned: "OrderedDict[bytes, Journey]" = OrderedDict()
        self.events_total = 0
        self.evicted_total = 0
        self.dropped_events_total = 0
        # perf_counter <-> wall anchor for absolute event timestamps
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        self._hist_durable = None
        self._hist_replica = None

    # ---------------------------------------------------------- control

    def enable(self, capacity: Optional[int] = None,
               pinned_capacity: Optional[int] = None,
               sample_per_10k: Optional[int] = None,
               max_events: Optional[int] = None,
               slow_ms: Optional[float] = None) -> None:
        """(Re)start with an empty board. Idempotent re-enable keeps
        the current journeys when no sizing changed."""
        resize = False
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            resize = True
        if (pinned_capacity is not None
                and pinned_capacity != self.pinned_capacity):
            self.pinned_capacity = pinned_capacity
            resize = True
        if sample_per_10k is not None:
            self.sample_per_10k = max(0, min(10_000, int(sample_per_10k)))
        if max_events is not None:
            self.max_events = max_events
        if slow_ms is not None:
            self.slow_ms = slow_ms
        if resize or not self.enabled:
            with self._lock:
                self._ring = OrderedDict()
                self._pinned = OrderedDict()
            self.epoch_perf = time.perf_counter()
            self.epoch_wall = time.time()
        self._ensure_histograms()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every journey and counter; keep enabled state."""
        with self._lock:
            self._ring = OrderedDict()
            self._pinned = OrderedDict()
        self.events_total = 0
        self.evicted_total = 0
        self.dropped_events_total = 0
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()

    def _ensure_histograms(self) -> None:
        """Register the commit-latency family lazily at first enable:
        a node that never serves journeys never carries the family."""
        if self._hist_durable is not None:
            return
        help_ = ("tx ingress-to-edge commit latency; exemplars "
                 "carry the owning flight-recorder trace id")
        self._hist_durable = REGISTRY.histogram(
            "khipu_tx_commit_latency_seconds", help=help_,
            labels={"edge": "durable"},
        )
        self._hist_replica = REGISTRY.histogram(
            "khipu_tx_commit_latency_seconds", help=help_,
            labels={"edge": "replica_visible"},
        )

    # ----------------------------------------------------------- stamps

    def record(self, tx_hash: bytes, edge: str,
               node: Optional[str] = None,
               trace_id: Optional[str] = None, **detail) -> None:
        """Stamp one lifecycle edge. Call sites MUST guard with
        ``if JOURNEY.enabled:`` — that guard, not this early return, is
        the zero-allocation-when-off contract (building ``detail``
        already allocates)."""
        if not self.enabled:
            return
        if node is None:
            node = current_node()
        if trace_id is None:
            # the owning flight-recorder ring, when one is live on this
            # thread — the exemplar link into the chrome trace
            from khipu_tpu_torch.observability.trace import current_tracer

            t = current_tracer()
            if t.enabled:
                trace_id = t.trace_id
        pin = PIN_EDGES.get(edge)
        observe = None  # (hist, dt, trace_id) observed AFTER the lock
        with self._lock:
            j = self._pinned.get(tx_hash)
            if j is None:
                j = self._ring.get(tx_hash)
            if j is None:
                # happy-path journeys are head-sampled; a pinning edge
                # starts a (partial) journey regardless — tail-based
                # retention must not lose a shed/retracted tx just
                # because the sampler skipped its happy path
                if pin is None and not journey_sampled(
                        tx_hash, self.sample_per_10k):
                    return
                j = Journey(tx_hash)
                self._ring[tx_hash] = j
                while len(self._ring) > self.capacity:
                    self._ring.popitem(last=False)
                    self.evicted_total += 1
            t_now = time.perf_counter()
            if edge == "ingress":
                if j.ingress_t is not None:
                    return  # first sighting wins (reorg re-imports)
                j.ingress_t = t_now
            if (len(j.events) >= self.max_events
                    and edge not in _ALWAYS_KEEP):
                j.truncated += 1
                self.dropped_events_total += 1
                return
            j.events.append(
                (t_now, edge, node, trace_id, detail or None)
            )
            self.events_total += 1
            if pin is not None and j.pin_reason is None:
                self._pin_locked(j, pin)
            if edge == "durable" and j.ingress_t is not None:
                dt = t_now - j.ingress_t
                if dt * 1000.0 > self.slow_ms and j.pin_reason is None:
                    self._pin_locked(j, "slow")
                observe = (self._hist_durable, dt, trace_id)
            elif edge == "replica.visible" and j.ingress_t is not None:
                observe = (self._hist_replica, t_now - j.ingress_t,
                           trace_id)
        if observe is not None and observe[0] is not None:
            hist, dt, tid = observe
            hist.observe(dt, exemplar=tid)

    def _pin_locked(self, j: Journey, reason: str) -> None:
        """Move a journey to the tail-retention ring (lock held)."""
        j.pin_reason = reason
        self._ring.pop(j.tx_hash, None)
        self._pinned[j.tx_hash] = j
        while len(self._pinned) > self.pinned_capacity:
            self._pinned.popitem(last=False)
            self.evicted_total += 1

    def pin(self, tx_hash: bytes, reason: str) -> None:
        """Explicit tail-retention pin (slow-tail callers)."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pinned.get(tx_hash) or self._ring.get(tx_hash)
            if j is not None and j.pin_reason is None:
                self._pin_locked(j, reason)

    # ------------------------------------------------------------ reads

    def get(self, tx_hash: bytes) -> Optional[Journey]:
        with self._lock:
            return self._pinned.get(tx_hash) or self._ring.get(tx_hash)

    def journeys(self) -> List[Journey]:
        """Every live journey, pinned first (a consistent copy)."""
        with self._lock:
            return list(self._pinned.values()) + list(self._ring.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring) + len(self._pinned)

    def to_wall(self, t_perf: float) -> float:
        return self.epoch_wall + (t_perf - self.epoch_perf)

    def export(self, tx_hash: bytes) -> Optional[dict]:
        """The ``khipu_tx_journey`` RPC shape: ordered events with
        monotonic perf timestamps, absolute wall times, node labels,
        and owning trace ids (the chrome-trace exemplar link)."""
        j = self.get(tx_hash)
        if j is None:
            return None
        with self._lock:
            events = list(j.events)
            pin_reason = j.pin_reason
            truncated = j.truncated
        out = []
        for t, edge, node, trace_id, detail in events:
            ev = {
                "edge": edge,
                "t": t,
                "wall": self.to_wall(t),
                "node": node,
                "traceId": trace_id,
            }
            if detail:
                ev.update(detail)
            out.append(ev)
        rec: Dict[str, object] = {
            "txHash": "0x" + tx_hash.hex(),
            "events": out,
            "pinned": pin_reason,
        }
        if truncated:
            rec["truncatedEvents"] = truncated
        return rec

    def latencies_ms(self, edge: str) -> List[float]:
        """ingress->edge latencies (ms) across live journeys — the
        bench's exact-quantile source (histograms quantize)."""
        out = []
        with self._lock:
            js = list(self._pinned.values()) + list(self._ring.values())
        for j in js:
            t0 = j.ingress_t
            if t0 is None:
                continue
            for t, e, _node, _tid, _d in j.events:
                if e == edge:
                    out.append((t - t0) * 1000.0)
                    break
        return out


# THE process board: every plane (primary driver, replicas, pool, RPC)
# stamps into one board keyed by tx hash, so a journey shows the tx
# crossing nodes — events carry the stamping node's label.
JOURNEY = JourneyBoard()


def apply_config(cfg) -> None:
    """Wire an ObservabilityConfig's journey_* knobs. Idempotent; an
    explicit disabled config does NOT stomp a manual enable() (a caller
    may flip the board on over a default config)."""
    if cfg is None:
        return
    if getattr(cfg, "journey_enabled", False) and not JOURNEY.enabled:
        JOURNEY.enable(
            capacity=getattr(cfg, "journey_capacity", None),
            pinned_capacity=getattr(cfg, "journey_pinned_capacity", None),
            sample_per_10k=getattr(cfg, "journey_sample_per_10k", None),
            max_events=getattr(cfg, "journey_max_events", None),
            slow_ms=getattr(cfg, "journey_slow_ms", None),
        )


# board health is telemetry too — registered at import like the trace
# ring's collector; all-zero while disabled, never a runtime cost
def _journey_samples() -> list:
    with JOURNEY._lock:
        tracked = len(JOURNEY._ring)
        pinned = len(JOURNEY._pinned)
    return [
        ("khipu_tx_journey_enabled", "gauge", {},
         int(JOURNEY.enabled)),
        ("khipu_tx_journeys_tracked", "gauge", {}, tracked),
        ("khipu_tx_journeys_pinned", "gauge", {}, pinned),
        ("khipu_tx_journey_events_total", "counter", {},
         JOURNEY.events_total),
        ("khipu_tx_journeys_evicted_total", "counter", {},
         JOURNEY.evicted_total),
    ]


REGISTRY.register_collector("tx_journey", _journey_samples)
