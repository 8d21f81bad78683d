"""Per-method latency SLOs over the unified telemetry registry.

Dean & Barroso ("The Tail at Scale") is the design brief: the serving
SLO is p99 latency, not throughput — one slow request in a hundred is
what a user fans out into, so the plane must *measure* the tail
per method and *spend* an explicit error budget, not average it away.

This module owns the serving families in the unified registry:

* ``khipu_rpc_latency_seconds{method=}`` — histogram per RPC method,
  observed only for ADMITTED requests (a shed reply in ~50us would
  drag the percentile down exactly when the system is overloaded —
  the latency-collapse illusion this plane exists to prevent).
* ``khipu_rpc_requests_total{method=,outcome=}`` — ok / error / shed.
* ``khipu_rpc_shed_total{method=}`` — the -32005 reject count the
  bench smoke test pins to exactly one family in the exposition.

``SloTracker.evaluate()`` turns the histograms into p50/p99 estimates
(linear interpolation inside the owning bucket — the same estimate
Prometheus' ``histogram_quantile`` computes) against per-cost-class
targets, plus the error-budget readout ``khipu_metrics`` serves.

The port's copy of ``khipu_tpu.serving.slo``, on the port's registry.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from khipu_tpu_torch.observability.registry import REGISTRY, Histogram

# RPC-latency shaped buckets: sub-ms in-process calls through
# multi-second eth_getLogs scans
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

# default p99 targets (seconds) per admission cost class — the knee
# AIMD steers each class's concurrency around (admission.py reads
# these through SloPolicy)
DEFAULT_P99_TARGETS = {
    "cheap": 0.010,
    "read": 0.050,
    "execute": 0.250,
    "write": 0.050,
}


def quantile(hist_value: dict, q: float) -> float:
    """Estimate the q-quantile (0..1) from a cumulative-bucket
    histogram snapshot (``Histogram.value``), interpolating linearly
    within the owning bucket; observations beyond the last finite
    bound report that bound (the estimate is then a floor)."""
    total = hist_value["count"]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    last_le = 0.0
    for le, cum in hist_value["buckets"].items():
        last_le = le
        if cum >= rank:
            if le == float("inf"):
                # owning bucket is +Inf: no upper edge to interpolate
                # toward — floor at the last finite bound
                return prev_le
            span_n = cum - prev_cum
            frac = (rank - prev_cum) / span_n if span_n else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return last_le  # rank landed in +Inf: floor at the last bound


class SloPolicy:
    """Targets + objective. ``p99_targets`` maps cost class -> seconds;
    ``objective`` is the good-request fraction the error budget is
    spent against (bad = shed + internal error)."""

    def __init__(self, p99_targets: Optional[Dict[str, float]] = None,
                 objective: float = 0.999):
        self.p99_targets = dict(p99_targets or DEFAULT_P99_TARGETS)
        self.objective = objective

    def target_for(self, cost_class: str) -> float:
        return self.p99_targets.get(cost_class, 0.050)


class SloTracker:
    """Serving-side latency/outcome recorder + SLO evaluator.

    Instruments live in the (passed) registry keyed by
    (family, labels), so concurrent trackers over one registry share
    counts — the process has ONE truth per method, matching how the
    scraper reads it. ``observe`` is the RPC hot path: one dict probe
    + one histogram observe (registration only on first sight of a
    method)."""

    def __init__(self, policy: Optional[SloPolicy] = None,
                 classify=None, registry=REGISTRY):
        from khipu_tpu_torch.serving.admission import classify_method

        self.policy = policy or SloPolicy()
        self.registry = registry
        self._classify = classify or classify_method
        self._lock = threading.Lock()  # instrument-creation only
        self._hist: Dict[str, Histogram] = {}
        self._outcomes: Dict[tuple, object] = {}
        self._shed: Dict[str, object] = {}

    # ------------------------------------------------------------ record

    def _hist_for(self, method: str) -> Histogram:
        h = self._hist.get(method)
        if h is None:
            with self._lock:
                h = self._hist.get(method)
                if h is None:
                    h = self.registry.histogram(
                        "khipu_rpc_latency_seconds",
                        help="JSON-RPC latency of ADMITTED requests "
                             "(serving/slo.py)",
                        labels={"method": method},
                        buckets=LATENCY_BUCKETS,
                    )
                    self._hist[method] = h
        return h

    def _outcome_for(self, method: str, outcome: str):
        key = (method, outcome)
        c = self._outcomes.get(key)
        if c is None:
            with self._lock:
                c = self._outcomes.get(key)
                if c is None:
                    c = self.registry.counter(
                        "khipu_rpc_requests_total",
                        help="JSON-RPC requests by outcome "
                             "(ok|error|shed)",
                        labels={"method": method, "outcome": outcome},
                    )
                    self._outcomes[key] = c
        return c

    def _shed_for(self, method: str):
        c = self._shed.get(method)
        if c is None:
            with self._lock:
                c = self._shed.get(method)
                if c is None:
                    c = self.registry.counter(
                        "khipu_rpc_shed_total",
                        help="requests rejected -32005 by admission "
                             "control (serving/admission.py)",
                        labels={"method": method},
                    )
                    self._shed[method] = c
        return c

    def observe(self, method: str, seconds: float, outcome: str) -> None:
        """Record one finished request. ``outcome``: ``ok`` | ``error``
        (admitted — latency lands in the histogram) | ``shed``
        (rejected — counted, never timed)."""
        self._outcome_for(method, outcome).inc()
        if outcome == "shed":
            self._shed_for(method).inc()
        else:
            self._hist_for(method).observe(seconds)

    # ---------------------------------------------------------- evaluate

    def evaluate(self) -> dict:
        """Per-method p50/p99 vs target + the error-budget readout —
        the ``serving`` block of ``khipu_metrics``."""
        methods = {}
        total = bad = 0
        shed_by_method = {
            m: c.value for m, c in self._shed.items()
        }
        err_by_method: Dict[str, int] = {}
        for (m, outcome), c in self._outcomes.items():
            total += c.value
            if outcome in ("error", "shed"):
                bad += c.value
            if outcome == "error":
                err_by_method[m] = (
                    err_by_method.get(m, 0) + c.value
                )
        for m, h in self._hist.items():
            hv = h.value
            cls = self._classify(m)
            target = self.policy.target_for(cls)
            p99 = quantile(hv, 0.99)
            methods[m] = {
                "class": cls,
                "count": hv["count"],
                "p50Ms": round(quantile(hv, 0.50) * 1e3, 3),
                "p99Ms": round(p99 * 1e3, 3),
                "targetP99Ms": round(target * 1e3, 3),
                "withinSlo": p99 <= target,
                "shed": shed_by_method.get(m, 0),
                "errors": err_by_method.get(m, 0),
            }
        # a method every request of which was SHED has no histogram —
        # it must still show up (all-shed is the worst SLO state a
        # method can be in, not a reason to vanish from the readout)
        for m, shed in shed_by_method.items():
            if m in methods or shed <= 0:
                continue
            cls = self._classify(m)
            methods[m] = {
                "class": cls,
                "count": 0,
                "p50Ms": 0.0,
                "p99Ms": 0.0,
                "targetP99Ms": round(
                    self.policy.target_for(cls) * 1e3, 3
                ),
                "withinSlo": True,
                "shed": shed,
                "errors": err_by_method.get(m, 0),
            }
        objective = self.policy.objective
        bad_frac = bad / total if total else 0.0
        allowed = 1.0 - objective
        consumed = bad_frac / allowed if allowed > 0 else 0.0
        return {
            "methods": methods,
            "errorBudget": {
                "objective": objective,
                "requests": total,
                "bad": bad,
                "badFraction": round(bad_frac, 6),
                # >1.0 means the budget is blown (how far: 2.0 = spent
                # twice over); the readout stays unclamped so burn rate
                # is visible
                "budgetConsumed": round(consumed, 4),
                "budgetRemaining": round(max(0.0, 1.0 - consumed), 4),
            },
        }
