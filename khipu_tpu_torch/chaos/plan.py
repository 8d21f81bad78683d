"""Deterministic, seeded fault injection behind zero-cost seams.

The port's copy of ``khipu_tpu.chaos.plan``, with ``KNOWN_SEAMS`` whole
(the JAX package's seams; the port places those of the modules it has).
``apply_config`` is not carried: no config of the port holds fault
rules (ROADMAP A6).

The retry/breaker machinery (cluster/client.py), the deep pipeline's
failure semantics (sync/replay.py) and the content-address admission
checks (bridge.py, cluster fetch) had only ever been exercised by
happy-path unit tests. This module provokes the failure modes ON
PURPOSE: hot paths call ``fault_point("site")`` / ``fault_value("site",
v)`` seams which, with no plan installed, cost one module attribute
load and one ``is None`` branch (the ``_NULL_SPAN`` cost model from
observability/trace.py — behavior is bit-exact identical to an
uninstrumented build). With a ``FaultPlan`` installed, rules matched
against the site fire deterministically: every random draw comes from
a per-(rule, site) RNG derived from ``(seed, rule index, site)`` and
is consumed in per-site hit order, so the same seed over the same
workload fires the same faults at the same hits, run after run.

Fault taxonomy (docs/recovery.md):

* ``raise``   — raise ``InjectedFault`` (an ``Exception``): transport
  errors, store failures. Exercises retries, breakers, failover and
  the pipeline's abort path.
* ``latency`` — sleep ``latency_s``: slow shards, slow disks.
  Exercises deadlines and backpressure.
* ``corrupt`` — flip ONE bit of the value passing through a
  ``fault_value`` seam: wire/disk corruption. Content-address
  verification MUST catch every one — a silent acceptance is a bug.
* ``die``     — raise ``InjectedDeath`` (a ``BaseException``, so
  ordinary ``except Exception`` recovery cannot swallow it): simulated
  process death mid-job. The window collector treats it as a SIGKILL —
  the thread stops silently, leaving partial state for recovery.

Every fired fault is recorded in the plan's ``fired`` log, the module
``fault_log`` ring (the ``chaos`` registry collector) and as a
``chaos.fault`` instant event in the current tracer's ring (when
tracing is on; ``observability.trace.event``).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import event as _trace_event

__all__ = [
    "InjectedFault",
    "InjectedDeath",
    "FaultRule",
    "FaultPlan",
    "FaultLog",
    "fault_log",
    "fault_point",
    "fault_value",
    "install",
    "uninstall",
    "active",
    "merge_plans",
    "KNOWN_SEAMS",
    "known_seam",
]

KINDS = ("raise", "latency", "corrupt", "die")

# Canonical registry of every fault seam in the tree — the chaos
# analog of the JAX package's profiler.KNOWN_SITES. A seam name ending
# in ``*`` is a prefix pattern for parameterised seams
# (``cluster.call:{endpoint}``).
# tests/test_torch_chaos.py's seam audit walks every ``fault_point`` /
# ``fault_value`` call in khipu_tpu_torch/ and fails if a seam is
# missing here OR exercised by no port test, so a new seam cannot
# silently ship unregistered or unexercised.
KNOWN_SEAMS = frozenset({
    # ledger / window collector stage boundaries (sync/replay.py,
    # ledger/window.py, ledger/batch_*.py)
    "ledger.batch",
    "collector.seal", "collector.pack", "collector.collect",
    "collector.persist", "collector.save", "collector.commit",
    "collector.spill",
    # storage datasources (storage/datasource.py)
    "storage.kv.get", "storage.kv.put",
    "storage.node.get", "storage.node.put",
    "storage.block.get", "storage.block.put",
    # log-structured store (storage/kesque.py, storage/segment.py,
    # sync/fast_sync.py)
    "kesque.append", "kesque.roll", "kesque.index",
    "kesque.compact", "kesque.ingest",
    # bridge RPC plane (bridge.py)
    "bridge.node.value", "bridge.segment.raw",
    "bridge.call.*", "bridge.serve.*",
    # reorg two-phase switch (sync/reorg.py)
    "reorg.intent", "reorg.rollback", "reorg.adopt", "reorg.finalize",
    # shard cluster (cluster/client.py, cluster/rebalance.py)
    "cluster.call:*", "cluster.fetch.value", "cluster.replicate",
    "rebalance.plan", "rebalance.stream", "rebalance.cutover",
    "rebalance.retire",
    # serving plane (serving/replica.py, serving/fleet.py)
    "replica.tail", "fleet.route",
    # fused device dispatch (trie/fused.py)
    "fused.dispatch", "fused.collect",
})


def known_seam(site: str) -> bool:
    """True when ``site`` is registered in ``KNOWN_SEAMS`` exactly or
    via a ``prefix*`` pattern."""
    if site in KNOWN_SEAMS:
        return True
    return any(
        p.endswith("*") and site.startswith(p[:-1]) for p in KNOWN_SEAMS
    )


class InjectedFault(Exception):
    """A deliberate failure from a ``raise`` rule. An ordinary
    Exception: retry/breaker/failover paths handle it like any
    transport or store error."""


class InjectedDeath(BaseException):
    """Simulated process death from a ``die`` rule. Deliberately NOT an
    Exception so generic recovery cannot catch it — the component that
    models the death (the collector thread) handles it explicitly; for
    everything else it propagates like a kill signal."""


@dataclass(frozen=True)
class FaultRule:
    """One injection rule. ``site`` matches a seam name exactly, or as
    a prefix when it ends with ``*`` (``"cluster.call:*"``). The rule
    arms after ``after`` hits of the site, fires with probability
    ``prob`` per hit, and at most ``times`` times total (None =
    unlimited)."""

    site: str
    kind: str  # raise | latency | corrupt | die
    prob: float = 1.0
    after: int = 0
    times: Optional[int] = None
    latency_s: float = 0.01

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


class FaultLog:
    """Bounded ring + counters of fired faults (the CompileEventLog
    shape from observability/recorder.py), surfaced by khipu_metrics
    whether or not the tracer ring is enabled."""

    def __init__(self, capacity: int = 4096):
        from collections import deque

        self._ring = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self.by_site: Dict[str, int] = {}

    def record(self, site: str, kind: str, hit: int, rule_index: int):
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.by_site[site] = self.by_site.get(site, 0) + 1
            self._ring.append(
                {"site": site, "kind": kind, "hit": hit,
                 "rule": rule_index}
            )
        _trace_event("chaos.fault", site=site, kind=kind, hit=hit)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fired": sum(self.counts.values()),
                "byKind": dict(self.counts),
                "bySite": dict(self.by_site),
            }

    def recent(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.counts = {k: 0 for k in KINDS}
            self.by_site = {}


fault_log = FaultLog()


def _fault_samples() -> list:
    """Registry collector: fired-fault counters as khipu_chaos_* —
    total unlabeled, per-kind and per-site labeled families."""
    snap = fault_log.snapshot()
    out = [("khipu_chaos_faults_fired_total", "counter", {},
            snap["fired"])]
    for kind, n in sorted(snap["byKind"].items()):
        out.append(("khipu_chaos_faults_by_kind_total", "counter",
                    {"kind": kind}, n))
    for site, n in sorted(snap["bySite"].items()):
        out.append(("khipu_chaos_faults_by_site_total", "counter",
                    {"site": site}, n))
    return out


REGISTRY.register_collector("chaos", _fault_samples)


class FaultPlan:
    """A seeded set of rules evaluated at every seam hit.

    Determinism contract: per-site hit counters advance on every hit;
    each (rule, site) pair draws from its OWN ``random.Random`` seeded
    from ``keccak256(f"{key_seed}:{key_index}:{site}")`` — independent
    of dict order, thread interleaving across DIFFERENT sites, and of
    any other rule. Replaying the same workload with the same seed
    fires the same (site, hit, kind) sequence.

    A rule's RNG key is ``(seed, position)`` as seen by the plan that
    ORIGINALLY carried the rule — ``merge_plans`` preserves the parts'
    keys, so a rule's draw stream never changes just because another
    plan's rules were concatenated in front of it (the aliasing bug
    that naive ``FaultPlan(seed, a.rules + b.rules)`` composition has).
    """

    def __init__(self, seed: int = 0, rules: Optional[List[FaultRule]] = None,
                 sleep=time.sleep):
        self.seed = int(seed)
        self.rules: Tuple[FaultRule, ...] = tuple(rules or ())
        self._sleep = sleep
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fire_counts: Dict[int, int] = {}
        self._rngs: Dict[Tuple[int, str], object] = {}
        # per-rule RNG key: (origin seed, origin position). Stable
        # across merge_plans/extend — THE per-(rule, site) independence
        # anchor.
        self._rule_keys: List[Tuple[int, int]] = [
            (self.seed, i) for i in range(len(self.rules))
        ]
        # next origin position for rules this plan mints itself
        self._next_own = len(self.rules)
        # every fired fault, in fire order: (site, hit, kind, rule idx)
        self.fired: List[Tuple[str, int, str, int]] = []

    # ----------------------------------------------------------- plumbing

    def _rng(self, rule_index: int, site: str):
        import random

        from khipu_tpu_torch.base.keccak import keccak256

        key = (rule_index, site)
        rng = self._rngs.get(key)
        if rng is None:
            kseed, kidx = self._rule_keys[rule_index]
            digest = keccak256(
                f"{kseed}:{kidx}:{site}".encode()
            )
            rng = self._rngs[key] = random.Random(
                int.from_bytes(digest[:8], "big")
            )
        return rng

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def extend(self, rules: List[FaultRule]) -> None:
        """Append rules at runtime (the scenario engine arms hazards at
        progress milestones this way). New rules key their RNG streams
        from this plan's own ``(seed, next position)`` sequence, so a
        plan built up by ``extend`` draws identically to one
        constructed with every rule up front."""
        rules = tuple(rules)
        with self._lock:
            for _ in rules:
                self._rule_keys.append((self.seed, self._next_own))
                self._next_own += 1
            self.rules = self.rules + rules

    # --------------------------------------------------------------- fire

    def fire(self, site: str, value: Optional[bytes] = None):
        """Evaluate every rule against one seam hit; returns ``value``
        (possibly corrupted). Raising kinds raise after the fire is
        logged, so the record survives the exception."""
        actions = []
        with self._lock:
            hit = self._hits[site] = self._hits.get(site, 0) + 1
            for i, rule in enumerate(self.rules):
                if not rule.matches(site):
                    continue
                if hit <= rule.after:
                    continue
                if (rule.times is not None
                        and self._fire_counts.get(i, 0) >= rule.times):
                    continue
                if rule.prob < 1.0:
                    # draw consumed in per-site hit order — the
                    # determinism invariant
                    if self._rng(i, site).random() >= rule.prob:
                        continue
                self._fire_counts[i] = self._fire_counts.get(i, 0) + 1
                self.fired.append((site, hit, rule.kind, i))
                actions.append((i, rule, hit))
        for i, rule, hit in actions:
            fault_log.record(site, rule.kind, hit, i)
            if rule.kind == "latency":
                self._sleep(rule.latency_s)
            elif rule.kind == "corrupt":
                if isinstance(value, (bytes, bytearray)) and len(value):
                    rng = self._rng(i, site)
                    flipped = bytearray(value)
                    pos = rng.randrange(len(flipped))
                    flipped[pos] ^= 1 << rng.randrange(8)
                    value = bytes(flipped)
            elif rule.kind == "raise":
                raise InjectedFault(
                    f"injected fault at {site} (hit {hit}, rule {i})"
                )
            else:  # die
                raise InjectedDeath(
                    f"injected death at {site} (hit {hit}, rule {i})"
                )
        return value


def merge_plans(*plans: FaultPlan, sleep=None) -> FaultPlan:
    """Compose plans into ONE installable plan whose injection
    schedule is the union of the parts'.

    Each rule keeps the RNG key ``(origin seed, origin position)`` it
    had in the plan it came from, so its per-site draw stream — and
    therefore every probabilistic fire decision — is bit-identical to
    what it would have been running its part alone over the same
    workload. Naive composition (``FaultPlan(seed, a.rules + b.rules)``)
    re-indexes b's rules and re-seeds them under a's seed, aliasing
    their streams onto different draws.

    Merge BEFORE installing: hit counters, fire counts and the
    ``fired`` log start fresh on the merged plan. The merged plan's
    own ``seed`` (used by later ``extend`` calls) is the first part's.
    """
    if not plans:
        return FaultPlan()
    merged = FaultPlan(
        seed=plans[0].seed, sleep=sleep or plans[0]._sleep
    )
    rules: List[FaultRule] = []
    keys: List[Tuple[int, int]] = []
    for p in plans:
        rules.extend(p.rules)
        keys.extend(p._rule_keys)
    merged.rules = tuple(rules)
    merged._rule_keys = keys
    merged._next_own = 1 + max(
        (idx for (s, idx) in keys if s == merged.seed), default=-1
    )
    return merged


# THE installed plan. ``None`` (the default) keeps both seams below at
# one attribute load + branch — the zero-cost-disabled contract.
_PLAN: Optional[FaultPlan] = None


def fault_point(site: str) -> None:
    """Control seam: may raise, sleep, or do nothing."""
    plan = _PLAN
    if plan is not None:
        plan.fire(site)


def fault_value(site: str, value):
    """Data seam: the value flows THROUGH the harness, which may
    corrupt it (or raise/sleep). Identity when no plan is installed."""
    plan = _PLAN
    if plan is None:
        return value
    return plan.fire(site, value)


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


@contextmanager
def active(plan: FaultPlan):
    """``with active(FaultPlan(seed=7, rules=[...])): ...`` — install
    for the block, always uninstall after (test hygiene)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()
