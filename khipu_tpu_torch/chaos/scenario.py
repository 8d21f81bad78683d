"""Deterministic gameday scenario engine (docs/gameday.md).

The port's copy of ``khipu_tpu.chaos.scenario``.

A *scenario* is a scripted hazard timeline composed from the existing
chaos seams — the same ``FaultRule`` machinery the single-hazard
sweeps use — plus hook events for hazards that are actions rather
than faults (a shard join, a fork battle). The load-bearing design
decision is that events are keyed to **progress milestones (block
heights), not wall-clock**: the driver calls ``engine.step(height)``
from its import loop, and an event fires the first time progress
reaches its ``at_height``. Two runs with the same seed therefore see
the same event schedule at the same points in the workload's life, no
matter how fast the host is — wall-clock timelines cannot compose
replayably, milestone timelines can.

Composition is ONE seed end to end: the scenario derives any stagger
or parameter jitter from ``derive(seed, salt, mod)`` (keccak-keyed,
the ``FaultPlan._rng`` convention), and seam events arm rules onto a
single shared ``FaultPlan`` via ``plan.extend`` — per-(rule, site) RNG
independence (chaos/plan.py) guarantees that arming hazard B cannot
shift hazard A's draws.

Watchdog correlation: every fire updates the module-level *current
event id* (``current_event_id()``), which ``Watchdog._trip`` stamps
onto ``khipu_watchdog_trips_total`` as a ``scenario`` label — a trip
during a gameday run is attributable to the hazard that preceded it.

Determinism contract, precisely: ``Scenario.schedule()`` — the
(event id, height, kind, site) list — is a pure function of the
scenario's construction inputs, and ``ScenarioEngine.step`` fires
events in schedule order. What a seam event's armed rule then *hits*
depends on workload progress, which the gameday drivers keep
deterministic by stepping from a single import loop.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from khipu_tpu_torch.chaos.plan import (
    FaultPlan,
    FaultRule,
    InjectedDeath,
    known_seam,
)
from khipu_tpu_torch.observability.trace import event as _trace_event

__all__ = [
    "SEAM_KINDS",
    "HOOK_KINDS",
    "ScenarioEvent",
    "Scenario",
    "ScenarioEngine",
    "derive",
    "current_event_id",
    "clear_current_event",
    "quiet_deaths",
]

# Event kinds that arm a FaultRule on the shared plan. ``die`` models
# a process death at the seam (collector stage, replica tail thread),
# ``raise`` a persistent/transient failure (a dead shard endpoint),
# ``latency``/``corrupt`` the slow-disk and bit-flip hazards.
SEAM_KINDS = ("die", "raise", "latency", "corrupt")

# Action events dispatched to engine hooks: not faults but the
# operational maneuvers the faults compose against.
HOOK_KINDS = ("join", "fork", "call")


def derive(seed: int, salt: str, mod: int) -> int:
    """Deterministic parameter derivation: keccak-keyed like
    ``FaultPlan._rng`` so every scenario knob is a pure function of
    (seed, salt) — no ambient RNG, no wall clock."""
    from khipu_tpu_torch.base.keccak import keccak256

    digest = keccak256(f"{seed}:{salt}".encode())
    return int.from_bytes(digest[:8], "big") % max(1, int(mod))


@dataclass(frozen=True)
class ScenarioEvent:
    """One timeline entry.

    ``kind`` in SEAM_KINDS arms ``FaultRule(site, kind, ...)`` on the
    shared plan when progress reaches ``at_height``; ``kind`` in
    HOOK_KINDS invokes the engine hook registered under that kind.
    ``params`` for seam kinds: ``after_hits`` (let N more hits of the
    site pass before the rule arms, default 0), ``times`` (fire budget,
    default 1; None = unlimited), ``prob``, ``latency_s``. For hook
    kinds ``params`` flows to the hook verbatim.
    """

    event_id: str
    at_height: int
    kind: str
    site: str = ""
    params: Mapping = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in SEAM_KINDS and self.kind not in HOOK_KINDS:
            raise ValueError(f"unknown scenario event kind {self.kind!r}")
        if self.kind in SEAM_KINDS:
            if not self.site:
                raise ValueError(f"{self.event_id}: seam event needs a site")
            if not known_seam(self.site):
                raise ValueError(
                    f"{self.event_id}: {self.site!r} is not a registered "
                    "chaos seam (chaos.plan.KNOWN_SEAMS)"
                )
        if self.at_height < 0:
            raise ValueError(f"{self.event_id}: negative at_height")

    def rule(self, armed_after: int) -> FaultRule:
        """The FaultRule this seam event arms, given the site's hit
        count at arm time."""
        p = self.params
        return FaultRule(
            site=self.site,
            kind=self.kind,
            prob=float(p.get("prob", 1.0)),
            after=armed_after + int(p.get("after_hits", 0)),
            times=p.get("times", 1),
            latency_s=float(p.get("latency_s", 0.01)),
        )


class Scenario:
    """An ordered, validated hazard timeline under one seed.

    Events fire in ``(at_height, insertion order)`` — the stable sort
    makes ``schedule()`` (the determinism pin) a pure function of the
    constructor arguments.
    """

    def __init__(self, seed: int, events: List[ScenarioEvent]):
        self.seed = int(seed)
        ids = [e.event_id for e in events]
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"duplicate scenario event ids: {dupes}")
        self.events: Tuple[ScenarioEvent, ...] = tuple(
            sorted(events, key=lambda e: e.at_height)
        )

    def schedule(self) -> List[Tuple[str, int, str, str]]:
        """The full (event_id, at_height, kind, site) timeline — what
        'same seed => identical event schedule' pins."""
        return [
            (e.event_id, e.at_height, e.kind, e.site)
            for e in self.events
        ]


# ----------------------------------------------------- current event id

# The most recent scenario event fired, for hazard attribution
# (sticky until the next fire or clear_current_event). A module global
# rather than a thread-local on purpose: the watchdog trips on ITS
# thread for hazards injected from the driver's thread.
_current_lock = threading.Lock()
_current_event: Optional[str] = None


def current_event_id() -> Optional[str]:
    with _current_lock:
        return _current_event


def clear_current_event() -> None:
    global _current_event
    with _current_lock:
        _current_event = None


def _set_current_event(event_id: str) -> None:
    global _current_event
    with _current_lock:
        _current_event = event_id


class ScenarioEngine:
    """Fires a Scenario against a live run.

    The driver calls ``step(height)`` at each progress milestone (the
    gameday bench steps between import windows); every event whose
    ``at_height`` has been reached fires exactly once, in schedule
    order. Seam events ``plan.extend`` a rule armed after the site's
    CURRENT hit count (plus the event's ``after_hits``), hook events
    call the registered hook with the event.
    """

    def __init__(self, scenario: Scenario, plan: FaultPlan,
                 hooks: Optional[Dict[str, Callable]] = None):
        self.scenario = scenario
        self.plan = plan
        self.hooks: Dict[str, Callable] = dict(hooks or {})
        self._pending: List[ScenarioEvent] = list(scenario.events)
        self._lock = threading.Lock()
        # (event_id, fired_at_height) in fire order
        self.fired: List[Tuple[str, int]] = []
        self.events_by_kind: Dict[str, int] = {}
        missing = sorted({
            e.kind for e in self._pending
            if e.kind in HOOK_KINDS and e.kind not in self.hooks
        })
        if missing:
            raise ValueError(f"no hook registered for kinds: {missing}")

    def step(self, height: int) -> List[ScenarioEvent]:
        """Fire every due event; returns them in fire order."""
        due: List[ScenarioEvent] = []
        with self._lock:
            while self._pending and self._pending[0].at_height <= height:
                due.append(self._pending.pop(0))
        for ev in due:
            _set_current_event(ev.event_id)
            with self._lock:
                self.fired.append((ev.event_id, height))
                self.events_by_kind[ev.kind] = (
                    self.events_by_kind.get(ev.kind, 0) + 1
                )
            _trace_event(
                f"scenario.{ev.kind}", id=ev.event_id,
                height=height, site=ev.site,
            )
            if ev.kind in SEAM_KINDS:
                self.plan.extend([ev.rule(self.plan.hits(ev.site))])
            else:
                self.hooks[ev.kind](ev)
        return due

    def done(self) -> bool:
        with self._lock:
            return not self._pending

    def remaining(self) -> int:
        with self._lock:
            return len(self._pending)


class quiet_deaths:
    """Context manager: while active, a thread dying of
    ``InjectedDeath`` does so silently (the SIGKILL model from
    chaos/plan.py — a killed process prints no traceback) instead of
    spamming stderr through ``threading.excepthook``. Any other
    exception still reaches the previous hook."""

    def __enter__(self):
        self._prev = threading.excepthook

        def hook(args, _prev=self._prev):
            if args.exc_type is InjectedDeath:
                return
            _prev(args)

        threading.excepthook = hook
        return self

    def __exit__(self, *exc):
        threading.excepthook = self._prev
        return False
