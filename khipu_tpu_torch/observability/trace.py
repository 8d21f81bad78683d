"""Flight-recorder span tracer: nestable spans into a lock-light ring.

The port's copy of ``khipu_tpu.observability.trace``. The windowed
pipeline (sync/replay.py) runs a block's commit across five threads —
the driver and the four stage threads (seal, collect, persist, save) —
so a stall surfaces only as a scalar gauge with no way to tell WHICH
phase of WHICH window caused it. This module is the Dapper-style answer
scoped to one process: every
lifecycle phase runs inside a ``span(name, block=n)`` context that
records wall time (perf_counter), thread CPU time (thread_time), the
owning thread, free-form tags, and an explicit parent link that works
ACROSS threads (the driver hands the collector its span token through
the job closure — thread-local nesting alone cannot express that
edge).

Cost model — the whole design point:

* DISABLED (the default): ``span(...)`` is one attribute load, one
  branch, and returns the shared inert ``_NULL_SPAN`` singleton whose
  ``__enter__``/``__exit__`` touch nothing. No allocation, no clock
  read, no shared-state write — behavior (roots, stores, RNG-free
  timings aside) is bit-exact identical to an uninstrumented build.
* ENABLED: ~4 clock reads + one deque append per span. No lock on the
  hot path: CPython's GIL makes ``deque.append`` (with ``maxlen`` —
  drop-oldest) and ``itertools.count.__next__`` atomic, which is the
  entire synchronization story ("lock-light"). Only ``snapshot()``
  pays for consistency, retrying the O(n) copy if a concurrent append
  mutates the deque mid-iteration.

Overflow drops the OLDEST record silently; ``tracer.dropped`` exposes
how many (exact whenever the writers are quiescent, off by at most the
in-flight appends otherwise). Records are Span objects; readers treat
them as immutable once ``t1`` is set.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "tracer",
    "span",
    "event",
    "current_token",
    "current_tracer",
    "use_tracer",
    "enable",
    "disable",
]


class Span:
    """One recorded phase: [t0, t1) wall interval on one thread.

    ``token`` (the span id) is what crosses threads: capture it on the
    producing thread, pass ``parent=token`` to the consuming thread's
    span and the recorder/exporter reconstruct the causal edge.
    """

    __slots__ = (
        "sid", "parent", "name", "tags", "tid", "thread_name",
        "t0", "t1", "tt0", "tt1", "error", "_tracer",
    )

    def __init__(self, tracer_: "Tracer", name: str,
                 parent: Optional[int], tags: Dict):
        self._tracer = tracer_
        self.name = name
        self.tags = tags
        self.sid = next(tracer_._ids)
        self.parent = parent  # None -> resolved from the stack on enter
        self.tid = 0
        self.thread_name = ""
        self.t0 = self.t1 = 0.0
        self.tt0 = self.tt1 = 0.0
        self.error = False

    # ----------------------------------------------------- context mgr

    def __enter__(self) -> "Span":
        t = self._tracer
        cur = threading.current_thread()
        self.tid = cur.ident or 0
        self.thread_name = cur.name
        if self.parent is None:
            stack = t._stack()
            if stack:
                self.parent = stack[-1].sid
        t._stack().append(self)
        self.tt0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter()
        self.tt1 = time.thread_time()
        if exc_type is not None:
            self.error = True
        t = self._tracer
        stack = t._stack()
        # pop OUR frame (tolerate a torn stack from generator misuse)
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        t._record(self)
        return False

    # ----------------------------------------------------------- sugar

    @property
    def token(self) -> int:
        """Opaque id to hand another thread as ``parent=``."""
        return self.sid

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def cpu(self) -> float:
        """Thread CPU seconds inside the span (blocked time excluded)."""
        return max(0.0, self.tt1 - self.tt0)

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<Span {self.name} #{self.sid} parent={self.parent} "
            f"{self.duration * 1e3:.2f}ms tags={self.tags}>"
        )


class _NullSpan:
    """The inert singleton every ``span()`` call returns while tracing
    is disabled: enter/exit/set_tag are no-ops, ``token`` is None, and
    no shared state is touched — the zero-cost-when-off guarantee."""

    __slots__ = ()
    token = None
    parent = None
    duration = 0.0
    cpu = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set_tag(self, key: str, value) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


def trace_sampled(trace_id: str, per_10k: int) -> bool:
    """THE fleet-wide sampling decision: deterministic in the trace id
    (``int(id, 16) % 10_000 < per_10k``), so the driver that mints the
    id and every shard that later receives it via ``khipu-sampled``
    metadata agree without coordination. Deliberately NOT Python
    ``hash()`` — string hashing is salted per process."""
    if per_10k >= 10_000:
        return True
    if per_10k <= 0:
        return False
    try:
        return int(trace_id, 16) % 10_000 < per_10k
    except ValueError:
        return True  # non-hex id (foreign client): keep


class Tracer:
    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        # head-based per-trace-id sampling: ``enabled`` (the one hot-
        # path check) is ``_on AND sampled``, where ``sampled`` is a
        # DETERMINISTIC function of the trace id — int(id, 16), never
        # Python hash() (PYTHONHASHSEED varies across processes) — so
        # every process that sees this trace id makes the SAME keep/drop
        # decision and a trace is whole or absent fleet-wide (the
        # ``khipu-sampled`` bridge metadata carries the decision to
        # shards that never see the id's ring). 10_000 = keep all.
        self.sample_per_10k = 10_000
        self.sampled = True
        self._on = False
        # process/ring identity for cross-process propagation: rides the
        # bridge as ``khipu-trace-id`` so a shard can link its server
        # spans back to the driver ring that issued the RPC
        self.trace_id = os.urandom(8).hex()
        self._buf: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._seq = itertools.count(1)  # appended-record counter
        self._last_seq = 0
        self._local = threading.local()
        # perf_counter <-> wall-clock anchor for absolute timestamps
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()

    # ---------------------------------------------------------- control

    def enable(self, capacity: Optional[int] = None) -> None:
        """(Re)start recording with an empty ring. Idempotent re-enable
        with the same capacity keeps the existing buffer."""
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            self._buf = deque(maxlen=capacity)
            self._seq = itertools.count(1)
            self._last_seq = 0
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()
        self._on = True
        self._recompute_sampled()
        _ensure_phase_observer()

    def disable(self) -> None:
        self._on = False
        self.enabled = False

    def set_sample_rate(self, per_10k: int) -> None:
        """Head-based sampling rate: keep ``per_10k`` in 10_000 traces
        (10_000 keeps everything — the default). Applies to the CURRENT
        trace id immediately and to every id after a reset()."""
        self.sample_per_10k = max(0, min(10_000, int(per_10k)))
        self._recompute_sampled()

    def _recompute_sampled(self) -> None:
        self.sampled = trace_sampled(self.trace_id, self.sample_per_10k)
        self.enabled = self._on and self.sampled

    def reset(self) -> None:
        """Drop every record and the drop counter; keep enabled state.
        A new ring gets a new trace id — remote spans linked to the old
        ring's tokens must not alias into the new one — and a fresh
        head-based sampling decision for it."""
        self.trace_id = os.urandom(8).hex()
        self._recompute_sampled()
        self._buf = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        self._last_seq = 0
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()

    # ------------------------------------------------------------ spans

    def span(self, name: str, parent: Optional[int] = None,
             **tags) -> "Span | _NullSpan":
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, parent, tags)

    def event(self, name: str, parent: Optional[int] = None,
              **tags) -> None:
        """Instant (zero-duration) record — compile events, failovers."""
        if not self.enabled:
            return
        s = Span(self, name, parent, tags)
        cur = threading.current_thread()
        s.tid = cur.ident or 0
        s.thread_name = cur.name
        if s.parent is None:
            stack = self._stack()
            if stack:
                s.parent = stack[-1].sid
        s.t0 = s.t1 = time.perf_counter()
        s.tt0 = s.tt1 = time.thread_time()
        self._record(s)

    def current_token(self) -> Optional[int]:
        """Span id of the innermost open span on THIS thread (None when
        disabled or outside any span) — the value to ship across a
        queue as ``parent=`` for a cross-thread child."""
        if not self.enabled:
            return None
        stack = getattr(self._local, "stack", None)
        return stack[-1].sid if stack else None

    # --------------------------------------------------------- plumbing

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, s: Span) -> None:
        # GIL-atomic append; maxlen makes it drop-oldest
        self._buf.append(s)
        self._last_seq = next(self._seq)
        obs = _PHASE_OBSERVER
        if obs is not None and s.t1 > s.t0:
            h = obs.get(s.name)
            if h is not None:
                # feed the registry's phase-latency histogram (installed
                # by observability/recorder.py) — one dict lookup on the
                # enabled path, nothing at all when tracing is off
                h.observe(s.t1 - s.t0)

    @property
    def dropped(self) -> int:
        """Records lost to ring overflow (drop-oldest)."""
        return max(0, self._last_seq - self.capacity)

    @property
    def recorded(self) -> int:
        return self._last_seq

    def snapshot(self) -> List[Span]:
        """Copy-consistent view of the ring, oldest first.

        Writers are lock-free, so two distinct tears are possible and
        both are handled: (a) the deque mutates MID-iteration — CPython
        raises RuntimeError and we retry; (b) an append lands BETWEEN a
        clean copy and the caller's read of ``recorded``/``dropped`` —
        the ring cursor (``_last_seq``) is read before and after the
        copy and the copy only counts when the fence did not move, so a
        snapshot can never disagree with the cursor state it is paired
        with. Under pathological write pressure degrade to the best
        fenced attempt rather than spinning forever."""
        copy: List[Span] = []
        for _ in range(64):
            fence = self._last_seq
            try:
                copy = list(self._buf)
            except RuntimeError:  # deque mutated during iteration
                continue
            if self._last_seq == fence:
                return copy
        return copy if copy else [s for s in tuple(self._buf)]

    def to_wall(self, t_perf: float) -> float:
        """Map a perf_counter stamp to absolute unix seconds."""
        return self.epoch_wall + (t_perf - self.epoch_perf)


# phase-name -> registry Histogram, installed by observability/recorder
# (set_phase_observer) the first time a tracer is enabled. ``None``
# until then — _record pays nothing extra before that.
_PHASE_OBSERVER: Optional[Dict] = None


def set_phase_observer(mapping: Optional[Dict]) -> None:
    global _PHASE_OBSERVER
    _PHASE_OBSERVER = mapping


def _ensure_phase_observer() -> None:
    """Importing the recorder installs the phase-latency histograms;
    deferred to first enable so the disabled path never imports it."""
    if _PHASE_OBSERVER is None:
        import khipu_tpu_torch.observability.recorder  # noqa: F401


# THE process tracer — the DEFAULT instance. Hot paths import the
# module functions below, which bind to the thread's CURRENT tracer
# (``use_tracer``) and fall back to this one; drivers/services that own
# a private ring (ReplayDriver) activate it for the extent of their
# work so module-level instrumentation seams (ledger/window.py,
# trie/fused.py, storage/device_mirror.py) record into the right ring without threading a tracer through every signature.
tracer = Tracer()

_current = threading.local()


def current_tracer() -> Tracer:
    """The tracer module-level seams record into ON THIS THREAD: the
    innermost ``use_tracer`` activation, else the process default."""
    t = getattr(_current, "tracer", None)
    return t if t is not None else tracer


@contextmanager
def use_tracer(t: Tracer):
    """Activate ``t`` as this thread's current tracer for the block.
    Re-entrant (activations nest/restore); other threads see their own
    activation or the default — a collector job must activate its
    driver's tracer itself (the token rides the job closure, and so
    does the tracer)."""
    prev = getattr(_current, "tracer", None)
    _current.tracer = t
    try:
        yield t
    finally:
        _current.tracer = prev


def span(name: str, parent: Optional[int] = None, **tags):
    """``with span("window.seal", block=n) as s: ...`` — the module-
    level entry the instrumentation seams use. Disabled: returns the
    shared inert singleton (no allocation; one thread-local load + two
    branches)."""
    t = getattr(_current, "tracer", None)
    if t is None:
        t = tracer
    if not t.enabled:
        return _NULL_SPAN
    return Span(t, name, parent, tags)


def event(name: str, parent: Optional[int] = None, **tags) -> None:
    current_tracer().event(name, parent, **tags)


def current_token() -> Optional[int]:
    return current_tracer().current_token()


def enable(capacity: Optional[int] = None) -> None:
    tracer.enable(capacity)


def disable() -> None:
    tracer.disable()


def apply_config(cfg, tracer_: Optional[Tracer] = None) -> None:
    """Wire an ObservabilityConfig (config.py): enable/disable the
    given tracer (default: the process instance), the movement ledger
    and the journey board. Idempotent — safe to call from every
    driver/service constructor. (The JAX package also sizes its fused
    compile cache here; the port compiles nothing per shape and has no
    such cache.)"""
    if cfg is None:
        return
    t = tracer_ if tracer_ is not None else tracer
    # a config carrying a NON-default sampling rate applies it; the
    # default (keep-all) leaves a manually set rate alone — same
    # no-stomp principle as enable below
    rate = getattr(cfg, "sample_per_10k", 10_000)
    if rate != 10_000 and rate != t.sample_per_10k:
        t.set_sample_rate(rate)
    if cfg.enabled and not t.enabled:
        t.enable(cfg.ring_capacity)
    elif not cfg.enabled and t.enabled:
        # an explicit disabled config does NOT stomp a manual enable()
        # (a caller may flip the tracer on over a default config)
        pass
    from khipu_tpu_torch.observability.journey import (
        apply_config as _apply_journey,
    )
    from khipu_tpu_torch.observability.profiler import (
        apply_config as _apply_ledger,
    )

    _apply_ledger(cfg)
    _apply_journey(cfg)


# ring health is telemetry too: recorded/dropped/enabled for the
# DEFAULT instance, in every scrape
from khipu_tpu_torch.observability.registry import (  # noqa: E402
    REGISTRY as _REGISTRY,
)

_REGISTRY.register_collector(
    "tracer",
    lambda: [
        ("khipu_trace_spans_recorded_total", "counter", {},
         tracer.recorded),
        ("khipu_trace_spans_dropped_total", "counter", {},
         tracer.dropped),
        ("khipu_trace_enabled", "gauge", {}, int(tracer.enabled)),
    ],
)
