"""Minimal observability for the port: spans, gauges, a build log.

The port keeps the span and gauge call sites of the modules it ports,
but not the reference's full plane (tracing export, telemetry, the
movement ledger). This module is what those call sites need:

* ``span(name)`` — a timing context manager; a no-op until
  ``enable()`` is called, then it adds to ``SPAN_TOTALS[name]``
  (``[count, seconds]`` over every span since the last clear), under a
  lock: the replay driver and its sender-prefetch thread both time
  ``keccak.*`` spans.
* ``event(name, **tags)`` — a point event (a fired fault, a pipeline
  degrade, a scenario step): ``EVENT_COUNTS[name]`` counts it, always
  on; the tags are not kept (the full trace is ROADMAP A8).
* ``REGISTRY.gauge_group(name, defaults)`` — a get-or-create dict of
  counters; ``REGISTRY.inc(group, key)`` raises one under the
  registry's lock. ``REGISTRY.register_collector(name, fn)`` keeps one
  pull collector per name (a later one replaces it); ``collect()``
  returns every collector's ``(name, kind, labels, value)`` samples,
  leaving out a collector that raises.
  The port's registry is its own object, so nothing here can reset or
  share a gauge of the JAX package.
* ``compile_log`` — build and shape-cache events (hit / miss with
  seconds), written by ``ops/build.py`` and ``native/build.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Deque, Dict, List, Optional, Tuple

_ENABLED = [False]
SPAN_TOTALS: Dict[str, list] = {}
_SPAN_LOCK = threading.Lock()
EVENT_COUNTS: Dict[str, int] = {}


def enable(on: bool = True) -> None:
    _ENABLED[0] = bool(on)


@contextmanager
def span(name: str):
    if not _ENABLED[0]:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _SPAN_LOCK:
            total = SPAN_TOTALS.setdefault(name, [0, 0.0])
            total[0] += 1
            total[1] += dt


def event(name: str, **tags) -> None:
    """Count one point event by name (the tags are dropped)."""
    with _SPAN_LOCK:
        EVENT_COUNTS[name] = EVENT_COUNTS.get(name, 0) + 1


class _Registry:
    def __init__(self) -> None:
        self._groups: Dict[str, Dict[str, float]] = {}
        self._collectors: Dict[str, Callable[[], list]] = {}
        self._lock = threading.Lock()

    def register_collector(self, name: str, fn: Callable[[], list]) -> None:
        """Keep ``fn`` as the pull collector ``name`` (replacing any
        earlier one of that name)."""
        with self._lock:
            self._collectors[name] = fn

    def collect(self) -> List[tuple]:
        """Every registered collector's samples, in name order. A
        collector that raises (one over a stopped store's closed files)
        is left out of this scrape, as in the reference registry."""
        with self._lock:
            fns = [self._collectors[k] for k in sorted(self._collectors)]
        out: List[tuple] = []
        for fn in fns:
            try:
                out.extend(fn())
            except Exception:
                continue
        return out

    def gauge_group(self, name: str, defaults: Dict[str, float],
                    help: str = "") -> Dict[str, float]:
        """Get or create the group ``name``; an existing group keeps its
        values (a second import never resets a counter)."""
        with self._lock:
            group = self._groups.get(name)
            if group is None:
                group = self._groups[name] = dict(defaults)
            return group

    def inc(self, group: Dict[str, float], key: str, n: float = 1) -> None:
        """Add ``n`` to one counter of a group, under the registry's lock
        (several threads execute frames)."""
        with self._lock:
            group[key] += n


REGISTRY = _Registry()


class _CompileLog:
    def __init__(self) -> None:
        self.events: Deque[Tuple[str, str, Optional[float]]] = deque(
            maxlen=1024
        )

    def record(self, kind: str, label: str,
               seconds: Optional[float] = None) -> None:
        self.events.append((kind, label, seconds))


compile_log = _CompileLog()
