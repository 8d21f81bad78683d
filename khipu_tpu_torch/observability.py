"""Minimal observability for the port: spans, gauges, a build log.

The port keeps the span and gauge call sites of the modules it ports,
but not the reference's full plane (tracing export, telemetry, the
movement ledger). This module is what those call sites need:

* ``span(name)`` — a timing context manager; a no-op until
  ``enable()`` is called, then it adds to ``SPAN_TOTALS[name]``
  (``[count, seconds]`` over every span since the last clear), under a
  lock: the replay driver and its sender-prefetch thread both time
  ``keccak.*`` spans.
* ``REGISTRY.gauge_group(name, defaults)`` — a get-or-create dict of
  counters; ``REGISTRY.inc(group, key)`` raises one under the
  registry's lock. The port's registry is its own object, so nothing
  here can reset or share a gauge of the JAX package.
* ``compile_log`` — build and shape-cache events (hit / miss with
  seconds), written by ``ops/build.py`` and ``native/build.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, Optional, Tuple

_ENABLED = [False]
SPAN_TOTALS: Dict[str, list] = {}
_SPAN_LOCK = threading.Lock()


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


class _Registry:
    def __init__(self) -> None:
        self._groups: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

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
