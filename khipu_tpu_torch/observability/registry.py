"""Unified telemetry registry: typed Counter/Gauge/Histogram + text
exposition.

The port's copy of ``khipu_tpu.observability.registry``, the same
classes and the same exposition bytes. Every gauge family of the port
(``PIPELINE_GAUGES`` in sync/replay.py, ``WINDOW_GAUGES`` in
ledger/window.py, ``MIRROR_GAUGES``, ``FUSED_GAUGES``, ``EXEC_GAUGES``,
the sender prefetcher's, the adaptive controller's, ``VM_GAUGES``) and
every pull collector (the journal's depth, the pool, the reorg manager,
kesque, fired faults) lives in one namespace with one snapshot and one
``prometheus_text()``. The port's registry is its own object: nothing
here can reset or share a gauge of the JAX package.

Two write disciplines coexist:

* INSTRUMENTS (Counter/Gauge/Histogram) are registered once and written
  on the hot path. A Gauge ``set`` is one attribute store, a Counter
  ``inc`` one int add. Histograms take a small lock (they update
  sum+count+bucket together); they sit on the span-record path, which
  only runs with tracing ON. A count raised from several threads at
  once takes its module's own lock (evm/dispatch.py).
* COLLECTORS are pull-time callbacks for state that already lives
  somewhere else (journal depth, fired faults, a store's segments).
  ``register_collector(key, fn)`` REPLACES by key — a fresh journal or
  engine (tests build hundreds) takes over its slot instead of leaking
  dead entries. ``fn`` returns samples ``(name, kind, labels_dict,
  value)``; a failing collector is dropped from that snapshot, never
  raises into the scraper.

``GaugeGroup`` is a dict-like view over registered gauges, so a
``PIPELINE_GAUGES["in_flight"] += 1`` call site reads as a dict write
while the values live in (and are served from) the registry.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "GaugeGroup",
    "MetricsRegistry",
    "REGISTRY",
    "render_exposition",
]

# latency-shaped default buckets (seconds), Prometheus convention:
# cumulative ``le`` upper bounds + implicit +Inf
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


class Counter:
    """Monotonic count. ``inc`` is one int add — GIL-atomic."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value. ``set`` is one attribute store."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0

    def set(self, v) -> None:
        self._value = v

    def inc(self, n=1) -> None:
        self._value += n

    def dec(self, n=1) -> None:
        self._value -= n

    @property
    def value(self):
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics).

    ``observe`` updates count+sum+bucket under a lock: unlike the
    single-word instrument writes those three must move together, and
    the path only runs with tracing enabled (the phase-latency feed from
    the recorder), so the lock costs nothing on the default path."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "_counts",
                 "_sum", "_count", "_lock", "_exemplars")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(
            buckets if buckets is not None else DEFAULT_BUCKETS
        ))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        # bucket index -> (exemplar_id, observed_value); last-wins per
        # bucket, populated only by callers that attach exemplars
        self._exemplars: Dict[int, tuple] = {}

    def set_buckets(self, buckets: Sequence[float]) -> bool:
        """Re-bin to an explicit bucket layout. Only legal while empty:
        observed samples cannot be re-binned without lying about them.
        Returns whether the override applied."""
        with self._lock:
            if self._count:
                return False
            self.buckets = tuple(sorted(buckets))
            self._counts = [0] * (len(self.buckets) + 1)
            self._exemplars = {}
            return True

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        """``exemplar`` (an opaque id — by convention a flight-recorder
        trace id) is remembered per bucket, last observation wins, and
        rides the text exposition as an OpenMetrics-style
        ``# {trace_id="..."} v`` suffix on that bucket's line."""
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = (exemplar, v)

    @property
    def value(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            ex = dict(self._exemplars)
        cum, out = 0, {}
        exemplars = {}
        for i, (b, c) in enumerate(zip(self.buckets, counts)):
            cum += c
            out[b] = cum
            if i in ex:
                exemplars[b] = ex[i]
        if len(self.buckets) in ex:
            exemplars["+Inf"] = ex[len(self.buckets)]
        val = {"count": total, "sum": round(s, 9), "buckets": out}
        if exemplars:
            # consumers that only read count/sum/buckets skip this key
            # untouched
            val["exemplars"] = exemplars
        return val


class GaugeGroup:
    """Dict-like facade over a family of registered gauges — the
    migration shim that lets ``PIPELINE_GAUGES["in_flight"] += 1`` keep
    working while the values live in the registry as
    ``<prefix>_<field>``."""

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 fields: Dict[str, object], help: str = ""):
        self._defaults = dict(fields)
        self._gauges = {
            k: registry.gauge(f"{prefix}_{k}", help=help)
            for k in fields
        }
        for k, v in fields.items():
            self._gauges[k].set(v)

    def __getitem__(self, key):
        return self._gauges[key].value

    def __setitem__(self, key, value) -> None:
        self._gauges[key].set(value)

    def __contains__(self, key) -> bool:
        return key in self._gauges

    def __iter__(self):
        return iter(self._gauges)

    def __len__(self) -> int:
        return len(self._gauges)

    def get(self, key, default=None):
        g = self._gauges.get(key)
        return default if g is None else g.value

    def keys(self):
        return self._gauges.keys()

    def values(self):
        return [g.value for g in self._gauges.values()]

    def items(self):
        return [(k, g.value) for k, g in self._gauges.items()]

    def reset(self) -> None:
        for k, v in self._defaults.items():
            self._gauges[k].set(v)


def _label_key(labels: Dict[str, str]) -> str:
    return ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )


def _escape(v: str) -> str:
    """Label-VALUE escaping (exposition format 0.0.4): backslash first,
    then double-quote and newline — the order that round-trips."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping: only backslash and newline (the format does
    NOT escape quotes in help text — they are legal verbatim)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def render_exposition(families) -> str:
    """Render ``{name: (kind, help, [(labels_dict, value)])}`` as
    Prometheus text exposition 0.0.4. Shared by ``prometheus_text()``
    and any merged exposition built from ``families()``, so both
    uphold the same invariant: each family appears EXACTLY once
    (one ``# TYPE`` line, then every labeled sample)."""
    lines: List[str] = []
    for name, (kind, help, samples) in sorted(families.items()):
        if help:
            lines.append(f"# HELP {name} {_escape_help(help)}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lk = _label_key(labels)
            if kind == "histogram" and isinstance(value, dict):
                exemplars = value.get("exemplars", {})
                for le, cum in value["buckets"].items():
                    blk = (lk + "," if lk else "") + f'le="{le}"'
                    line = f"{name}_bucket{{{blk}}} {cum}"
                    ex = exemplars.get(le)
                    if ex is not None:
                        # OpenMetrics exemplar: link the bucket to the
                        # flight-recorder trace that produced a sample
                        line += (f' # {{trace_id="{_escape(str(ex[0]))}"}}'
                                 f" {ex[1]}")
                    lines.append(line)
                binf = (lk + "," if lk else "") + 'le="+Inf"'
                line = f"{name}_bucket{{{binf}}} {value['count']}"
                ex = exemplars.get("+Inf")
                if ex is not None:
                    line += (f' # {{trace_id="{_escape(str(ex[0]))}"}}'
                             f" {ex[1]}")
                lines.append(line)
                suffix = f"{{{lk}}}" if lk else ""
                lines.append(f"{name}_sum{suffix} {value['sum']}")
                lines.append(f"{name}_count{suffix} {value['count']}")
            else:
                suffix = f"{{{lk}}}" if lk else ""
                lines.append(f"{name}{suffix} {value}")
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """One process-wide namespace of instruments + pull collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (name, label_key) -> instrument; families group by name
        self._instruments: Dict[Tuple[str, str], object] = {}
        self._collectors: Dict[str, Callable[[], list]] = {}
        # scrape-pass collector cache (per thread: scrapes are
        # re-entrant within one exposition call, concurrent across
        # RPC threads) — see scrape_pass()
        self._scrape = threading.local()
        # collector fn invocations, ever — the observable that pins the
        # one-pull-per-scrape contract (tests + capacity planning)
        self.collector_pulls = 0

    # ------------------------------------------------------- instruments

    def _register(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels or {}))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} "
                        f"(was {inst.kind})"
                    )
                # per-histogram bucket override on re-register: applies
                # only while the instrument is empty (set_buckets) —
                # samples already observed keep their binning
                buckets = kw.get("buckets")
                if (buckets is not None and isinstance(inst, Histogram)
                        and tuple(sorted(buckets)) != inst.buckets):
                    inst.set_buckets(buckets)
                return inst
            inst = cls(name, help=help, labels=labels, **kw)
            self._instruments[key] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """``buckets=None`` keeps DEFAULT_BUCKETS; an explicit layout
        overrides — including on re-register, while the histogram is
        still empty (latency-shaped defaults fit RPC phases but not,
        e.g., byte-count distributions)."""
        return self._register(
            Histogram, name, help, labels, buckets=buckets
        )

    def gauge_group(self, prefix: str, fields: Dict[str, object],
                    help: str = "") -> GaugeGroup:
        return GaugeGroup(self, prefix, fields, help=help)

    # -------------------------------------------------------- collectors

    def register_collector(self, key: str,
                           fn: Callable[[], list]) -> None:
        """Pull-time sample source; REPLACES any previous ``key`` (the
        newest owner of process-level state wins)."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    @contextmanager
    def scrape_pass(self):
        """One scrape: every pull collector runs AT MOST once inside
        this context, however many families/exports consult it —
        ``snapshot()`` and ``prometheus_text()`` each open one, and a
        caller combining both (snapshot + derived views) can wrap them in an outer pass to share the pull. The
        cache is thread-local: re-entrant on one thread, isolated
        across concurrent scraper threads (no torn shared cache)."""
        st = self._scrape
        depth = getattr(st, "depth", 0)
        if depth == 0:
            st.cache = None
        st.depth = depth + 1
        try:
            yield self
        finally:
            st.depth = depth
            if depth == 0:
                st.cache = None

    def _collected(self) -> List[Tuple[str, str, Dict[str, str], object]]:
        st = self._scrape
        if getattr(st, "depth", 0) > 0:
            cached = getattr(st, "cache", None)
            if cached is not None:
                return cached
        with self._lock:
            fns = list(self._collectors.values())
        out = []
        for fn in fns:
            self.collector_pulls += 1
            try:
                out.extend(fn())
            except Exception:
                continue  # a broken collector must not break the scrape
        if getattr(st, "depth", 0) > 0:
            st.cache = out
        return out

    # ---------------------------------------------------------- exports

    def _families(self):
        """Every sample grouped by family name:
        {name: (kind, help, [(labels_dict, value_or_histogram)])}."""
        with self._lock:
            instruments = list(self._instruments.values())
        fams: Dict[str, tuple] = {}
        for inst in instruments:
            kind, help, samples = fams.setdefault(
                inst.name, (inst.kind, inst.help, [])
            )
            samples.append((inst.labels, inst.value))
        for name, kind, labels, value in self._collected():
            k, h, samples = fams.setdefault(name, (kind, "", []))
            samples.append((dict(labels or {}), value))
        return fams

    def snapshot(self) -> dict:
        """{family: value} — unlabeled families flatten to their value,
        labeled ones map label-string -> value. One consistent pull, the
        source of truth a metrics surface serves from."""
        out = {}
        with self.scrape_pass():
            for name, (kind, _help, samples) in sorted(
                self._families().items()
            ):
                if len(samples) == 1 and not samples[0][0]:
                    out[name] = samples[0][1]
                else:
                    out[name] = {
                        (_label_key(lb) or "_"): v for lb, v in samples
                    }
        return out

    def families(self):
        """One consistent pull of every family:
        ``{name: (kind, help, [(labels_dict, value)])}`` — the shape
        ``render_exposition`` renders."""
        with self.scrape_pass():
            return self._families()

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4. Each family appears
        EXACTLY once (one ``# TYPE`` line, then every labeled sample) —
        the invariant the bench smoke test pins."""
        return render_exposition(self.families())


# THE process registry: instruments register here at module import;
# scrapes read from it.
REGISTRY = MetricsRegistry()
