"""Aggregate raw spans into the records operators actually ask for.

The port's copy of ``khipu_tpu.observability.recorder``, the same phase
names and the same aggregates. trace.py records flat spans; this module
turns a snapshot of them into

* per-block LIFECYCLE records — every phase a block passed through
  (announce -> import -> window.build -> window.seal [-> fused.dispatch]
  -> window.collect -> window.persist -> window.save), each with wall
  interval, thread
  and parent link, so ``lifecycle(spans, n)`` answers "where did block
  n spend its time" across the driver/collector boundary;
* a pipeline-occupancy TIMELINE — driver-busy vs collector-busy
  coverage per time bucket, whose aggregate agrees with the
  ``pipeline_occupancy`` gauge (sync/replay.py) by construction: both
  compute (collector_busy - driver_stall) / collector_busy;
* per-phase latency PERCENTILES (p50/p90/p99);
* the COMPILE-EVENT log — every kernel and host-library build lookup
  (hit / miss+compile seconds) that ops/build.py and native/build.py
  make. The JAX package logs its fused signature cache here; the port
  compiles nothing per shape and has no such cache, so its events are
  the builds. The log is always on: one append per build lookup is
  noise, and a rebuild is precisely the thing you need visible when
  tracing was off.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable, List, Sequence

from khipu_tpu_torch.observability.trace import Span, current_tracer, tracer

# canonical lifecycle phase names, in pipeline order. Instrumentation
# seams use EXACTLY these strings (plus dotted suffixes for sub-steps)
# so the recorder can group without a registry.
PHASE_ANNOUNCE = "announce"
PHASE_IMPORT = "import"
PHASE_BUILD = "window.build"
PHASE_SEAL = "window.seal"
# the off-driver seal stage: pack + dispatch build + upload run on the
# collector's front stage thread under this phase; the driver's
# window.seal is just the cheap DAG close-out + journal fsync
PHASE_PACK = "window.pack"
PHASE_DISPATCH = "fused.dispatch"
PHASE_COLLECT = "window.collect"
PHASE_PERSIST = "window.persist"
PHASE_SAVE = "window.save"
PHASE_STALL = "pipeline.stall"

# seal sub-phases: the monolithic window.seal span is split into named
# sub-steps so the seal wall decomposes instead of showing up as one
# opaque bar. Sub-phase spans are children of the
# canonical spans and NEVER count toward phase_breakdown (that would
# double-bill window.seal); they get their own latency histograms and
# the cost model joins them with the ledger's same-named sites.
SEAL_PACK = "seal.pack"
SEAL_ALIAS_GATHER = "seal.alias_gather"
SEAL_DISPATCH_BUILD = "seal.dispatch_build"
SEAL_UPLOAD = "seal.upload"
SEAL_ROOTCHECK = "seal.rootcheck"
SEAL_JOURNAL = "seal.journal"

SEAL_SUBPHASES = (
    SEAL_PACK, SEAL_ALIAS_GATHER, SEAL_DISPATCH_BUILD, SEAL_UPLOAD,
    SEAL_ROOTCHECK, SEAL_JOURNAL,
)

# execute sub-phases: the window.build span decomposes into
# the sender-recovery sweep (cache-fronted; the prefetch thread should
# have made it a no-op) and block execution proper. Same contract as
# the seal sub-phases: children of a canonical span, never in the
# phase_shares denominator, matched by name against the
# phase_share_ceilings watchdog ("senders"/"execute" entries).
PHASE_SENDERS = "senders"
PHASE_EXECUTE = "execute"

EXEC_SUBPHASES = (PHASE_SENDERS, PHASE_EXECUTE)

LIFECYCLE_PHASES = (
    PHASE_ANNOUNCE, PHASE_IMPORT, PHASE_BUILD, PHASE_SEAL,
    PHASE_PACK, PHASE_DISPATCH, PHASE_COLLECT, PHASE_PERSIST, PHASE_SAVE,
)
# phases a windowed-replay block must traverse for its record to be
# "complete" (announce/import appear only on the live-sync path;
# fused.dispatch only under device commit)
REQUIRED_PHASES = (PHASE_BUILD, PHASE_SEAL, PHASE_COLLECT, PHASE_PERSIST,
                   PHASE_SAVE)

DRIVER_PHASES = (PHASE_ANNOUNCE, PHASE_IMPORT, PHASE_BUILD, PHASE_SEAL,
                 PHASE_STALL)
# the four collector stage threads (sync/replay.py staged pipeline):
# pack+dispatch+upload, rootcheck+mirror-admit, host spill, block save
COLLECTOR_PHASES = (PHASE_PACK, PHASE_COLLECT, PHASE_PERSIST, PHASE_SAVE)


def spans_for_block(spans: Iterable[Span], number: int) -> List[Span]:
    """Spans tagged with block ``number`` — either exactly (``block=n``)
    or by window range (``block_lo <= n <= block_hi``)."""
    out = []
    for s in spans:
        tags = s.tags
        if tags.get("block") == number:
            out.append(s)
            continue
        lo = tags.get("block_lo")
        if lo is not None and lo <= number <= tags.get("block_hi", lo):
            out.append(s)
    return out


def _span_json(s: Span) -> dict:
    return {
        "span": s.sid,
        "parent": s.parent,
        "name": s.name,
        "thread": s.thread_name or s.tid,
        "start": round(s.t0 - tracer.epoch_perf, 6),
        "duration": round(s.duration, 6),
        "cpu": round(s.cpu, 6),
        "tags": {
            k: (v.hex() if isinstance(v, bytes) else v)
            for k, v in s.tags.items()
        },
        **({"error": True} if s.error else {}),
    }


def lifecycle(spans: Sequence[Span], number: int) -> dict:
    """The per-block record (export.trace_block): every
    lifecycle phase the block traversed, in phase order, with raw span
    intervals and cross-thread parent links intact."""
    mine = spans_for_block(spans, number)
    phases: Dict[str, List[dict]] = {}
    other: List[dict] = []
    for s in sorted(mine, key=lambda s: s.t0):
        if s.name in LIFECYCLE_PHASES:
            phases.setdefault(s.name, []).append(_span_json(s))
        else:
            other.append(_span_json(s))
    present = [p for p in LIFECYCLE_PHASES if p in phases]
    return {
        "number": number,
        "complete": all(p in phases for p in REQUIRED_PHASES),
        "phaseOrder": present,
        "phases": phases,
        "otherSpans": other,
        "threads": sorted(
            {s.thread_name or str(s.tid) for s in mine}
        ),
    }


def traced_blocks(spans: Sequence[Span]) -> List[int]:
    """Every block number any span is tagged with (sorted)."""
    nums = set()
    for s in spans:
        b = s.tags.get("block")
        if b is not None:
            nums.add(b)
        lo = s.tags.get("block_lo")
        if lo is not None:
            nums.update(range(lo, s.tags.get("block_hi", lo) + 1))
    return sorted(nums)


# ------------------------------------------------------------- latency


def phase_percentiles(spans: Sequence[Span]) -> Dict[str, dict]:
    """p50/p90/p99 wall latency per span name."""
    buckets: Dict[str, List[float]] = {}
    for s in spans:
        if s.t1 > s.t0:  # skip instant events
            buckets.setdefault(s.name, []).append(s.duration)

    def pct(sorted_vals: List[float], q: float) -> float:
        return sorted_vals[int(q * (len(sorted_vals) - 1))]

    out = {}
    for name, vals in sorted(buckets.items()):
        vals.sort()
        out[name] = {
            "count": len(vals),
            "total_s": round(sum(vals), 6),
            "p50_s": round(pct(vals, 0.50), 6),
            "p90_s": round(pct(vals, 0.90), 6),
            "p99_s": round(pct(vals, 0.99), 6),
        }
    return out


def phase_breakdown(spans: Sequence[Span]) -> Dict[str, float]:
    """Top-level wall seconds per canonical phase (driver + collector),
    the split a traced replay prints next to blocks/s. Only
    canonical-phase spans count — nested sub-spans (fused.dispatch
    inside window.pack, etc.) would double-bill their parents."""
    out: Dict[str, float] = {}
    for s in spans:
        if s.name in DRIVER_PHASES or s.name in COLLECTOR_PHASES:
            out[s.name] = out.get(s.name, 0.0) + s.duration
    return {k: round(v, 6) for k, v in out.items()}


def seal_subphase_breakdown(spans: Sequence[Span]) -> Dict[str, dict]:
    """Wall seconds + span count per seal sub-phase, over every
    ``seal.*`` span in the snapshot (both the driver-side seal steps
    and the collect-thread rootcheck/alias-gather)."""
    out: Dict[str, dict] = {}
    for s in spans:
        if s.name in SEAL_SUBPHASES:
            agg = out.setdefault(s.name, {"seconds": 0.0, "count": 0})
            agg["seconds"] += s.duration
            agg["count"] += 1
    return {
        k: {"seconds": round(v["seconds"], 6), "count": v["count"]}
        for k, v in sorted(out.items())
    }


def seal_decomposition(spans: Sequence[Span]) -> dict:
    """The seal-wall microscope's headline: how much of the seal-path
    wall time (driver ``window.seal`` close-out + off-driver
    ``window.pack`` stage) the sub-phase spans account for. Only
    sub-spans whose parent chain reaches window.seal or window.pack
    WITHOUT first passing through another canonical phase count as "in
    seal" — the collect-thread rootcheck (seal.rootcheck under
    window.collect) is a seal-path step but bills the collector's
    collect stage, not the seal bar.
    """
    by_id = {s.sid: s for s in spans}
    # fused.dispatch is NOT a stop: it nests inside window.pack (it is
    # excluded from phase_breakdown for exactly that reason), so
    # seal.dispatch_build/seal.upload under it still bill the seal bar
    canonical = set(DRIVER_PHASES) | set(COLLECTOR_PHASES)
    seal_like = (PHASE_SEAL, PHASE_PACK)
    seal_s = sum(s.duration for s in spans if s.name in seal_like)
    in_seal: Dict[str, float] = {}
    for s in spans:
        if s.name not in SEAL_SUBPHASES:
            continue
        p = by_id.get(s.parent) if s.parent is not None else None
        while p is not None:
            if p.name in canonical:
                if p.name in seal_like:
                    in_seal[s.name] = in_seal.get(s.name, 0.0) + s.duration
                break
            p = by_id.get(p.parent) if p.parent is not None else None
    sub_s = sum(in_seal.values())
    return {
        "seal_s": round(seal_s, 6),
        "subphase_in_seal_s": round(sub_s, 6),
        "cover": round(sub_s / seal_s, 4) if seal_s > 0 else 0.0,
        "in_seal": {k: round(v, 6) for k, v in sorted(in_seal.items())},
        "all": seal_subphase_breakdown(spans),
    }


# ----------------------------------------------------------- occupancy


def _merged_coverage(intervals: List[tuple], lo: float, hi: float) -> float:
    """Seconds of [lo, hi) covered by the union of intervals."""
    if hi <= lo:
        return 0.0
    cov = 0.0
    end = lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= end:
            continue
        cov += b - max(a, end)
        end = b
    return cov


def occupancy(spans: Sequence[Span]) -> float:
    """The gauge formula recomputed FROM SPANS: fraction of collector
    busy time not spent with the driver blocked on it. Agreement with
    ``PIPELINE_GAUGES['occupancy']`` within the log-call noise is the
    tracing-accuracy acceptance check."""
    busy = sum(s.duration for s in spans if s.name in COLLECTOR_PHASES)
    stall = sum(s.duration for s in spans if s.name == PHASE_STALL)
    if busy <= 0:
        return 0.0
    return max(0.0, min(1.0, (busy - stall) / busy))


def occupancy_timeline(
    spans: Sequence[Span], buckets: int = 60
) -> List[dict]:
    """Driver-busy / collector-busy coverage fraction per time bucket —
    the picture that shows WHEN the pipeline ran dry, not just that it
    averaged 0.7."""
    driver = [
        (s.t0, s.t1) for s in spans
        if s.name in DRIVER_PHASES and s.t1 > s.t0
    ]
    collector = [
        (s.t0, s.t1) for s in spans
        if s.name in COLLECTOR_PHASES and s.t1 > s.t0
    ]
    both = driver + collector
    if not both:
        return []
    t_lo = min(a for a, _ in both)
    t_hi = max(b for _, b in both)
    if t_hi <= t_lo:
        return []
    step = (t_hi - t_lo) / buckets
    out = []
    for i in range(buckets):
        lo = t_lo + i * step
        hi = lo + step
        d = _merged_coverage(driver, lo, hi) / step
        c = _merged_coverage(collector, lo, hi) / step
        out.append({
            "t": round(lo - tracer.epoch_perf, 6),
            "driver": round(d, 4),
            "collector": round(c, 4),
        })
    return out


# -------------------------------------------------------- window report


def window_report(number: int, spans: Sequence[Span] = ()) -> dict:
    """One window, broken into phase x bytes x site: the TransferLedger's
    movement record for the window containing block ``number``, merged
    with the span-derived phase wall seconds when a snapshot is given.
    The answer to "WHICH bytes crossed for this window, from which
    site, during which phase" (the JAX package serves it as the
    ``khipu_window_report(n)`` RPC, which waits for the port's serving
    plane).

    Returns ``{"found": False, ...}`` when the ledger has no window
    covering ``number`` (ledger disabled, or the window rotated out).
    """
    from khipu_tpu_torch.observability.profiler import LEDGER

    rep = LEDGER.window_report(number)
    if rep is None:
        return {
            "found": False,
            "number": number,
            "ledgerEnabled": LEDGER.enabled,
        }
    out = {"found": True, "number": number, **rep}
    if spans:
        lo, hi = rep["block_lo"], rep["block_hi"]
        window_spans = [
            s for s in spans
            if s.tags.get("block_lo") == lo and s.tags.get("block_hi") == hi
        ]
        if window_spans:
            out["phase_wall_seconds"] = phase_breakdown(window_spans)
            subs = seal_subphase_breakdown(window_spans)
            if subs:
                out["subphase_wall_seconds"] = {
                    k: v["seconds"] for k, v in subs.items()
                }
    return out


# ------------------------------------------------------ nesting checks


def nesting_violations(spans: Sequence[Span],
                       eps: float = 5e-4) -> List[str]:
    """Causality/nesting audit, used by tests and the acceptance gate:

    * same-thread child spans must lie INSIDE their parent's interval;
    * cross-thread children must START no earlier than their parent
      started (the collector's window.collect may outlive the driver's
      seal span — FIFO handoff only orders the starts).

    Returns human-readable violation strings (empty == correct).
    """
    by_id = {s.sid: s for s in spans}
    bad = []
    for s in spans:
        if s.parent is None:
            continue
        p = by_id.get(s.parent)
        if p is None:
            continue  # parent rotated out of the ring
        if s.tid == p.tid:
            if s.t0 < p.t0 - eps or s.t1 > p.t1 + eps:
                bad.append(
                    f"span {s.name}#{s.sid} escapes same-thread parent "
                    f"{p.name}#{p.sid}"
                )
        elif s.t0 < p.t0 - eps:
            bad.append(
                f"span {s.name}#{s.sid} starts before cross-thread "
                f"parent {p.name}#{p.sid}"
            )
    return bad


# -------------------------------------------------- compile-event log


class CompileEventLog:
    """Ring of build events + monotonic counters.

    ``record`` is called by ops/build.py and native/build.py (each under
    its build lock); the deque append is GIL-atomic for concurrent
    READERS. Mirrored into the current tracer as instant ``build``
    events when tracing is enabled, so a rebuild shows up inline on the
    perfetto timeline too."""

    def __init__(self, capacity: int = 1024):
        self._buf: deque = deque(maxlen=capacity)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def record(self, kind: str, key: str, seconds: float = 0.0) -> None:
        if kind == "hit":
            self.hits += 1
        elif kind == "miss":
            self.misses += 1
        elif kind == "evict":
            self.evictions += 1
        self._buf.append({
            "t": time.time(),
            "kind": kind,
            "signature": key,
            **({"compile_s": round(seconds, 3)} if seconds else {}),
        })
        current_tracer().event("build", kind=kind, signature=key)

    def snapshot(self) -> dict:
        for _ in range(8):
            try:
                events = list(self._buf)
                break
            except RuntimeError:
                continue
        else:
            events = []
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "events": events,
        }

    def reset(self) -> None:
        self._buf.clear()
        self.hits = self.misses = self.evictions = 0


# THE process compile log (ops/build.py and native/build.py write,
# export.py reads)
compile_log = CompileEventLog()


# ------------------------------------------- phase-latency histograms
#
# The recorder feeds the unified registry: one Prometheus histogram
# family (khipu_phase_latency_seconds{phase=...}) covering the
# canonical lifecycle phases. Installed as the tracer's phase observer
# so every recorded span of a canonical phase lands one ``observe`` —
# scrapers get cumulative latency distributions without holding a span
# ring snapshot.
try:
    from khipu_tpu_torch.observability import trace as _trace
    from khipu_tpu_torch.observability.registry import REGISTRY as _REGISTRY

    PHASE_HISTOGRAMS = {
        p: _REGISTRY.histogram(
            "khipu_phase_latency_seconds",
            help="wall seconds per canonical lifecycle phase",
            labels={"phase": p},
        )
        for p in (LIFECYCLE_PHASES + (PHASE_STALL,) + SEAL_SUBPHASES
                  + EXEC_SUBPHASES)
    }
    _trace.set_phase_observer(PHASE_HISTOGRAMS)

    def phase_shares() -> Dict[str, float]:
        """{phase: share of total phase wall time} from the cumulative
        latency histograms. The denominator is canonical phases only
        (sub-phases nest inside window.seal / window.collect — adding
        them would double-count the seal wall, and the execute
        sub-phases inside window.build likewise); sub-phase shares are
        still reported, as fractions of that same canonical total, so
        ``seal.upload`` or ``execute`` can be read directly against
        the ceiling."""
        canon = LIFECYCLE_PHASES + (PHASE_STALL,)
        sums = {
            p: PHASE_HISTOGRAMS[p].value["sum"]
            for p in canon + SEAL_SUBPHASES + EXEC_SUBPHASES
        }
        total = sum(sums[p] for p in canon)
        if total <= 0:
            return {}
        return {
            p: round(s / total, 6) for p, s in sums.items() if s > 0
        }

    def _phase_share_samples():
        return [
            ("khipu_phase_share", "gauge", {"phase": p}, v)
            for p, v in sorted(phase_shares().items())
        ]

    _REGISTRY.register_collector("phase_share", _phase_share_samples)
except Exception:  # pragma: no cover - stdlib-only deps
    PHASE_HISTOGRAMS = {}

    def phase_shares() -> Dict[str, float]:
        return {}
