"""Data-movement ledger: per-site host<->device transfer accounting.

The port's copy of ``khipu_tpu.observability.profiler``. Every crossing
of the port's host/card boundary — K1r's pinned upload and copy back
(ops/keccak.py), the window's pack upload and K5 launch, the root-check
fetch and the digest copy back (trie/fused.py), the mirror's tile
installs and read-backs (storage/device_mirror.py) — records
``(site, direction, bytes, duration, window, phase)`` into a bounded
ring, and the totals feed three surfaces: the registry families
``khipu_device_transfer_{bytes,seconds}_total{site,direction}``, the
chrome-trace counter tracks rendered by observability/export.py, and
the per-window phase x bytes x site breakdown (``window_report``).

A site records the bytes the port really moves. Where the JAX package
pads rows to 1024-row tiles or power-of-two counts, the port sends its
real rows (plus one filler row a rate class), so device bytes differ
between the packages at those sites (tests/test_torch_observability.py
lists them).

Cost model — same contract as the trace ring (trace.py):

* DISABLED (the default): ``LEDGER.transfer(...)`` is one attribute
  load + branch returning the shared inert ``_NULL_TRANSFER``; the
  caller's ``nbytes`` arithmetic is host-integer only
  (``numel() * element_size()`` or numpy ``.nbytes`` — never a
  ``.item()``, ``.cpu()`` or synchronize), so replay behavior stays
  bit-exact with zero extra device round-trips.
* ENABLED: two clock reads + one deque append per crossing, plus two
  GIL-atomic counter adds (lazily-registered per (site, direction)
  instrument pair). No lock on the hot path; only ``events()`` pays
  for consistency with the same fenced-retry copy the tracer uses. A
  crossing around an asynchronous launch or a ``non_blocking`` copy
  times the enqueue, as the spans around it do.

Directions: ``h2d``/``d2h`` are REAL device crossings and feed the
``khipu_device_transfer_*`` families. ``host`` marks host-side
persistence traffic (window.store node writes, block saves) that the
window report needs to classify collect-phase work — it lands in the
ring and the report but is kept OUT of the device families so those
stay an honest measure of the boundary.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from khipu_tpu_torch.observability.registry import REGISTRY

__all__ = [
    "H2D",
    "D2H",
    "HOST",
    "TransferEvent",
    "TransferLedger",
    "LEDGER",
    "COLLECT_CLASSES",
    "KNOWN_SITES",
]

H2D = "h2d"  # host -> device upload
D2H = "d2h"  # device -> host download
HOST = "host"  # host-side persistence traffic (classification only)

# every site string the port meters: the registry khipu-lint's KL001
# (khipu_tpu_torch/analysis) checks each literal ``LEDGER.transfer`` /
# ``LEDGER.record`` site against (a misspelled site forks its own
# series in khipu_device_transfer_* and drops out of its COLLECT_CLASSES
# stream). The JAX package's set, cut to the sites the port calls.
# Adding an instrumentation seam means adding its site here.
KNOWN_SITES = frozenset({
    # fused fixpoint (trie/fused.py)
    "fused.collect",
    # the adaptive commit's one-shot calibration upload (sync/adaptive.py)
    "adaptive.probe",
    # device-resident node mirror (storage/device_mirror.py)
    "mirror.init", "mirror.claim", "mirror.admit",
    "mirror.admit_window", "mirror.get", "mirror.verify", "mirror.spill",
    # window commit + block persistence (ledger/window.py, sync/replay.py)
    "window.store", "block.save",
    # the seal sub-phases, named as their spans
    "seal.pack", "seal.alias_gather", "seal.dispatch_build",
    "seal.upload", "seal.rootcheck", "seal.journal",
    # execute stage: the vectorized batches, the per-tx residue, K6
    "exec.batch", "exec.residue", "exec.batch_device",
    # multi-card paths (parallel/)
    "shard.dispatch", "shard.gather", "shard.keccak", "shard.verify",
    # batched Keccak (ops/keccak.py)
    "ops.keccak",
    # the kesque engine: window spills, snapshot ingest, compaction,
    # the rebalance's segment ship
    "kesque.append", "kesque.ingest", "kesque.compact", "kesque.ship",
})

# which logical stream a collect-phase byte belongs to — the breakdown
# window_report serves so "collect is slow" decomposes into hauling
# digests back (placeholder-resolution) vs writing the node store vs
# saving blocks
COLLECT_CLASSES = {
    "fused.collect": "placeholder-resolution",
    "fused.rootcheck": "placeholder-resolution",
    "seal.rootcheck": "placeholder-resolution",
    "mirror.get": "placeholder-resolution",
    "shard.gather": "placeholder-resolution",
    "mirror.admit_window": "mirror-admit",
    "seal.alias_gather": "mirror-admit",
    "mirror.spill": "store-write",
    "window.store": "store-write",
    "kesque.append": "store-write",
    "block.save": "block-save",
}


class TransferEvent:
    """One recorded crossing. Readers treat instances as immutable."""

    __slots__ = ("site", "direction", "nbytes", "duration", "window",
                 "phase", "t0")

    def __init__(self, site: str, direction: str, nbytes: int,
                 duration: float, window: int, phase: str, t0: float):
        self.site = site
        self.direction = direction
        self.nbytes = nbytes
        self.duration = duration
        self.window = window
        self.phase = phase
        self.t0 = t0  # perf_counter stamp (tracer.to_wall maps it)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<Transfer {self.site} {self.direction} {self.nbytes}B "
            f"{self.duration * 1e3:.2f}ms w={self.window} "
            f"phase={self.phase}>"
        )


class _NullTransfer:
    """Inert singleton returned while the ledger is disabled — the
    ``_NULL_SPAN`` pattern: enter/exit touch nothing, no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullTransfer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_TRANSFER = _NullTransfer()


class _Transfer:
    """Timing context for one crossing: wraps the actual device call so
    ``duration`` includes the transfer (and, for async dispatch, the
    enqueue — the same boundary the spans around it measure)."""

    __slots__ = ("_ledger", "site", "direction", "nbytes", "t0")

    def __init__(self, ledger: "TransferLedger", site: str,
                 direction: str, nbytes: int):
        self._ledger = ledger
        self.site = site
        self.direction = direction
        self.nbytes = nbytes
        self.t0 = 0.0

    def __enter__(self) -> "_Transfer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._ledger._commit(
                self.site, self.direction, self.nbytes,
                time.perf_counter() - self.t0, self.t0,
            )
        return False


class TransferLedger:
    DEFAULT_CAPACITY = 65536

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False  # plain attribute — the hot-path check
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self._last_seq = 0
        self._local = threading.local()  # per-thread window/phase ctx
        # sealed-window ranges, newest last: (window_id, lo, hi) — how
        # window_report(n) resolves a block number to its window
        self._windows: deque = deque(maxlen=1024)
        # (site, direction) -> (bytes Counter, seconds Counter); built
        # lazily so disabled processes register no families at all
        self._counters: Dict[Tuple[str, str], tuple] = {}
        self._counter_lock = threading.Lock()
        self.blocks = 0  # blocks committed while enabled (per-block rates)

    # ---------------------------------------------------------- control

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            self._buf = deque(maxlen=capacity)
            self._seq = itertools.count(1)
            self._last_seq = 0
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every event, window range, and the per-block counter;
        keep enabled state and the registered counter instruments
        (registry counters are monotonic by contract)."""
        self._buf = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        self._last_seq = 0
        self._windows.clear()
        self.blocks = 0

    # --------------------------------------------------------- hot path

    def transfer(self, site: str, direction: str, nbytes: int):
        """``with LEDGER.transfer("fused.collect", D2H, arr.nbytes): ...``
        around the device call. Disabled: the shared inert singleton."""
        if not self.enabled:
            return _NULL_TRANSFER
        return _Transfer(self, site, direction, int(nbytes))

    def record(self, site: str, direction: str, nbytes: int,
               duration: float = 0.0) -> None:
        """One-shot record for crossings whose timing is already known
        (or host-side classification events)."""
        if not self.enabled:
            return
        self._commit(site, direction, int(nbytes), duration,
                     time.perf_counter() - duration)

    def _commit(self, site: str, direction: str, nbytes: int,
                duration: float, t0: float) -> None:
        ctx = self._local
        ev = TransferEvent(
            site, direction, nbytes, duration,
            getattr(ctx, "window", -1), getattr(ctx, "phase", ""), t0,
        )
        self._buf.append(ev)  # GIL-atomic, drop-oldest
        self._last_seq = next(self._seq)
        if direction != HOST:
            pair = self._counters.get((site, direction))
            if pair is None:
                pair = self._register_pair(site, direction)
            pair[0].inc(nbytes)
            pair[1].inc(duration)

    def _register_pair(self, site: str, direction: str) -> tuple:
        with self._counter_lock:
            pair = self._counters.get((site, direction))
            if pair is None:
                labels = {"site": site, "direction": direction}
                pair = (
                    REGISTRY.counter(
                        "khipu_device_transfer_bytes_total",
                        help="bytes crossed per (site, direction) "
                        "(observability/profiler.py)",
                        labels=labels,
                    ),
                    REGISTRY.counter(
                        "khipu_device_transfer_seconds_total",
                        help="seconds spent crossing per (site, "
                        "direction) (observability/profiler.py)",
                        labels=labels,
                    ),
                )
                self._counters[(site, direction)] = pair
        return pair

    # ---------------------------------------------------- window context

    @contextmanager
    def context(self, window: Optional[int] = None,
                phase: Optional[str] = None):
        """Tag crossings on THIS thread with a window id / phase for
        the extent of the block (the driver tags seal-side work, the
        collector job tags collect/persist — the ctx rides the closure
        exactly like the tracer does). Nests and restores."""
        ctx = self._local
        prev_w = getattr(ctx, "window", -1)
        prev_p = getattr(ctx, "phase", "")
        if window is not None:
            ctx.window = window
        if phase is not None:
            ctx.phase = phase
        try:
            yield self
        finally:
            ctx.window = prev_w
            ctx.phase = prev_p

    def note_window(self, window: int, lo: int, hi: int) -> None:
        """Register a sealed window's block range so window_report can
        resolve any block number inside it."""
        if self.enabled:
            self._windows.append((window, lo, hi))

    def note_blocks(self, n: int) -> None:
        """Blocks committed while enabled — the denominator of the
        derived bytes-per-block gauges."""
        if self.enabled:
            self.blocks += n

    # ----------------------------------------------------------- readout

    @property
    def recorded(self) -> int:
        return self._last_seq

    @property
    def dropped(self) -> int:
        return max(0, self._last_seq - self.capacity)

    def events(self) -> List[TransferEvent]:
        """Fenced copy of the ring, oldest first (trace.py snapshot
        discipline: retry on mid-iteration mutation or a moved cursor,
        degrade to the best attempt under pathological pressure)."""
        copy: List[TransferEvent] = []
        for _ in range(64):
            fence = self._last_seq
            try:
                copy = list(self._buf)
            except RuntimeError:
                continue
            if self._last_seq == fence:
                return copy
        return copy if copy else list(tuple(self._buf))

    def totals(self, events: Optional[List[TransferEvent]] = None,
               include_host: bool = False) -> Dict[Tuple[str, str], dict]:
        """{(site, direction): {bytes, seconds, count}} over the ring
        (or a pre-taken snapshot)."""
        out: Dict[Tuple[str, str], dict] = {}
        for ev in events if events is not None else self.events():
            if ev.direction == HOST and not include_host:
                continue
            agg = out.setdefault(
                (ev.site, ev.direction),
                {"bytes": 0, "seconds": 0.0, "count": 0},
            )
            agg["bytes"] += ev.nbytes
            agg["seconds"] += ev.duration
            agg["count"] += 1
        return out

    def direction_totals(self) -> Dict[str, int]:
        """{direction: bytes} for the device directions."""
        out = {H2D: 0, D2H: 0}
        for (_site, direction), agg in self.totals().items():
            out[direction] = out.get(direction, 0) + agg["bytes"]
        return out

    def window_range(self, n: int) -> Optional[Tuple[int, int, int]]:
        """The (window_id, lo, hi) whose [lo, hi] contains block n —
        newest match wins (an epoch re-replay reuses block numbers)."""
        for window, lo, hi in reversed(self._windows):
            if lo <= n <= hi:
                return (window, lo, hi)
        return None

    def window_report(self, n: int) -> Optional[dict]:
        """Movement breakdown for the window containing block ``n``:
        phase x site x {bytes, seconds, count}, direction totals, and
        the collect-traffic classification. None when no sealed window
        covers ``n`` (not replayed while enabled, or aged out)."""
        rng = self.window_range(n)
        if rng is None:
            return None
        window, lo, hi = rng
        phases: Dict[str, dict] = {}
        subphases: Dict[str, dict] = {}
        directions: Dict[str, int] = {}
        classes: Dict[str, dict] = {}

        def _acc(bucket: Dict[str, dict], key: str, ev) -> None:
            ph = bucket.setdefault(
                key, {"bytes": 0, "seconds": 0.0, "sites": {}}
            )
            site = ph["sites"].setdefault(
                ev.site,
                {"direction": ev.direction, "bytes": 0, "seconds": 0.0,
                 "count": 0},
            )
            site["bytes"] += ev.nbytes
            site["seconds"] += ev.duration
            site["count"] += 1
            if ev.direction != HOST:
                ph["bytes"] += ev.nbytes
            ph["seconds"] += ev.duration

        for ev in self.events():
            if ev.window != window:
                continue
            phase = ev.phase or "?"
            # old phase names stay aggregates (back-compat): a dotted
            # sub-phase ("seal.upload") bills its root ("seal") in
            # ``phases`` and gets its own full-resolution row in
            # ``subphases`` — phase x site x bytes x seconds
            _acc(phases, phase.split(".", 1)[0], ev)
            if "." in phase:
                _acc(subphases, phase, ev)
            # sub-phase SITES always get a row, even when the crossing
            # ran under a canonical phase tag (the collect-thread
            # rootcheck keeps phase="collect" so collect-share gauges
            # stay honest, but its site is seal.rootcheck)
            elif ev.site.startswith("seal."):
                _acc(subphases, ev.site, ev)
            if ev.direction != HOST:
                directions[ev.direction] = (
                    directions.get(ev.direction, 0) + ev.nbytes
                )
            cls = COLLECT_CLASSES.get(ev.site)
            if cls is not None:
                agg = classes.setdefault(
                    cls, {"bytes": 0, "seconds": 0.0}
                )
                agg["bytes"] += ev.nbytes
                agg["seconds"] += ev.duration
        if not phases:
            return None
        n_blocks = hi - lo + 1
        return {
            "window": window,
            "block_lo": lo,
            "block_hi": hi,
            "blocks": n_blocks,
            "phases": phases,
            "subphases": subphases,
            "device_bytes": directions,
            "device_bytes_per_block": {
                d: b // n_blocks for d, b in directions.items()
            },
            "collect_classes": classes,
        }

    def phase_bytes_per_block(self, rollup: bool = True) -> Dict[str, dict]:
        """{phase: {h2d: bytes/block, d2h: bytes/block}} over the whole
        ring — the --trace per-phase breakdown. ``rollup=True`` (the
        default, and what every pre-subphase caller expects) bills a
        dotted sub-phase ("seal.upload") to its root ("seal");
        ``rollup=False`` keys by the full dotted phase so --capture can
        record the sub-phase movement columns."""
        agg: Dict[str, Dict[str, int]] = {}
        for ev in self.events():
            if ev.direction == HOST:
                continue
            ph = ev.phase or "?"
            if rollup:
                ph = ph.split(".", 1)[0]
            agg.setdefault(ph, {}).setdefault(ev.direction, 0)
            agg[ph][ev.direction] += ev.nbytes
        blocks = max(1, self.blocks)
        return {
            ph: {d: b // blocks for d, b in dirs.items()}
            for ph, dirs in agg.items()
        }

    def subphase_bytes_per_block(self) -> Dict[str, dict]:
        """{subphase: {h2d: .., d2h: ..}} bytes/block for seal.* work,
        joined by SITE as well as dotted phase tag (the collect-thread
        seal.rootcheck keeps phase="collect"; its site carries the
        attribution) — the --capture sub-phase movement columns."""
        agg: Dict[str, Dict[str, int]] = {}
        for ev in self.events():
            if ev.direction == HOST:
                continue
            ph = ev.phase or "?"
            key = None
            if "." in ph:
                key = ph
            elif ev.site.startswith("seal."):
                key = ev.site
            if key is None:
                continue
            agg.setdefault(key, {}).setdefault(ev.direction, 0)
            agg[key][ev.direction] += ev.nbytes
        blocks = max(1, self.blocks)
        return {
            ph: {d: b // blocks for d, b in dirs.items()}
            for ph, dirs in agg.items()
        }


# THE process ledger: instrumentation seams import this instance. The
# hot paths all run in-process (the driver and the stage threads share
# it), so unlike tracer rings one instance is the right scope.
LEDGER = TransferLedger()


def apply_config(cfg) -> None:
    """Wire ObservabilityConfig.ledger_enabled/ledger_capacity.
    Idempotent; an explicit disabled config does not stomp a manual
    enable (a caller may flip the ledger on over a default config)."""
    if cfg is None:
        return
    if getattr(cfg, "ledger_enabled", False) and not LEDGER.enabled:
        LEDGER.enable(getattr(cfg, "ledger_capacity", None))


# ledger health + derived per-block rates for the registry (pull-time:
# the gauges exist only once something is recorded, and a disabled
# ledger costs the exposition nothing but three constant samples)
def _ledger_samples():
    samples = [
        ("khipu_transfer_ledger_enabled", "gauge", {},
         int(LEDGER.enabled)),
        ("khipu_transfer_events_recorded_total", "counter", {},
         LEDGER.recorded),
        ("khipu_transfer_events_dropped_total", "counter", {},
         LEDGER.dropped),
    ]
    if LEDGER.blocks > 0:
        for direction, nbytes in LEDGER.direction_totals().items():
            samples.append((
                "khipu_device_transfer_bytes_per_block", "gauge",
                {"direction": direction}, nbytes // LEDGER.blocks,
            ))
        # the device-resident-commit headline: with the mirror owning
        # the commit, the collect stage should fetch only per-block
        # root digests (32 B/block) — this gauge near zero IS the
        # "collect wall broken" signal the bench smoke pins
        samples.append((
            "khipu_collect_d2h_bytes_per_block", "gauge", {},
            LEDGER.phase_bytes_per_block()
            .get("collect", {}).get(D2H, 0),
        ))
    return samples


REGISTRY.register_collector("transfer_ledger", _ledger_samples)
