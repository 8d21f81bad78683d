"""Per-window roofline cost model: attainable vs achieved per seal
sub-phase.

The port's copy of ``khipu_tpu.observability.costmodel``, with the
H100's floors in place of the TPU's. The sub-phase instrumentation
(seal.pack / seal.alias_gather / seal.dispatch_build / seal.upload /
seal.rootcheck / seal.journal) splits the seal wall into named steps;
this module answers the NEXT question — "is each step as fast as the
hardware allows, and if not, what is it bound by?" — by joining three
measurements per window:

* TransferLedger bytes + crossing counts per sub-phase site
  (observability/profiler.py ``window_report``),
* span wall seconds per sub-phase (trace.py ring snapshot),
* node/hash counts carried as span tags (``seal.dispatch_build`` tags
  the window's node count).

against floors measured on the card by ``chip_smoke.py``'s calibration
step (phase ``traced_replay_erc20_w8``):

* ``bytes_s``    = device_bytes / the pinned H2D rate of a window's
  upload size;
* ``dispatch_s`` = d2h_crossings x the median blocking 32 B D2H round
  trip. Only blocking device->host fetches pay it; asynchronous H2D
  enqueues do not;
* ``compute_s``  = hashes / K1f's kernel-only rate at 1M x 576 B rows
  (5 rate blocks a row, ``ELEMENT_OPS_PER_BLOCK`` int32 operations a
  block against the card's ``ELEMENT_OPS_PER_S``).

``attainable_s`` is the max applicable floor (rooflines compose as
max, not sum: transfers overlap compute on this pipeline). The
verdict per sub-phase:

* the argmax floor's name (``bytes-bound`` / ``dispatch-bound`` /
  ``compute-bound``) when achieved is within ``FIXED_OVERHEAD_FACTOR``
  of attainable — the step is pushing a real hardware limit;
* ``fixed-overhead`` when achieved exceeds every floor by more than
  that factor (or no floor applies at all) — the time is going to
  host-side work / framework overhead, i.e. the step is OPTIMIZABLE
  without faster hardware.

Surfaces: ``window_costs(n)`` and a chrome-trace counter track
(export.counter_tracks appends ``cost_tracks``) so perfetto shows
attainable-vs-achieved per window next to the span timeline.
Everything here is read-only over snapshots — safe to call from
another thread while a replay runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from khipu_tpu_torch.observability.profiler import D2H, H2D, HOST, LEDGER
from khipu_tpu_torch.observability.recorder import SEAL_SUBPHASES
from khipu_tpu_torch.observability.trace import Span, Tracer, tracer

# The floors, measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (nvidia-smi) by chip_smoke.py's calibration step (phase
# traced_replay_erc20_w8; PERF.md section 6). A card set below 700 W
# runs slower under load: re-run the step there.
DISPATCH_FLOOR_S = 22.61e-6  # median blocking 32 B D2H round trip
H2D_BYTES_PER_S = 48.67e9  # pinned H2D copy of 7,524,412 B (a window's upload)
KERNEL_HASHES_PER_S = 693.8e6  # K1f kernel-only rate at 1M x 576 B rows
# 64 INT32 lanes an SM x 132 SMs x 1.98 GHz, and the int32 operations
# of one absorbed rate block (180 a round x 24 rounds + 34 XORs):
# PERF.md's sponge bound
ELEMENT_OPS_PER_S = 64 * 132 * 1.98e9
ELEMENT_OPS_PER_BLOCK = 4_354

# achieved more than this multiple over EVERY applicable floor means
# the time is host/framework overhead, not a hardware bound
FIXED_OVERHEAD_FACTOR = 3.0

_BOUND_NAMES = {
    "bytes_s": "bytes-bound",
    "dispatch_s": "dispatch-bound",
    "compute_s": "compute-bound",
}


def subphase_floors(device_bytes: int, d2h_crossings: int,
                    hashes: int) -> Dict[str, float]:
    """The applicable roofline floors for one sub-phase's inputs.
    A floor appears only when its driving quantity was observed — a
    step that moved no bytes has no bytes floor, not a zero floor."""
    floors: Dict[str, float] = {}
    if device_bytes > 0:
        floors["bytes_s"] = device_bytes / H2D_BYTES_PER_S
    if d2h_crossings > 0:
        floors["dispatch_s"] = d2h_crossings * DISPATCH_FLOOR_S
    if hashes > 0:
        floors["compute_s"] = hashes / KERNEL_HASHES_PER_S
    return floors


def classify(achieved_s: float, floors: Dict[str, float]) -> dict:
    """Attainable-vs-achieved verdict for one sub-phase."""
    attainable = max(floors.values()) if floors else 0.0
    if attainable <= 0:
        bound = "fixed-overhead"
    elif achieved_s > FIXED_OVERHEAD_FACTOR * attainable:
        bound = "fixed-overhead"
    else:
        bound = _BOUND_NAMES[max(floors, key=floors.get)]
    eff = (
        min(1.0, attainable / achieved_s) if achieved_s > 0 else 0.0
    )
    return {
        "floors": {k: round(v, 6) for k, v in floors.items()},
        "attainable_s": round(attainable, 6),
        "bound": bound,
        "efficiency": round(eff, 4),
    }


def _window_spans(spans: Sequence[Span], lo: int, hi: int) -> List[Span]:
    return [
        s for s in spans
        if s.tags.get("block_lo") == lo and s.tags.get("block_hi") == hi
    ]


def window_costs(number: int,
                 spans: Optional[Sequence[Span]] = None,
                 tracer_: Optional[Tracer] = None) -> dict:
    """Per-sub-phase roofline
    rows for the window containing block ``number``, plus the headline
    verdict (the costliest sub-phase and what it is bound by).

    Returns ``{"found": False, ...}`` when the ledger has no window
    covering ``number``.
    """
    rep = LEDGER.window_report(number)
    if rep is None:
        return {
            "found": False,
            "number": number,
            "ledgerEnabled": LEDGER.enabled,
        }
    t = tracer_ if tracer_ is not None else tracer
    if spans is None:
        spans = t.snapshot()
    lo, hi = rep["block_lo"], rep["block_hi"]

    # span-side join: seconds + node counts per sub-phase name. Window
    # spans carry block_lo/hi range tags; sub-phase spans inherit them
    # only on the driver side, so fall back to ANY span of that name
    # when the window-scoped filter finds none (single-window
    # captures) — ledger seconds remain the last resort.
    scoped = _window_spans(spans, lo, hi)
    span_s: Dict[str, float] = {}
    span_nodes: Dict[str, int] = {}
    for s in spans:
        if s.name not in SEAL_SUBPHASES:
            continue
        span_s[s.name] = span_s.get(s.name, 0.0) + s.duration
        n = s.tags.get("nodes")
        if n:
            span_nodes[s.name] = span_nodes.get(s.name, 0) + int(n)
    scoped_s: Dict[str, float] = {}
    for s in scoped:
        if s.name in SEAL_SUBPHASES:
            scoped_s[s.name] = scoped_s.get(s.name, 0.0) + s.duration

    rows: Dict[str, dict] = {}
    sub = rep.get("subphases", {})
    names = set(sub) | set(scoped_s) | set(span_s)
    for name in sorted(names):
        if not name.startswith("seal."):
            continue
        ledger_row = sub.get(name, {})
        device_bytes = 0
        d2h_crossings = 0
        ledger_s = 0.0
        for site, agg in ledger_row.get("sites", {}).items():
            ledger_s += agg["seconds"]
            if agg["direction"] == HOST:
                continue
            device_bytes += agg["bytes"]
            if agg["direction"] == D2H:
                d2h_crossings += agg["count"]
        achieved = scoped_s.get(name) or span_s.get(name) or ledger_s
        hashes = span_nodes.get(name, 0)
        floors = subphase_floors(device_bytes, d2h_crossings, hashes)
        rows[name] = {
            "achieved_s": round(achieved, 6),
            "device_bytes": device_bytes,
            "d2h_crossings": d2h_crossings,
            "hashes": hashes,
            **classify(achieved, floors),
        }

    verdict = None
    if rows:
        top = max(rows, key=lambda n: rows[n]["achieved_s"])
        verdict = {
            "subphase": top,
            "bound": rows[top]["bound"],
            "achieved_s": rows[top]["achieved_s"],
            "attainable_s": rows[top]["attainable_s"],
        }
    return {
        "found": True,
        "number": number,
        "window": rep["window"],
        "block_lo": lo,
        "block_hi": hi,
        "blocks": rep["blocks"],
        "subphases": rows,
        "verdict": verdict,
        "floors": {
            "dispatch_floor_s": DISPATCH_FLOOR_S,
            "h2d_bytes_per_s": H2D_BYTES_PER_S,
            "kernel_hashes_per_s": KERNEL_HASHES_PER_S,
        },
    }


def cost_tracks(tracer_: Optional[Tracer] = None) -> List[dict]:
    """Chrome counter ("C") events: one ``window cost model`` sample
    per sealed window — achieved vs attainable seconds summed over its
    seal sub-phases, stamped at the window's last ledger event. The
    track renders under the span timeline so "this window ran 5x over
    its roofline" is visible in perfetto without leaving the trace."""
    t = tracer_ if tracer_ is not None else tracer
    events = LEDGER.events()
    if not events:
        return []
    last_t0: Dict[int, float] = {}
    for ev in events:
        if ev.window >= 0:
            last_t0[ev.window] = max(
                last_t0.get(ev.window, 0.0), ev.t0 + ev.duration
            )
    out: List[dict] = []
    for window, lo, hi in list(LEDGER._windows):
        costs = window_costs(lo, tracer_=t)
        if not costs.get("found") or not costs["subphases"]:
            continue
        achieved = sum(
            r["achieved_s"] for r in costs["subphases"].values()
        )
        attainable = sum(
            r["attainable_s"] for r in costs["subphases"].values()
        )
        ts = last_t0.get(window)
        if ts is None:
            continue
        out.append({
            "name": "window cost model (s)", "ph": "C",
            "pid": 1, "tid": 0,
            "ts": round((ts - t.epoch_perf) * 1e6, 3),
            "args": {
                "achieved_s": round(achieved, 6),
                "attainable_s": round(attainable, 6),
            },
        })
    return out
