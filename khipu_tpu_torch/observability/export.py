"""Serve the flight recorder: report payloads + Chrome trace JSON.

The port's copy of ``khipu_tpu.observability.export``. Every export works on ONE
``tracer.snapshot()`` so a live workload can't tear a report:

* ``snapshot`` / ``trace_block(n)`` — the structured aggregates the JAX
  package serves as its ``khipu_traces`` / ``khipu_trace_block`` RPCs;
* ``chrome_trace()`` / ``dump_chrome_trace(path)`` — Chrome
  ``trace_event`` JSON (the ``traceEvents`` array format) loadable in
  perfetto / chrome://tracing. Spans become complete ("X") events;
  explicit cross-thread parent links additionally emit a flow pair
  ("s" at the parent, "f" at the child, bound by the parent span id)
  so the driver -> stage-thread handoff renders as an arrow across
  thread tracks.

The CLUSTER half: ``merged_chrome_trace`` overlays shard span rings
(pulled over the bridge's ``GetTraceSpans``) onto the driver timeline.
Shard clocks are independent, so each shard timeline is shifted by a
Ping-based NTP-style offset estimate (``shard_timeline``) — ``offset =
shard_now - (t_send + t_recv)/2``, error bounded by RTT/2 — and each
server span whose propagated parent token resolves in the driver ring is
clamped INTO its client RPC span (the residual RTT/2 error must not
render an effect before its cause). Every merged dump is one nested
driver → bridge → shard trace.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from khipu_tpu_torch.observability import recorder
from khipu_tpu_torch.observability.trace import Span, Tracer, tracer


def _sanitize(v):
    return v.hex() if isinstance(v, bytes) else v


# ------------------------------------------------------------ RPC side


def snapshot(tracer_: Optional[Tracer] = None) -> dict:
    """Recorder state + aggregates (the JAX package's ``khipu_traces``
    payload, without its fused compile cache's stats: the port has no
    such cache)."""
    t = tracer_ if tracer_ is not None else tracer
    spans = t.snapshot()
    out = {
        "enabled": t.enabled,
        "capacity": t.capacity,
        "traceId": t.trace_id,
        "recorded": t.recorded,
        "buffered": len(spans),
        "dropped": t.dropped,
        "blocks": recorder.traced_blocks(spans),
        "phasePercentiles": recorder.phase_percentiles(spans),
        "phaseBreakdownSeconds": recorder.phase_breakdown(spans),
        "occupancy": round(recorder.occupancy(spans), 4),
        "occupancyTimeline": recorder.occupancy_timeline(spans),
        "compileCache": recorder.compile_log.snapshot(),
    }
    return out


def trace_block(number: int, tracer_: Optional[Tracer] = None) -> dict:
    """The block's lifecycle record (recorder.lifecycle) from the
    current ring contents (the JAX package's ``khipu_trace_block(n)``
    payload)."""
    t = tracer_ if tracer_ is not None else tracer
    return recorder.lifecycle(t.snapshot(), number)


# --------------------------------------------------------- trace_event


def _us(t_perf: float, t: Tracer) -> float:
    """perf_counter stamp -> microseconds since the tracer epoch."""
    return round((t_perf - t.epoch_perf) * 1e6, 3)


def counter_tracks(spans: Optional[Sequence[Span]] = None,
                   tracer_: Optional[Tracer] = None) -> List[dict]:
    """Chrome counter ("C") events from the TransferLedger + recorder:

    * ``transfer bytes in flight`` — running sum per direction: +nbytes
      at each transfer's start, -nbytes at its end, so perfetto shows
      WHEN the host↔device link was loaded, not just how much total;
    * ``transfer bytes (cumulative)`` — per-phase cumulative bytes, the
      area chart that makes "collect moved 10x what seal did" visual;
    * ``pipeline occupancy`` — the recorder's driver/collector coverage
      timeline as a counter pair.

    Returns [] when the ledger has no events and no spans were given —
    an empty trace stays an empty trace.
    """
    from khipu_tpu_torch.observability.profiler import LEDGER

    t = tracer_ if tracer_ is not None else tracer
    events: List[dict] = []
    transfers = LEDGER.events()
    if transfers:
        # bytes-in-flight: merge the +start/-end edges per direction
        edges: List[tuple] = []
        cum: dict = {}
        cum_events: List[tuple] = []
        for e in transfers:
            if e.direction == "host":
                continue  # host persistence is not device traffic
            edges.append((e.t0, e.direction, e.nbytes))
            edges.append((e.t0 + e.duration, e.direction, -e.nbytes))
            phase = e.phase or "untagged"
            cum[phase] = cum.get(phase, 0) + e.nbytes
            cum_events.append((e.t0 + e.duration, dict(cum)))
        in_flight: dict = {}
        for ts, direction, delta in sorted(edges):
            in_flight[direction] = in_flight.get(direction, 0) + delta
            events.append({
                "name": "transfer bytes in flight", "ph": "C",
                "pid": 1, "tid": 0, "ts": _us(ts, t),
                "args": {d: max(0, v) for d, v in in_flight.items()},
            })
        for ts, totals in cum_events:
            events.append({
                "name": "transfer bytes (cumulative)", "ph": "C",
                "pid": 1, "tid": 0, "ts": _us(ts, t),
                "args": totals,
            })
    if spans:
        for row in recorder.occupancy_timeline(spans):
            events.append({
                "name": "pipeline occupancy", "ph": "C",
                "pid": 1, "tid": 0,
                "ts": round(row["t"] * 1e6, 3),
                "args": {
                    "driver": row["driver"],
                    "collector": row["collector"],
                },
            })
    if transfers:
        # roofline verdict per sealed window (attainable vs achieved
        # over the seal sub-phases) as its own counter track
        from khipu_tpu_torch.observability.costmodel import cost_tracks

        events.extend(cost_tracks(tracer_=t))
    return events


def chrome_trace(spans: Optional[Sequence[Span]] = None,
                 tracer_: Optional[Tracer] = None) -> dict:
    """Chrome ``trace_event`` JSON object format for the given spans
    (default: the live ring). One process, one track per thread, plus
    the TransferLedger counter tracks (``counter_tracks``)."""
    t = tracer_ if tracer_ is not None else tracer
    if spans is None:
        spans = t.snapshot()
    by_id = {s.sid: s for s in spans}
    events: List[dict] = []
    threads = {}
    for s in spans:
        if s.tid not in threads:
            threads[s.tid] = s.thread_name or f"thread-{s.tid}"
    # thread-name metadata first, so tracks are labeled
    for tid, name in sorted(threads.items()):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": name},
        })
    for s in spans:
        args = {k: _sanitize(v) for k, v in s.tags.items()}
        if s.parent is not None:
            args["parentSpan"] = s.parent
        if s.error:
            args["error"] = True
        args["cpu_ms"] = round(s.cpu * 1e3, 3)
        base = {"name": s.name, "pid": 1, "tid": s.tid, "args": args}
        if s.t1 > s.t0:
            events.append({
                **base, "ph": "X", "ts": _us(s.t0, t),
                "dur": round(s.duration * 1e6, 3),
            })
        else:
            events.append(
                {**base, "ph": "i", "ts": _us(s.t0, t), "s": "t"}
            )
        # explicit cross-thread causality: a flow arrow from the parent
        # span's start to this span's start
        p = by_id.get(s.parent) if s.parent is not None else None
        if p is not None and p.tid != s.tid:
            flow_id = s.parent
            events.append({
                "name": f"{p.name}→{s.name}", "ph": "s",
                "id": flow_id, "pid": 1, "tid": p.tid,
                "ts": _us(p.t0, t), "cat": "handoff",
            })
            events.append({
                "name": f"{p.name}→{s.name}", "ph": "f",
                "bp": "e", "id": flow_id, "pid": 1, "tid": s.tid,
                "ts": _us(s.t0, t), "cat": "handoff",
            })
    events.extend(counter_tracks(spans, tracer_=t))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "recorder": "khipu-tpu flight recorder",
            "traceId": t.trace_id,
            "dropped": t.dropped,
            "epochUnixSeconds": t.epoch_wall,
        },
    }


def dump_chrome_trace(path: str,
                      spans: Optional[Sequence[Span]] = None,
                      tracer_: Optional[Tracer] = None) -> str:
    """Write the perfetto-loadable JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, tracer_), f)
    return path


# ---------------------------------------------------- cluster overlay


def shard_timeline(client, endpoint: str = "",
                   probe_samples: int = 5) -> dict:
    """Pull ONE shard's span ring + clock estimate over the bridge:
    ``client`` is a BridgeClient (or anything with ``clock_probe`` /
    ``get_trace_spans``). Returns the shard descriptor
    ``merged_chrome_trace`` consumes: {endpoint, offset_s, rtt_s,
    traceId, spans} where ``offset_s`` is (shard clock - local clock)
    from the minimum-RTT Ping probe and every span carries absolute
    shard-wall ``t0_wall``/``t1_wall`` seconds."""
    offset_s, rtt_s = client.clock_probe(samples=probe_samples)
    data = client.get_trace_spans()
    return {
        "endpoint": endpoint,
        "offset_s": offset_s,
        "rtt_s": rtt_s,
        "traceId": data.get("traceId", ""),
        "spans": data.get("spans", []),
    }


def merged_chrome_trace(shards: Sequence[dict],
                        spans: Optional[Sequence[Span]] = None,
                        tracer_: Optional[Tracer] = None) -> dict:
    """One Chrome trace spanning driver → bridge → shards.

    Driver spans render as pid 1 (exactly ``chrome_trace``); each shard
    becomes its own process (pid 2+i, named after its endpoint) with
    its timestamps mapped onto the driver timeline:

        driver_wall = shard_wall - offset_s
        ts_us       = (driver_wall - tracer.epoch_wall) * 1e6

    A server span whose propagated ``remote_parent`` token resolves in
    the driver ring (same ``remote_trace`` id) is CLAMPED into its
    client RPC span's interval: the offset estimate is only good to
    RTT/2, and an effect must never render before its cause — after
    clamping, nesting is non-negative by construction (the acceptance
    gate). The raw corrected timestamp is kept in args for audit. A
    cross-process flow arrow (client span start → server span start)
    makes the RPC edge explicit.
    """
    t = tracer_ if tracer_ is not None else tracer
    if spans is None:
        spans = t.snapshot()
    doc = chrome_trace(spans, tracer_=t)
    events = doc["traceEvents"]
    local_by_id = {s.sid: s for s in spans}
    shard_meta = []
    for i, sh in enumerate(shards):
        pid = 2 + i
        offset = sh.get("offset_s", 0.0)
        rtt = sh.get("rtt_s", 0.0)
        label = sh.get("endpoint") or f"shard-{i}"
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"shard {label}"},
        })
        tids = {}
        nested = 0
        for sp in sh.get("spans", ()):
            tid = sp.get("tid", 0)
            if tid not in tids:
                tids[tid] = sp.get("thread_name") or f"thread-{tid}"
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tids[tid]},
                })
            # shard wall -> driver timeline, offset-corrected
            ts = (sp["t0_wall"] - offset - t.epoch_wall) * 1e6
            dur = max(0.0, (sp["t1_wall"] - sp["t0_wall"]) * 1e6)
            args = dict(sp.get("tags", {}))
            if sp.get("parent"):
                args["parentSpan"] = sp["parent"]
            if sp.get("error"):
                args["error"] = True
            args["clockOffsetSeconds"] = round(offset, 6)
            rparent = args.get("remote_parent")
            parent = (
                local_by_id.get(rparent)
                if args.get("remote_trace") == t.trace_id
                and rparent is not None else None
            )
            if parent is not None:
                p0 = _us(parent.t0, t)
                p1 = _us(parent.t1, t)
                args["correctedTsUs"] = round(ts, 3)
                # clamp into the client RPC span: duration first (a
                # server span cannot outlast the round trip that
                # carried it), then the start
                dur = min(dur, max(0.0, p1 - p0))
                ts = min(max(ts, p0), max(p0, p1 - dur))
                nested += 1
                events.append({
                    "name": f"rpc→{sp['name']}", "ph": "s",
                    "id": rparent, "pid": 1, "tid": parent.tid,
                    "ts": p0, "cat": "rpc",
                })
                events.append({
                    "name": f"rpc→{sp['name']}", "ph": "f", "bp": "e",
                    "id": rparent, "pid": pid, "tid": tid,
                    "ts": round(ts, 3), "cat": "rpc",
                })
            base = {
                "name": sp["name"], "pid": pid, "tid": tid,
                "args": args,
            }
            if dur > 0:
                events.append({
                    **base, "ph": "X", "ts": round(ts, 3),
                    "dur": round(dur, 3),
                })
            else:
                events.append(
                    {**base, "ph": "i", "ts": round(ts, 3), "s": "p"}
                )
        shard_meta.append({
            "endpoint": label,
            "pid": pid,
            "traceId": sh.get("traceId", ""),
            "offsetSeconds": round(offset, 6),
            "rttSeconds": round(rtt, 6),
            "spans": len(sh.get("spans", ())),
            "nestedUnderDriver": nested,
        })
    doc["otherData"]["shards"] = shard_meta
    return doc


def dump_merged_chrome_trace(path: str, shards: Sequence[dict],
                             spans: Optional[Sequence[Span]] = None,
                             tracer_: Optional[Tracer] = None) -> str:
    with open(path, "w") as f:
        json.dump(merged_chrome_trace(shards, spans, tracer_), f)
    return path
