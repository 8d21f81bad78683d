"""Flight-recorder observability: block-lifecycle tracing, the
movement ledger, the tx passport and trace exports.

The port's copy of ``khipu_tpu.observability``, its one-process half:

* registry.py — the unified Counter/Gauge/Histogram registry and its
  Prometheus text exposition;
* trace.py — nestable spans with explicit cross-thread parent links
  into a fixed-size lock-light ring buffer; near-zero cost and
  bit-exact identical behavior when disabled (the default);
* recorder.py — per-block lifecycle records, pipeline-occupancy
  timeline, phase latency percentiles, the build-event log;
* profiler.py — the per-site host<->device transfer ledger;
* costmodel.py — per-window roofline verdicts against the H100's
  measured floors;
* export.py — report payloads and Chrome ``trace_event`` JSON for
  perfetto;
* journey.py — the per-transaction lineage plane;
* telemetry.py — the metrics wire codec a read replica's scrape
  surface answers in.

The cluster telemetry federation (the rest of ``telemetry.py``) and
export's cluster half need the bridge and come with it (ROADMAP A11).
"""

from khipu_tpu_torch.observability.trace import (  # noqa: F401
    Tracer,
    apply_config,
    current_token,
    disable,
    enable,
    event,
    span,
    tracer,
)
