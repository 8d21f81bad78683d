"""The metrics wire codec of the cluster telemetry plane.

The port's copy of the codec half of ``khipu_tpu.observability.telemetry``:
``encode_metrics`` / ``decode_metrics``, the ``GetMetrics`` payload (one
consistent ``MetricsRegistry.families()`` pull as RLP rows, values as
JSON). A read replica's ``get_metrics`` (serving/replica.py) answers in
it, so a replica is a valid scrape client. The payloads are byte-equal
to the reference's for the same families.

Not ported yet (ROADMAP A11): ``ClusterTelemetry`` (the shard poller and
the merged exposition), ``HealthScore`` and the ``Watchdog``. They need
the bridge and ``cluster/client.py``.
"""

from __future__ import annotations

import json

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.observability.registry import MetricsRegistry

__all__ = ["encode_metrics", "decode_metrics"]


def _decode_value(v):
    # histogram bucket keys rode through JSON as strings; restore the
    # float ``le`` bounds so merged rendering matches local rendering
    if isinstance(v, dict) and "buckets" in v:
        v = dict(v)
        v["buckets"] = {
            float(k): c for k, c in v["buckets"].items()
        }
    return v


def encode_metrics(registry: MetricsRegistry) -> bytes:
    """The GetMetrics response: one consistent ``families()`` pull as
    RLP rows ``[name, kind, help, [[labels_json, value_json], ...]]``.
    Values ship as JSON — ints, floats, and histogram dicts all
    round-trip; RLP frames the rows the same way GetTraceSpans does."""
    rows = []
    for name, (kind, help, samples) in sorted(
        registry.families().items()
    ):
        srows = [
            [
                json.dumps(lb, sort_keys=True).encode(),
                json.dumps(v).encode(),
            ]
            for lb, v in samples
        ]
        rows.append([name.encode(), kind.encode(), help.encode(), srows])
    return rlp_encode(rows)


def decode_metrics(payload: bytes) -> dict:
    """Inverse of :func:`encode_metrics`:
    ``{name: (kind, help, [(labels_dict, value)])}`` — the exact shape
    ``MetricsRegistry.families()`` returns locally."""
    fams = {}
    for name, kind, help, srows in rlp_decode(payload):
        samples = []
        for lb, v in srows:
            labels = json.loads(lb.decode() or "{}")
            value = _decode_value(json.loads(v.decode()))
            samples.append((labels, value))
        fams[name.decode()] = (kind.decode(), help.decode(), samples)
    return fams
