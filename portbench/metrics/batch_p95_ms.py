"""batch_p95_ms: the 95th percentile (nearest rank) over all the
window's calls of a call's latency on the host clock, from its
submission to its result: the digests complete on the card, or the
count returned. A call submitted while others are in flight waits
behind them, and the wait counts."""

import math


def read(r):
    lat = sorted(r.latencies_ms)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
