"""Sharded distributed node-cache cluster (P6 scaled out).

Parity: khipu-eth/.../storage/DistributedNodeStorage.scala:13-57 and
NodeEntity.scala:28-50 — the reference spreads its MPT node cache
across an Akka cluster by hash shard with automatic failover. Here the
shards are bridge endpoints (bridge.py GetNodeData/PutNodeData)
and the Akka cluster-sharding machinery becomes an explicit consistent
-hash ring (ring.py), a replica-failover read client (client.py) and a
health/membership prober (health.py) — the same shape as a sharded
parameter-server tier: deterministic placement, bounded retry,
circuit breakers, and per-shard observability. The port's copy of
``khipu_tpu.cluster``: the same names and the same placement, key for
key.
"""

from khipu_tpu_torch.cluster.ring import HashRing
from khipu_tpu_torch.cluster.client import (
    CircuitBreaker,
    ShardedNodeClient,
    ShardMetrics,
)
from khipu_tpu_torch.cluster.health import HealthMonitor
from khipu_tpu_torch.cluster.rebalance import (
    RebalanceAborted,
    RebalanceError,
    Rebalancer,
    movement_plan,
)
from khipu_tpu_torch.cluster.ring import RingSnapshot

__all__ = [
    "HashRing",
    "RingSnapshot",
    "CircuitBreaker",
    "ShardedNodeClient",
    "ShardMetrics",
    "HealthMonitor",
    "Rebalancer",
    "RebalanceError",
    "RebalanceAborted",
    "movement_plan",
]
