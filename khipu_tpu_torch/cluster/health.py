"""Health/membership prober: endpoints leave and re-join the ring.

Parity: the Akka cluster failure detector + MemberUp/MemberRemoved
events DistributedNodeStorage reacts to. A periodic Ping probe decides
dead/alive per endpoint with hysteresis (``down_after`` consecutive
misses to leave, ``up_after`` consecutive hits to re-join) so one
dropped heartbeat doesn't thrash the ring. Verdicts call the client's
mark_dead/mark_alive, which swap the ring snapshot atomically —
in-flight reads finish on the chains they already resolved, so a
rebalance never drops a read mid-flight. The port's copy of
``khipu_tpu.cluster.health``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from khipu_tpu_torch.cluster.client import ShardedNodeClient


class HealthMonitor:
    """Probe loop over every configured endpoint (dead ones included —
    that is how they come back)."""

    def __init__(
        self,
        client: ShardedNodeClient,
        interval: float = 5.0,
        down_after: int = 2,
        up_after: int = 1,
        probe: Optional[Callable[[str], bool]] = None,
        log: Optional[Callable[[str], None]] = None,
    ):
        self.client = client
        self.interval = interval
        self.down_after = down_after
        self.up_after = up_after
        self.probe = probe or client.ping
        self.log = log or (lambda s: None)
        self.transitions = 0  # dead<->alive verdicts issued
        self._misses: Dict[str, int] = {}
        self._hits: Dict[str, int] = {}
        self._alive: Dict[str, bool] = {
            ep: True for ep in client.metrics
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        client._health = self
        # liveness verdicts were a private dict invisible to metrics;
        # export them as khipu_shard_up{endpoint=} (REPLACES by key —
        # the newest monitor owns the samples, same story as the
        # cluster client's collector)
        try:
            from khipu_tpu_torch.observability.registry import REGISTRY

            REGISTRY.register_collector(
                "cluster_health", self._registry_samples
            )
        except Exception:
            pass  # metrics are optional; the probe loop is not

    def _registry_samples(self) -> list:
        samples = [
            ("khipu_shard_up", "gauge", {"endpoint": ep},
             1 if alive else 0)
            for ep, alive in sorted(self._alive.items())
        ]
        samples.append((
            "khipu_shard_transitions_total", "counter", {},
            self.transitions,
        ))
        return samples

    # ------------------------------------------------------------ probes

    def alive(self, endpoint: str) -> bool:
        return self._alive.get(endpoint, False)

    def track(self, endpoint: str) -> None:
        """Start probing an endpoint that joined after construction
        (live rebalance cutover). Idempotent; the endpoint starts
        alive — it just proved itself by surviving the stream."""
        if endpoint not in self._alive:
            self._alive[endpoint] = True
            self._misses[endpoint] = 0
            self._hits[endpoint] = 0

    def untrack(self, endpoint: str) -> None:
        """Stop probing a retired endpoint (it left the membership on
        purpose — a dead-verdict for it would be noise)."""
        self._alive.pop(endpoint, None)
        self._misses.pop(endpoint, None)
        self._hits.pop(endpoint, None)

    def probe_once(self) -> Dict[str, bool]:
        """One probe round; returns the current verdict map."""
        for ep in list(self._alive):
            ok = self.probe(ep)
            if ok:
                self._misses[ep] = 0
                self._hits[ep] = self._hits.get(ep, 0) + 1
                if (
                    not self._alive[ep]
                    and self._hits[ep] >= self.up_after
                ):
                    self._alive[ep] = True
                    self.transitions += 1
                    self.client.mark_alive(ep)
                    self.log(f"cluster: {ep} re-joined the ring")
                    # anti-entropy: push the writes the endpoint missed
                    # while it was out of the ring (client.backfill)
                    backfill = getattr(self.client, "backfill", None)
                    if backfill is not None:
                        try:
                            pushed = backfill(ep)
                        except Exception:
                            pushed = -1  # debt re-recorded by backfill
                        if pushed:
                            self.log(
                                f"cluster: backfilled {pushed} missed "
                                f"keys onto {ep}"
                            )
            else:
                self._hits[ep] = 0
                self._misses[ep] = self._misses.get(ep, 0) + 1
                if (
                    self._alive[ep]
                    and self._misses[ep] >= self.down_after
                ):
                    self._alive[ep] = False
                    self.transitions += 1
                    self.client.mark_dead(ep)
                    self.log(f"cluster: {ep} marked dead")
        return dict(self._alive)

    # ------------------------------------------------------- background

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.probe_once()
                except Exception:
                    pass  # a probe crash must never kill the monitor

        self._thread = threading.Thread(
            target=loop, name="cluster-health", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
