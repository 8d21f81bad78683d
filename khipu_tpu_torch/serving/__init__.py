"""Serving plane: the layer between the JSON-RPC surface and the
sync/storage stack that makes the node SERVE while it SYNCS.

Three cooperating pieces (docs/serving.md):

* :mod:`khipu_tpu_torch.serving.readview` — read-your-writes overlay so
  state reads at ``latest`` never go backwards while windows are in
  flight between driver commit and collector persist;
* :mod:`khipu_tpu_torch.serving.admission` — per-cost-class AIMD concurrency
  limits + bounded queues + node pressure signals, shedding with
  ``-32005`` instead of queueing without bound;
* :mod:`khipu_tpu_torch.serving.slo` — per-method latency histograms,
  outcome counters and the p99/error-budget evaluation on the unified
  registry.

:class:`ServingPlane` bundles them behind the two-call surface the
RPC server uses (``admit`` / ``finish``) plus the snapshot
``khipu_metrics`` embeds. The plane is OPT-IN: a ``JsonRpcServer``
without one dispatches directly, zero overhead.

The port's copy of ``khipu_tpu.serving``. The cluster telemetry signal
is not ported (ROADMAP A11): ``build(telemetry=)`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from khipu_tpu_torch.config import KhipuConfig, ServingConfig
from khipu_tpu_torch.serving.admission import (
    AdmissionController,
    ServerBusy,
    classify_method,
    cluster_pressure,
    journal_pressure,
    pipeline_pressure,
    rebalance_pressure,
    replica_lag_pressure,
    txpool_pressure,
)
from khipu_tpu_torch.serving.readview import ReadView
from khipu_tpu_torch.serving.slo import SloPolicy, SloTracker

__all__ = [
    "AdmissionController",
    "FleetRouter",
    "PrimaryFeed",
    "ReadToken",
    "ReadView",
    "ReplicaDriver",
    "ServerBusy",
    "ServingPlane",
    "SloPolicy",
    "SloTracker",
    "classify_method",
    "cluster_pressure",
    "journal_pressure",
    "pipeline_pressure",
    "rebalance_pressure",
    "replica_lag_pressure",
    "txpool_pressure",
]


def __getattr__(name):
    # fleet pieces import jsonrpc (which imports this package back
    # through admission) — lazy re-export keeps the package cycle-free
    if name in ("FleetRouter",):
        from khipu_tpu_torch.serving.fleet import FleetRouter

        return FleetRouter
    if name in ("PrimaryFeed", "ReplicaDriver"):
        from khipu_tpu_torch.serving import replica as _replica

        return getattr(_replica, name)
    if name == "ReadToken":
        from khipu_tpu_torch.serving.router import ReadToken

        return ReadToken
    raise AttributeError(name)


class ServingPlane:
    """admission + SLO + read view, one object.

    ``admit(method)`` returns an opaque ticket or raises
    :class:`ServerBusy` (recording the shed); ``finish(method, ticket,
    error=...)`` releases the slot and lands the latency in the
    method's histogram. The RPC server never touches the parts."""

    def __init__(
        self,
        config: Optional[ServingConfig] = None,
        read_view: Optional[ReadView] = None,
        admission: Optional[AdmissionController] = None,
        slo: Optional[SloTracker] = None,
    ):
        self.config = config or ServingConfig()
        self.read_view = read_view
        self.admission = admission or AdmissionController(self.config)
        self.slo = slo or SloTracker(
            SloPolicy(objective=self.config.objective)
        )

    @classmethod
    def build(
        cls,
        blockchain,
        config: Optional[KhipuConfig] = None,
        tx_pool=None,
        extra_signals: Optional[List[Callable[[], float]]] = None,
        telemetry=None,
    ) -> "ServingPlane":
        """The standard wiring (what ``ServiceBoard.start_serving``
        calls): a ReadView over ``blockchain`` plus admission fed by
        every pressure signal the node can report — window-pipeline
        occupancy, commit-journal depth and txpool fill."""
        if telemetry is not None:
            raise NotImplementedError(
                "the cluster telemetry plane is not ported (ROADMAP A11)"
            )
        cfg = config or KhipuConfig()
        signals: List[Callable[[], float]] = [pipeline_pressure()]
        if cfg.sync.commit_journal:
            signals.append(journal_pressure(
                blockchain.storages, cfg.sync.pipeline_depth
            ))
        if tx_pool is not None:
            signals.append(txpool_pressure(tx_pool))
        signals.extend(extra_signals or [])
        return cls(
            config=cfg.serving,
            read_view=ReadView(blockchain),
            admission=AdmissionController(cfg.serving, signals=signals),
        )

    # ---------------------------------------------------------- hot path

    def admit(self, method: str):
        try:
            return self.admission.acquire(method)
        except ServerBusy:
            self.slo.observe(method, 0.0, "shed")
            raise

    def finish(self, method: str, ticket, error: bool = False) -> None:
        dt = self.admission.release(ticket)
        self.slo.observe(method, dt, "error" if error else "ok")

    # ----------------------------------------------------------- surface

    def snapshot(self) -> Dict:
        out = {
            "admission": self.admission.snapshot(),
            "slo": self.slo.evaluate(),
        }
        if self.read_view is not None:
            out["readView"] = self.read_view.snapshot()
        return out
