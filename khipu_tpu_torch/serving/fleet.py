"""FleetRouter: one RPC front over a primary and N read replicas.

The serving fleet's brain (docs/serving.md "Replica fleet"): reads
fan out to :class:`~khipu_tpu_torch.serving.replica.ReplicaDriver`s by
health-weighted pick-2, writes and executes forward to the primary,
and consistent-read tokens (serving/router.py) make read-your-writes
hold across replica failover AND across a chain switch. The router is
transport-agnostic: ``handle(request)`` speaks the same dict protocol
``JsonRpcServer.handle`` does, and ``start_http`` mounts it on the
real keep-alive HTTP front so a loadgen ``HttpTransport`` drives the
whole path over sockets.

Consistency plumbing that is easy to miss:

* the router registers as a listener on the PRIMARY's ReorgManager —
  a chain switch records the fork ancestor, and any token whose
  anchor hash the primary no longer serves RE-ANCHORS to that
  ancestor (counted in ``khipu_fleet_tokens_reanchored_total``)
  instead of demanding a height no honest replica can certify;
* replica-side staleness is wait-or-redirect: a token-bearing read
  waits up to ``ServingConfig.ryw_wait_s`` for the picked replica's
  tail to reach the token height, then falls back to the primary and
  counts ``khipu_fleet_ryw_redirects_total`` — stale state is never
  served under a token;
* ``fleet.route`` is a chaos seam (khipu-lint KL001 registered) so
  the seeded sweep can kill/raise inside the routing decision itself.

Registry families (owned by the single ``fleet`` collector so each
exposes exactly once): ``khipu_fleet_reads_per_sec`` (sliding-window
read rate), ``khipu_fleet_requests_total{route=}``,
``khipu_fleet_ryw_redirects_total``,
``khipu_fleet_tokens_reanchored_total``, and
``khipu_replica_lag_blocks{replica=}`` for every fleet member.

The port's copy of ``khipu_tpu.serving.fleet``. Health weights come
from liveness only: the ``ClusterTelemetry`` whose shard health scores
would weight the pick-2 is not ported (ROADMAP A11), so ``telemetry=``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.jsonrpc.eth_service import parse_data
from khipu_tpu_torch.jsonrpc.server import JsonRpcServer
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.serving.replica import ReplicaDriver
from khipu_tpu_torch.serving.router import (
    TOKEN_KEY,
    ReadToken,
    pick2,
    routes_to_replica,
)

_READS_WINDOW_S = 10.0


class FleetRouter:
    def __init__(
        self,
        primary_server,
        replicas: List[ReplicaDriver],
        telemetry=None,
        reorg_manager=None,
        seed: int = 0,
    ):
        """``primary_server`` is the primary's ``JsonRpcServer`` (its
        admission plane applies to everything the router forwards).
        Replicas weigh by liveness only (``telemetry``, the cluster's
        health scores, is not ported: ROADMAP A11).
        ``reorg_manager`` is the PRIMARY's: the router listens for
        switches to learn fork ancestors for token re-anchoring."""
        if telemetry is not None:
            raise NotImplementedError(
                "the cluster telemetry plane is not ported (ROADMAP A11)"
            )
        self.primary = primary_server
        self.replicas = list(replicas)
        self.chain_id = primary_server.service.config.blockchain.chain_id
        self._serving_cfg = primary_server.service.config.serving
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {r.name: 0 for r in replicas}
        self._last_ancestor: Optional[int] = None
        self.reads_replica = 0
        self.reads_primary = 0
        self.forwarded_primary = 0
        self.ryw_redirects = 0
        self.tokens_reanchored = 0
        self._read_times: deque = deque(maxlen=65536)
        self._http = None
        if reorg_manager is not None:
            reorg_manager.add_listener(self._note_primary_reorg)
        REGISTRY.register_collector("fleet", self._registry_samples)
        self._reclaim_primary_collectors()

    # ------------------------------------------------------ construction

    def _reclaim_primary_collectors(self) -> None:
        """Registry collectors replace by key and replicas are built
        AFTER the primary, so replica-owned components (their
        EthService, ReorgManager, FilterManager, AdmissionController)
        would otherwise own the process-level ``khipu_best_block_*`` /
        ``khipu_reorg_*`` / ``khipu_admission_*`` slots. The fleet's
        exposition is the PRIMARY's view (replica state exports under
        ``khipu_replica_lag_blocks{replica=}``), so re-assert the
        primary as the owner of each shared slot."""
        service = self.primary.service
        pairs = [
            ("chain", getattr(service, "_registry_samples", None)),
            ("filters", getattr(
                getattr(service, "_filter_manager", None),
                "_registry_samples", None,
            )),
            ("txpool", getattr(
                getattr(service, "tx_pool", None),
                "_registry_samples", None,
            )),
        ]
        serving = getattr(self.primary, "serving", None)
        if serving is not None and serving.admission is not None:
            pairs.append(
                ("admission", serving.admission._registry_samples)
            )
        journal = getattr(
            service.blockchain.storages, "window_journal", None
        )
        if journal is not None:
            pairs.append((
                "journal",
                lambda: [("khipu_journal_depth", "gauge", {},
                          journal.depth)],
            ))
        for key, fn in pairs:
            if fn is not None:
                REGISTRY.register_collector(key, fn)

    # ---------------------------------------------------------- reorgs

    def _note_primary_reorg(self, ancestor_number: int,
                            removed_hits) -> None:
        """ReorgManager listener: remember the deepest fork ancestor
        seen, the floor retracted tokens re-anchor to. (Replica-side
        retraction delivery rides the replicas' own mirrored switches;
        this hook is only the router's token bookkeeping.)"""
        with self._lock:
            if (self._last_ancestor is None
                    or ancestor_number < self._last_ancestor):
                self._last_ancestor = ancestor_number

    # ---------------------------------------------------------- tokens

    def _primary_height_and_hash(self):
        service = self.primary.service
        bc = service.blockchain
        view = getattr(service, "read_view", None)
        height = (
            view.head_number() if view is not None
            else bc.best_block_number
        )
        anchor = min(height, bc.best_block_number)
        header = bc.get_header_by_number(anchor)
        return height, (header.hash if header is not None else None)

    def _mint(self, replica: Optional[ReplicaDriver]) -> str:
        if replica is not None:
            number = replica.blockchain.best_block_number
            header = replica.blockchain.get_header_by_number(number)
            h = header.hash if header is not None else None
        else:
            number, h = self._primary_height_and_hash()
        return ReadToken(self.chain_id, number, h).encode()

    def _token_floor(self, token: Optional[ReadToken]) -> Optional[int]:
        """The height a node must serve to honor ``token`` — or the
        re-anchored height when a reorg retracted the token's block."""
        if token is None or token.chain_id != self.chain_id:
            return None
        if token.block_hash:
            bc = self.primary.service.blockchain
            header = bc.get_header_by_number(token.number)
            if (header is not None
                    and header.hash != token.block_hash):
                # the anchor block is off the canonical chain: the
                # write this token certified was retracted, so the
                # strongest honest floor left is the fork ancestor
                with self._lock:
                    ancestor = self._last_ancestor
                    self.tokens_reanchored += 1
                if ancestor is not None:
                    return min(token.number, ancestor)
                return min(token.number, bc.best_block_number)
        return token.number

    # --------------------------------------------------------- routing

    def _health(self, replica: ReplicaDriver) -> float:
        return 1.0 if replica.alive() else 0.0

    def _pick_replica(self) -> Optional[ReplicaDriver]:
        with self._lock:
            inflight = dict(self._inflight)
        return pick2(
            self._rng,
            self.replicas,
            weight_fn=self._health,
            load_fn=lambda r: inflight.get(r.name, 0),
        )

    def handle(self, request: Any, browser_origin: bool = False) -> Any:
        if isinstance(request, list):  # pipelined batch
            if len(request) > self.primary.max_batch:
                return {
                    "jsonrpc": "2.0", "id": None,
                    "error": {
                        "code": -32600,
                        "message": f"batch too large "
                        f"(max {self.primary.max_batch})",
                    },
                }
            return [self._route_one(r, browser_origin) for r in request]
        return self._route_one(request, browser_origin)

    def _route_one(self, req: Any, browser_origin: bool) -> Any:
        if not isinstance(req, dict):
            return self.primary.handle(req, browser_origin)
        token_raw = req.get(TOKEN_KEY)
        if token_raw is not None:
            req = {k: v for k, v in req.items() if k != TOKEN_KEY}
        fault_point("fleet.route")
        method = req.get("method", "")
        if method == "eth_sendRawTransaction" and JOURNEY.enabled:
            # the fleet front is the TRUE first sighting for RPC
            # traffic: stamp ingress here (first-wins suppresses the
            # primary service's duplicate) so ingress->durable covers
            # routing + admission time too
            try:
                raw = (req.get("params") or [None])[0]
                stx = SignedTransaction.decode(parse_data(raw))
                JOURNEY.record(stx.hash, "ingress", source="rpc",
                               via="fleet")
            except Exception:
                pass  # a malformed tx fails in the service, not here
        replica: Optional[ReplicaDriver] = None
        is_read = routes_to_replica(method)
        if is_read and self.replicas:
            floor = self._token_floor(ReadToken.decode(token_raw))
            replica = self._pick_replica()
            if (replica is not None and floor is not None
                    and replica.read_view.head_number() < floor):
                # wait-or-redirect: give the tail one RYW budget to
                # catch up, else the primary serves (it always can)
                if not replica.ensure_height(
                    floor, self._serving_cfg.ryw_wait_s
                ):
                    replica = None
                    with self._lock:
                        self.ryw_redirects += 1
        if replica is not None:
            with self._lock:
                self._inflight[replica.name] += 1
            try:
                resp = replica.server.handle(req, browser_origin)
            finally:
                with self._lock:
                    self._inflight[replica.name] -= 1
        else:
            resp = self.primary.handle(req, browser_origin)
        with self._lock:
            if is_read:
                if replica is not None:
                    self.reads_replica += 1
                else:
                    self.reads_primary += 1
                self._read_times.append(time.monotonic())
            else:
                self.forwarded_primary += 1
        if isinstance(resp, dict):
            resp[TOKEN_KEY] = self._mint(replica)
        return resp

    # ------------------------------------------------------- HTTP front

    def start_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Mount the router on the real keep-alive HTTP front (the
        same ThreadingHTTPServer plumbing JsonRpcServer uses)."""
        self._http = _RouterHttpFront(self, host=host, port=port)
        return self._http.start()

    def stop_http(self) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None

    # --------------------------------------------------------- surface

    def reads_per_sec(self) -> float:
        now = time.monotonic()
        with self._lock:
            while (self._read_times
                   and now - self._read_times[0] > _READS_WINDOW_S):
                self._read_times.popleft()
            n = len(self._read_times)
            if n == 0:
                return 0.0
            span = now - self._read_times[0]
        return n / span if span > 0 else float(n)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "readsReplica": self.reads_replica,
                "readsPrimary": self.reads_primary,
                "forwardedPrimary": self.forwarded_primary,
                "rywRedirects": self.ryw_redirects,
                "tokensReanchored": self.tokens_reanchored,
                "lastAncestor": self._last_ancestor,
            }
        out["readsPerSec"] = round(self.reads_per_sec(), 1)
        out["replicas"] = [r.snapshot() for r in self.replicas]
        return out

    def _registry_samples(self) -> list:
        with self._lock:
            samples = [
                ("khipu_fleet_requests_total", "counter",
                 {"route": "replica"}, self.reads_replica),
                ("khipu_fleet_requests_total", "counter",
                 {"route": "primary"},
                 self.reads_primary + self.forwarded_primary),
                ("khipu_fleet_ryw_redirects_total", "counter", {},
                 self.ryw_redirects),
                ("khipu_fleet_tokens_reanchored_total", "counter", {},
                 self.tokens_reanchored),
            ]
        samples.append((
            "khipu_fleet_reads_per_sec", "gauge", {},
            round(self.reads_per_sec(), 2),
        ))
        for r in self.replicas:
            samples.append((
                "khipu_replica_lag_blocks", "gauge",
                {"replica": r.name}, r.lag_blocks(),
            ))
        return samples


class _RouterHttpFront(JsonRpcServer):
    """JsonRpcServer's HTTP machinery (keep-alive, body caps, CORS,
    the served-ms header) with dispatch swapped for the router."""

    def __init__(self, router: FleetRouter, host: str, port: int):
        super().__init__(
            router.primary.service, host=host, port=port,
            max_batch=router.primary.max_batch,
            max_body_bytes=router.primary.max_body_bytes,
        )
        self._router = router

    def handle(self, request: Any, browser_origin: bool = False) -> Any:
        return self._router.handle(request, browser_origin)
