"""Gameday invariant checkers (docs/gameday.md).

The port's copy of ``khipu_tpu.chaos.invariants``.

The reusable half of the gameday harness: every checker takes live
objects (blockchains, replicas, the fleet router, a rebalancer) plus
the run's observations and returns an ``InvariantResult`` — named,
machine-checkable, and identical whether it gates the headline
``bench.py --gameday`` run, one cell of the pairwise hazard matrix
(tests/test_gameday.py), or an ad-hoc chaos experiment.

The invariant set is the paper's operational contract under
composition:

* ``ryw``          — zero read-your-writes violations across failover
  AND retraction (the loadgen's built-in checker is the witness).
* ``retraction``   — a reorg-retracted block is retracted from EVERY
  serving replica's view, and each replica's chain is a hash-exact
  prefix of the primary's canonical chain.
* ``token_floor``  — consistent-read tokens anchor to the canonical
  chain; a token whose anchor was retracted re-anchors monotonically
  DOWN to the fork ancestor, never to a phantom height above it.
* ``epoch``        — the shard ring lands at exactly the old or the
  new epoch (never a torn intermediate) once recovery has run.
* ``roots``        — final state roots and header hashes are
  bit-exact against a fresh serial replay of the same blocks.
* ``admission_p99``— p99 latency of ADMITTED requests stays within
  budget (default 5x the unloaded floor): overload sheds, it does not
  queue into the latency tail.

``record_run`` aggregates per-run outcomes into the module's
``khipu_gameday_*`` registry families so a gameday leaves the same
metrics audit trail as every other subsystem.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from khipu_tpu_torch.observability.registry import REGISTRY

__all__ = [
    "InvariantResult",
    "InvariantReport",
    "check_ryw",
    "check_retraction",
    "check_token_floor",
    "check_epoch",
    "check_roots_bit_exact",
    "check_admission_p99",
    "record_run",
    "gameday_stats",
]


@dataclass(frozen=True)
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def __bool__(self) -> bool:
        return self.ok


class InvariantReport:
    """Collects results; ``ok`` only when every check passed. ``raise_
    if_failed`` is the gate half (bench exits non-zero), ``failures``
    the test half (assert not report.failures)."""

    def __init__(self):
        self.results: List[InvariantResult] = []

    def add(self, result: InvariantResult) -> InvariantResult:
        self.results.append(result)
        return result

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def failures(self) -> List[InvariantResult]:
        return [r for r in self.results if not r.ok]

    def summary(self) -> Dict[str, bool]:
        return {r.name: r.ok for r in self.results}

    def raise_if_failed(self) -> None:
        if not self.ok:
            lines = "; ".join(
                f"{r.name}: {r.detail or 'failed'}" for r in self.failures
            )
            raise AssertionError(f"gameday invariants violated — {lines}")


# ------------------------------------------------------------- checkers


def check_ryw(violations: Sequence) -> InvariantResult:
    """Zero read-your-writes violations. ``violations`` is
    ``LoadReport.violations`` — the loadgen's per-client monotonicity
    and pending-visibility checker already spans failover and
    retraction, so an empty list IS the invariant."""
    return InvariantResult(
        "ryw", len(violations) == 0,
        "" if not violations else f"{len(violations)} violation(s): "
        f"{violations[:3]}",
    )


def check_retraction(primary_bc, replicas: Iterable,
                     retracted: Sequence[Tuple[int, bytes]],
                     ) -> InvariantResult:
    """Every (number, old_hash) the fork battle retracted must be gone
    from every serving replica, and each replica's chain must be a
    hash-exact prefix of the primary's canonical chain (a replica that
    kept a phantom block would serve reads no canonical node ever
    could). Dead replicas are skipped — they serve nothing."""
    problems: List[str] = []
    for rep in replicas:
        if not rep.alive():
            continue
        bc = rep.blockchain
        for number, old_hash in retracted:
            header = bc.get_header_by_number(number)
            if header is not None and header.hash == old_hash:
                problems.append(
                    f"{rep.name}: retracted block {number} still served"
                )
        top = min(bc.best_block_number, primary_bc.best_block_number)
        for number in range(top + 1):
            mine = bc.get_header_by_number(number)
            theirs = primary_bc.get_header_by_number(number)
            if mine is None or theirs is None or mine.hash != theirs.hash:
                problems.append(
                    f"{rep.name}: diverges from primary at {number}"
                )
                break
    return InvariantResult(
        "retraction", not problems, "; ".join(problems[:4]),
    )


def check_token_floor(router, retracted: Sequence[Tuple[int, bytes]],
                      ancestor: Optional[int]) -> InvariantResult:
    """Tokens anchor honestly after the fork battle: a freshly minted
    primary token must sit ON the canonical chain, and a token bearing
    a retracted (number, hash) must floor at or below the fork
    ancestor — the strongest honest promise left once its block is
    gone. Asserting via the router's own ``_token_floor`` checks the
    exact code path every routed read takes."""
    from khipu_tpu_torch.serving.router import ReadToken

    bc = router.primary.service.blockchain
    tok = ReadToken.decode(router._mint(None))
    if tok is None:
        return InvariantResult("token_floor", False, "mint undecodable")
    header = bc.get_header_by_number(tok.number)
    if header is None or (tok.block_hash
                          and header.hash != tok.block_hash):
        return InvariantResult(
            "token_floor", False,
            f"minted token anchors off-chain at {tok.number}",
        )
    for number, old_hash in retracted:
        stale = ReadToken(router.chain_id, number, old_hash)
        floor = router._token_floor(stale)
        limit = ancestor if ancestor is not None else bc.best_block_number
        if floor is None or floor > min(number, limit):
            return InvariantResult(
                "token_floor", False,
                f"retracted token @{number} floored at {floor}, "
                f"ancestor {ancestor}",
            )
    return InvariantResult("token_floor", True)


def check_epoch(rebalancer, old_epoch: int,
                new_epoch: int) -> InvariantResult:
    """Exactly-old-or-new: after recovery the committed ring epoch is
    one of the two legal landing points and no transition is still
    staged — a torn intermediate epoch means a reader could see a
    placement neither plan ever promised."""
    status = rebalancer.status()
    epoch = status["epoch"]
    if rebalancer.in_transition:
        return InvariantResult(
            "epoch", False, f"still in transition at epoch {epoch}",
        )
    ok = epoch in (old_epoch, new_epoch)
    return InvariantResult(
        "epoch", ok,
        "" if ok else
        f"epoch {epoch} is neither old {old_epoch} nor new {new_epoch}",
    )


def check_roots_bit_exact(bc, reference_bc) -> InvariantResult:
    """Final convergence: same best number, and every header's hash
    AND state root bit-exact against a fresh serial replay
    (``reference_bc``) of the canonical blocks. This is the invariant
    that catches a hazard corrupting state while every serving-plane
    check still passes."""
    best, ref_best = bc.best_block_number, reference_bc.best_block_number
    if best != ref_best:
        return InvariantResult(
            "roots", False, f"best {best} != reference {ref_best}",
        )
    for number in range(best + 1):
        mine = bc.get_header_by_number(number)
        ref = reference_bc.get_header_by_number(number)
        if mine is None or ref is None:
            return InvariantResult(
                "roots", False, f"missing header at {number}",
            )
        if mine.hash != ref.hash:
            return InvariantResult(
                "roots", False, f"hash mismatch at {number}",
            )
        if mine.state_root != ref.state_root:
            return InvariantResult(
                "roots", False, f"state root mismatch at {number}",
            )
    return InvariantResult("roots", True)


def check_admission_p99(p99_ms: float, floor_p99_ms: float,
                        budget: float = 5.0) -> InvariantResult:
    """Admitted-request p99 within ``budget`` x the unloaded floor.
    Overload is survived by SHEDDING (-32005), so what the admission
    controller lets through must still be fast."""
    limit = floor_p99_ms * budget
    ok = p99_ms <= limit
    return InvariantResult(
        "admission_p99", ok,
        "" if ok else
        f"p99 {p99_ms:.2f}ms > {budget:.1f}x floor "
        f"({floor_p99_ms:.2f}ms -> limit {limit:.2f}ms)",
    )


# --------------------------------------------------- registry families


class _GamedayStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.runs = 0
        self.events_by_kind: Dict[str, int] = {}
        self.checks_by_invariant: Dict[str, int] = {}
        self.failures_by_invariant: Dict[str, int] = {}
        self.last_p99_ms = 0.0

    def record(self, events_by_kind: Dict[str, int],
               report: InvariantReport,
               p99_ms: Optional[float] = None) -> None:
        with self._lock:
            self.runs += 1
            for kind, n in events_by_kind.items():
                self.events_by_kind[kind] = (
                    self.events_by_kind.get(kind, 0) + n
                )
            for r in report.results:
                self.checks_by_invariant[r.name] = (
                    self.checks_by_invariant.get(r.name, 0) + 1
                )
                if not r.ok:
                    self.failures_by_invariant[r.name] = (
                        self.failures_by_invariant.get(r.name, 0) + 1
                    )
            if p99_ms is not None:
                self.last_p99_ms = float(p99_ms)

    def samples(self) -> list:
        with self._lock:
            out = [
                ("khipu_gameday_runs_total", "counter", {}, self.runs),
                ("khipu_gameday_last_p99_ms", "gauge", {},
                 self.last_p99_ms),
            ]
            for kind, n in sorted(self.events_by_kind.items()):
                out.append((
                    "khipu_gameday_events_total", "counter",
                    {"kind": kind}, n,
                ))
            for name, n in sorted(self.checks_by_invariant.items()):
                out.append((
                    "khipu_gameday_invariant_checks_total", "counter",
                    {"invariant": name}, n,
                ))
                out.append((
                    "khipu_gameday_invariant_failures_total", "counter",
                    {"invariant": name},
                    self.failures_by_invariant.get(name, 0),
                ))
            return out


_STATS = _GamedayStats()


def record_run(events_by_kind: Dict[str, int], report: InvariantReport,
               p99_ms: Optional[float] = None) -> None:
    """Fold one completed gameday run into the khipu_gameday_*
    registry families."""
    _STATS.record(events_by_kind, report, p99_ms)


def gameday_stats() -> _GamedayStats:
    return _STATS


REGISTRY.register_collector("gameday", _STATS.samples)
