"""Live ring resize: crash-safe shard join/retire with epoch fencing.

Parity target: the Akka cluster-sharding rebalance DistributedNodeStorage
leaned on — shards hand off their entities when membership changes,
while reads keep flowing. Rebuilt here as an explicit three-phase state
machine over the epoch-fenced ring (cluster/ring.py):

1. **plan** — ``begin_transition`` stages the next epoch beside the
   committed one and ``movement_plan`` diffs the two snapshots into the
   exact half-open point ranges whose replica chain changes. Only those
   ranges move: ~1/N of the keyspace for one joining shard, never a
   full reshuffle.
2. **stream** — negotiated by capability (``EngineInfo``): when every
   endpoint on both ends is Kesque-backed, pull raw whole-frame
   segment chunks over ``StreamSegments`` (segments are the unit of
   bulk movement); otherwise pull the owning
   shard's keys in bounded batches over the paged ``StreamNodeData``
   RPC. Either way every value is verified by content address on
   receipt and pushed to each *gaining* owner through the same
   ``put_node_data`` path the anti-entropy backfill uses (the server
   re-verifies before admitting).
   While the transition is open the client writes to BOTH epochs'
   owners and reads new-then-old, so no read can miss a key mid-move.
3. **cutover** — only after every moved range reports ``done`` and
   every push landed does ``commit_transition`` atomically promote the
   next epoch; the configured full ring and the health prober pick up
   the membership change inside the same critical section, so there is
   no crash window between "ring says the shard owns keys" and "the
   rest of the plane knows it exists".

Crash contract (chaos seams ``rebalance.plan`` / ``rebalance.stream``
/ ``rebalance.cutover`` / ``rebalance.retire``): an ``InjectedDeath``
at ANY seam leaves the committed epoch serving — the transition either
never opened, or is still open with the old owners authoritative.
``recover()`` then resumes (re-streams from scratch — both RPCs are
idempotent) when every target member still answers a ping, or rolls
back deterministically, re-recording the keys already streamed as
movement debt via the client's ``_record_missed`` anti-entropy. A
member dying mid-rebalance (a HealthMonitor verdict) aborts the same
way through ``on_membership_event``. Correctness never *depends* on
the recorded debt — a resumed rebalance re-streams everything — the
debt only lets a plain backfill square a partially-streamed shard
that re-joins without a rebalance.

The port's copy of ``khipu_tpu.cluster.rebalance``: the same plans,
placements, stores, counts and segment ship. The receipt-time check
stays the host library's ``keccak256_batch``, as in the reference.

Lock discipline (KL004): ``_lock`` guards state flips only and is
never held across an RPC; the one nested order is
``Rebalancer._lock -> HashRing._lock`` (cutover/abort), and nothing
acquires them in reverse.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.native.keccak import keccak256_batch
from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.cluster.ring import (
    RING_SIZE,
    RingSnapshot,
    _point,
)
from khipu_tpu_torch.observability.profiler import HOST, LEDGER
from khipu_tpu_torch.observability.trace import span

IDLE = "idle"
PLANNING = "planning"
STREAMING = "streaming"
CUTOVER = "cutover"


class RebalanceError(Exception):
    """A rebalance failed and was rolled back to the committed epoch."""


class RebalanceAborted(RebalanceError):
    """The rebalance was aborted (member death, operator, or a failed
    stage); the committed epoch is authoritative and unchanged."""


class MovedRange:
    """One half-open point range ``[lo, hi)`` whose replica chain
    differs between two epochs. ``sources`` is the OLD chain (every
    endpoint guaranteed to hold the range), ``gainers`` the endpoints
    that own it in the new epoch but not the old."""

    __slots__ = ("lo", "hi", "sources", "gainers")

    def __init__(self, lo: int, hi: int, sources: Tuple[str, ...],
                 gainers: Tuple[str, ...]):
        self.lo = lo
        self.hi = hi
        self.sources = sources
        self.gainers = gainers

    def __repr__(self) -> str:  # debugging aid only
        return (f"MovedRange([{self.lo:#x},{self.hi:#x}) "
                f"{self.sources}->{self.gainers})")


def movement_plan(old: RingSnapshot,
                  new: RingSnapshot) -> List[MovedRange]:
    """Diff two ring snapshots into the exact point ranges that change
    ownership. Replica chains are constant between adjacent points of
    the UNION of both snapshots' vnode points, so one representative
    lookup per segment is exact — no key sampling involved."""
    pts = sorted(set(old.points) | set(new.points))
    if not pts:
        return []
    out: List[MovedRange] = []

    def emit(lo: int, hi: int, rep: int) -> None:
        old_chain = old.chain_at(rep)
        new_chain = new.chain_at(rep)
        gainers = tuple(
            ep for ep in new_chain if ep not in old_chain
        )
        if not gainers:
            return
        out.append(MovedRange(lo, hi, tuple(old_chain), gainers))

    for i in range(len(pts) - 1):
        # keys in [pts[i], pts[i+1]) all resolve past pts[i]
        emit(pts[i], pts[i + 1], pts[i])
    # wrap segment: [last, 2^64) and [0, first) share one chain
    emit(pts[-1], RING_SIZE, pts[-1])
    emit(0, pts[0], pts[-1])
    return out


def moved_fraction(plan: Sequence[MovedRange]) -> float:
    """Fraction of the keyspace the plan moves (gauge + docs)."""
    return sum(r.hi - r.lo for r in plan) / RING_SIZE


class Rebalancer:
    """Drives one membership change at a time over a
    ``ShardedNodeClient``. Thread-safe: ``join``/``retire`` run on the
    caller's thread; ``on_membership_event`` (health verdicts) and
    ``abort`` may interrupt from another thread between batches."""

    def __init__(
        self,
        client,
        batch: int = 384,
        pressure: float = 0.88,
        log: Optional[Callable[[str], None]] = None,
    ):
        self.client = client
        self.batch = max(1, batch)
        # segment-ship chunk size (both ends kesque-backed): raw
        # whole-frame bytes per StreamSegments pull
        self.chunk_bytes = 1 << 20
        self._pressure = pressure
        self.log = log or (lambda s: None)
        self._lock = threading.Lock()
        self.state = IDLE
        # one pending operation: ("join"|"retire", endpoint, targets)
        self._pending: Optional[Tuple[str, str, Tuple[str, ...]]] = None
        self._abort_reason: Optional[str] = None
        # keys already pushed per gaining endpoint THIS attempt — the
        # abort path re-records them as anti-entropy debt
        self._streamed: Dict[str, Set[bytes]] = {}
        self.keys_streamed = 0  # cumulative, the watchdog progress gauge
        self.keys_placed = 0  # (key, gainer) placements that landed
        self.completed = 0
        self.aborts = 0
        self.segment_chunks = 0  # raw chunks moved by segment-ship
        self.last_moved_fraction = 0.0
        client.attach_rebalancer(self)
        try:
            from khipu_tpu_torch.observability.registry import REGISTRY

            REGISTRY.register_collector(
                "rebalance", self._registry_samples
            )
        except Exception:
            pass

    # ------------------------------------------------------- operations

    def join(self, endpoint: str) -> int:
        """Add ``endpoint`` to the serving membership: stage the next
        epoch, stream the ranges it gains, cut over atomically.
        Returns the number of keys streamed. Raises
        ``RebalanceAborted``/``RebalanceError`` with the committed
        epoch intact on any failure."""
        ring = self.client.ring
        if endpoint in ring.members:
            raise ValueError(f"{endpoint} is already a ring member")
        targets = tuple(ring.members) + (endpoint,)
        self._begin("join", endpoint, targets)
        # breaker/metrics/channel so _call can reach the new shard;
        # health tracking waits for cutover (a probe-driven ring.add
        # of a half-streamed shard would bypass the fence)
        self.client.admit_endpoint(endpoint)
        return self._drive()

    def retire(self, endpoint: str) -> int:
        """Remove ``endpoint`` from the serving membership: stream the
        ranges the survivors gain FROM it, cut over, then drop it from
        the configured ring and the health prober. Returns keys
        streamed."""
        fault_point("rebalance.retire")
        ring = self.client.ring
        if endpoint not in ring.members:
            raise ValueError(f"{endpoint} is not a ring member")
        if len(ring.members) < 2:
            raise ValueError("cannot retire the last member")
        targets = tuple(
            m for m in ring.members if m != endpoint
        )
        self._begin("retire", endpoint, targets)
        return self._drive()

    def recover(self) -> str:
        """Settle a rebalance a crash (or an abort signal with no
        driving thread) left mid-flight. Deterministic: resumes —
        re-streaming from scratch, both RPCs are idempotent — when
        every target member answers a ping, rolls back to the
        committed epoch otherwise. Returns ``"idle"``, ``"resumed"``
        or ``"rolled_back"``."""
        with self._lock:
            pending = self._pending
            if pending is None:
                return IDLE
            self._abort_reason = None
        ring = self.client.ring
        if not ring.in_transition:
            # died before begin_transition (rebalance.plan seam) or a
            # health verdict already dropped the staged epoch: nothing
            # moved ownership, so rolling back is pure bookkeeping
            self._finish_abort("recover: no transition open")
            return "rolled_back"
        targets = ring.next_snapshot.members
        if all(self.client.ping(m) for m in targets):
            self.log(f"rebalance: resuming {pending[0]} {pending[1]}")
            self._drive()
            return "resumed"
        self._abort("recover: target member unreachable")
        self._finish_abort("recover: target member unreachable")
        return "rolled_back"

    def abort(self, reason: str = "operator") -> bool:
        """Roll back an in-flight rebalance to the committed epoch.
        Safe from any thread; True when a rebalance was actually
        aborted."""
        return self._abort(reason)

    # ----------------------------------------------------- health hook

    def on_membership_event(self, endpoint: str, alive: bool) -> None:
        """Called by the client BEFORE a mark_dead/mark_alive mutates
        the ring: any membership change under an open transition
        invalidates the staged plan, so abort back to the committed
        epoch (the next join/retire re-plans against reality)."""
        ring = self.client.ring
        if not ring.in_transition and self._pending is None:
            return
        verdict = "died" if not alive else "re-joined"
        self._abort(f"member {endpoint} {verdict} mid-rebalance")

    # -------------------------------------------------------- internals

    def _begin(self, kind: str, endpoint: str,
               targets: Tuple[str, ...]) -> None:
        with self._lock:
            if self._pending is not None:
                raise RuntimeError(
                    f"a rebalance is already in flight: {self._pending}"
                )
            self._pending = (kind, endpoint, targets)
            self._abort_reason = None
            self._streamed = {}
            self.state = PLANNING

    def _drive(self) -> int:
        """Plan + stream + cutover for the pending operation. Any
        plain Exception rolls back and re-raises as RebalanceError;
        InjectedDeath (BaseException) propagates untouched — that IS
        the crash the recover() contract covers."""
        kind, endpoint, targets = self._pending
        ring = self.client.ring
        try:
            with span("rebalance", kind=kind, endpoint=endpoint):
                if ring.in_transition:
                    old, new = ring.snapshot, ring.next_snapshot
                else:
                    fault_point("rebalance.plan")
                    old, new = ring.begin_transition(targets)
                plan = movement_plan(old, new)
                self.last_moved_fraction = moved_fraction(plan)
                self.log(
                    f"rebalance: {kind} {endpoint} epoch "
                    f"{old.epoch}->{new.epoch}, "
                    f"{len(plan)} ranges, "
                    f"{self.last_moved_fraction:.3f} of keyspace"
                )
                with self._lock:
                    self._check_abort()
                    self.state = STREAMING
                streamed = self._stream(plan, old, new)
                self._cutover(kind, endpoint)
                return streamed
        except RebalanceAborted as e:
            self._finish_abort(str(e))
            raise
        except Exception as e:
            self._abort(f"{type(e).__name__}: {e}")
            self._finish_abort(str(e))
            raise RebalanceError(
                f"rebalance {kind} {endpoint} failed: {e}"
            ) from e

    def _check_abort(self) -> None:
        """Caller holds ``_lock``."""
        if self._abort_reason is not None:
            raise RebalanceAborted(self._abort_reason)

    def _stream(self, plan: List[MovedRange], old: RingSnapshot,
                new: RingSnapshot) -> int:
        """Move every planned range, picking the transport by
        capability negotiation: when EVERY endpoint on both ends of
        the plan (losing sources and gaining owners) reports the
        kesque engine, ship raw verified segments in bulk; otherwise
        — or if the bulk path fails mid-flight — fall back to the
        paged ``StreamNodeData`` walk. Both transports are idempotent
        (content-addressed pushes), so a half-done segment-ship
        attempt followed by a paged pass still lands exactly the
        planned keys — a mixed-backend join can only ever commit at
        the old or the new epoch, never in between."""
        endpoints = sorted(
            {ep for r in plan for ep in r.sources}
            | {ep for r in plan for ep in r.gainers}
        )
        if plan and self._all_kesque(endpoints):
            try:
                return self._stream_segment_ship(plan, old, new)
            except RebalanceAborted:
                raise
            except Exception as e:
                self.log(
                    f"rebalance: segment-ship failed "
                    f"({type(e).__name__}: {e}); falling back to "
                    "paged StreamNodeData"
                )
        return self._stream_paged(plan, old, new)

    def _all_kesque(self, endpoints: List[str]) -> bool:
        """Capability probe: True iff every endpoint answers
        ``EngineInfo`` with the kesque engine. Any probe failure (old
        peer without the RPC, unreachable shard) means "negotiate
        down" — never "fail the rebalance"."""
        probe = getattr(self.client, "engine_info", None)
        if probe is None:
            return False
        for ep in endpoints:
            try:
                name, _manifest = probe(ep)
            except Exception:
                return False
            if name != "kesque":
                return False
        return True

    def _stream_segment_ship(self, plan: List[MovedRange],
                             old: RingSnapshot,
                             new: RingSnapshot) -> int:
        """The bulk transport: pull raw whole-frame chunks of every
        source segment, recompute each record's content address (the
        keccak IS the key — receipt-time verification, same argument
        as the paged path's check), keep the keys inside the moved
        ranges, and place them to the gaining owners. No per-key
        cursor walk on the source: the segment manifest is the whole
        work list, and a chunk is a single sequential read."""
        from khipu_tpu_torch.storage.kesque import TAG_NODE, decode_record
        from khipu_tpu_torch.storage.segment import scan_frames

        by_chain: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
        for r in plan:
            by_chain.setdefault(r.sources, []).append((r.lo, r.hi))
        streamed = 0
        for chain, ranges in sorted(by_chain.items()):
            source, manifest = self._segment_manifest(chain)
            for topic, seq, _size in manifest:
                offset, done = 0, False
                while not done:
                    with self._lock:
                        self._check_abort()
                    fault_point("rebalance.stream")
                    t0 = time.perf_counter()
                    raw, offset, done = self.client.stream_segments(
                        source, topic, seq, offset, self.chunk_bytes
                    )
                    if not raw:
                        break
                    frames, end = scan_frames(raw)
                    if end != len(raw):
                        # a chunk is whole frames by contract: short
                        # scan = corruption in flight
                        raise RebalanceError(
                            f"corrupt segment chunk from {source} "
                            f"({topic}/{seq}@{offset})"
                        )
                    values = []
                    for _off, payload in frames:
                        tag, _k, value = decode_record(payload)
                        if tag != TAG_NODE or not value:
                            continue  # only node records move
                        values.append(value)
                    pairs = []
                    # one native batch hash per chunk: the recomputed
                    # address is both the key and the receipt check
                    for h, value in zip(keccak256_batch(values), values):
                        pt = _point(h)
                        if any(lo <= pt < hi for lo, hi in ranges):
                            pairs.append((h, value))
                    self.segment_chunks += 1
                    LEDGER.record("kesque.ship", HOST, len(raw),
                                  duration=time.perf_counter() - t0)
                    if pairs:
                        streamed += len(pairs)
                        self.keys_streamed += len(pairs)
                        self._place(pairs, old, new)
        return streamed

    def _segment_manifest(self, chain: Tuple[str, ...]):
        """``(source, [(topic, seq, size), ...])`` from the first
        chain replica that answers as kesque-backed."""
        last: Optional[Exception] = None
        for source in chain:
            try:
                name, manifest = self.client.engine_info(source)
            except Exception as e:
                last = e
                continue
            if name == "kesque":
                return source, manifest
        raise RebalanceError(
            f"no kesque source replica in {chain}: {last}"
        )

    def _stream_paged(self, plan: List[MovedRange], old: RingSnapshot,
                      new: RingSnapshot) -> int:
        """The portable transport: pull every moved range from a
        current owner cursor-paged and push it to the gaining owners.
        Raises on the first batch that cannot be completed — partial
        movement never cuts over."""
        streamed = 0
        # one cursor walk per distinct source chain: each shard is
        # asked once for all the ranges it is losing
        by_chain: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
        for r in plan:
            by_chain.setdefault(r.sources, []).append((r.lo, r.hi))
        for chain, ranges in sorted(by_chain.items()):
            cursor = b""
            while True:
                with self._lock:
                    self._check_abort()
                fault_point("rebalance.stream")
                done, cursor, pairs = self._pull(
                    chain, ranges, cursor
                )
                if pairs:
                    streamed += len(pairs)
                    self.keys_streamed += len(pairs)
                    self._place(pairs, old, new)
                if done:
                    break
        return streamed

    def _pull(self, chain: Tuple[str, ...],
              ranges: List[Tuple[int, int]], cursor: bytes):
        """One StreamNodeData batch from the first source replica that
        answers; every value is verified by content address before it
        is accepted — a corrupt stream aborts the rebalance rather
        than silently dropping (or worse, forwarding) a key."""
        last: Optional[Exception] = None
        for source in chain:
            try:
                done, nxt, pairs = self.client.stream_node_data(
                    source, ranges, cursor, self.batch
                )
            except Exception as e:
                last = e
                continue
            for h, v in pairs:
                if keccak256(v) != h:
                    raise RebalanceError(
                        f"corrupt stream from {source}: "
                        f"value does not match {h.hex()[:16]}"
                    )
            return done, nxt, pairs
        raise RebalanceError(
            f"no source replica in {chain} could stream: {last}"
        )

    def _place(self, pairs, old: RingSnapshot,
               new: RingSnapshot) -> None:
        """Route a verified batch to each key's gaining owners."""
        per_gainer: Dict[str, Dict[bytes, bytes]] = {}
        for h, v in pairs:
            pt = _point(h)
            old_chain = old.chain_at(pt)
            for ep in new.chain_at(pt):
                if ep not in old_chain:
                    per_gainer.setdefault(ep, {})[h] = v
        for ep, batch in sorted(per_gainer.items()):
            self.client.push_nodes(ep, batch)
            self.keys_placed += len(batch)
            self._streamed.setdefault(ep, set()).update(batch)

    def _cutover(self, kind: str, endpoint: str) -> None:
        fault_point("rebalance.cutover")
        client = self.client
        with self._lock:
            self._check_abort()
            self.state = CUTOVER
            committed = client.ring.commit_transition()
            # post-commit bookkeeping inside the same critical
            # section: no seam between "the ring cut over" and "the
            # full ring / prober agree", so a crash can never observe
            # the halfway state
            if kind == "join":
                client._full_ring.add(endpoint)
            else:
                client._full_ring.remove(endpoint)
            self._pending = None
            self._streamed = {}
            self.state = IDLE
            self.completed += 1
        health = getattr(client, "_health", None)
        if kind == "join":
            if health is not None:
                health.track(endpoint)
        else:
            if health is not None:
                health.untrack(endpoint)
            client.forget_endpoint(endpoint)
        self.log(
            f"rebalance: {kind} {endpoint} committed epoch "
            f"{committed.epoch}"
        )

    def _abort(self, reason: str) -> bool:
        """Flag the abort and drop the staged epoch. The driving
        thread (if any) unwinds at its next ``_check_abort``; with no
        driving thread, ``recover()`` finishes the bookkeeping."""
        with self._lock:
            if self._pending is None:
                return False
            if self._abort_reason is None:
                self._abort_reason = reason
            self.client.ring.abort_transition()
        self.log(f"rebalance: aborting ({reason})")
        return True

    def _finish_abort(self, reason: str) -> None:
        """Roll-back bookkeeping: committed epoch stays authoritative;
        the keys already streamed become anti-entropy debt so a later
        plain backfill can square a half-copied shard."""
        with self._lock:
            pending, self._pending = self._pending, None
            streamed, self._streamed = self._streamed, {}
            self._abort_reason = None
            self.state = IDLE
            self.aborts += 1
        self.client.ring.abort_transition()
        for ep, keys in sorted(streamed.items()):
            if keys:
                self.client._record_missed(ep, sorted(keys))
        if pending is not None and pending[0] == "join":
            # the half-streamed shard never became a member: drop its
            # channel; breaker/metrics history is harmless to keep
            self.client._drop_channel(pending[1])
        self.log(f"rebalance: rolled back ({reason})")

    # ---------------------------------------------------- observability

    @property
    def in_transition(self) -> bool:
        return self.client.ring.in_transition or self._pending is not None

    def pressure(self) -> float:
        """Admission pressure while a transition epoch is open: high
        enough to shed writes (a transfer storm must not be amplified
        by user writes doubling into both epochs) while cheap reads
        keep flowing. Zero when idle — the signal costs nothing."""
        return self._pressure if self.in_transition else 0.0

    def watch_source(self) -> Tuple[bool, int]:
        """(transition open, progress) for the ``rebalance_stuck``
        watchdog: open + flat progress for stall_after_s = a wedge."""
        return self.in_transition, self.keys_streamed

    def status(self) -> dict:
        ring = self.client.ring
        return {
            "state": self.state,
            "epoch": ring.epoch,
            "inTransition": ring.in_transition,
            "pending": (
                {"kind": self._pending[0],
                 "endpoint": self._pending[1]}
                if self._pending else None
            ),
            "keysStreamed": self.keys_streamed,
            "keysPlaced": self.keys_placed,
            "segmentChunks": self.segment_chunks,
            "completed": self.completed,
            "aborts": self.aborts,
            "lastMovedFraction": round(self.last_moved_fraction, 6),
        }

    def _registry_samples(self) -> list:
        ring = self.client.ring
        return [
            ("khipu_rebalance_epoch", "gauge", {}, ring.epoch),
            ("khipu_rebalance_in_transition", "gauge", {},
             int(ring.in_transition)),
            ("khipu_rebalance_keys_streamed_total", "counter", {},
             self.keys_streamed),
            ("khipu_rebalance_keys_placed_total", "counter", {},
             self.keys_placed),
            ("khipu_rebalance_segment_chunks_total", "counter", {},
             self.segment_chunks),
            ("khipu_rebalance_completed_total", "counter", {},
             self.completed),
            ("khipu_rebalance_aborts_total", "counter", {},
             self.aborts),
            ("khipu_rebalance_moved_fraction", "gauge", {},
             round(self.last_moved_fraction, 6)),
        ]
