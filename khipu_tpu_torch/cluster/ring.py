"""Consistent-hash ring: node-hash -> ordered replica set of endpoints.

Parity: DistributedNodeStorage.scala:13-57 shards the node cache by
``hash % numberOfShards`` under Akka cluster sharding; a consistent
ring replaces the modulo so membership changes (a shard dying, a new
one joining) remap only ~1/N of the keyspace instead of all of it —
the property every sharded KV / parameter-server tier relies on for
cheap rebalance.

Each endpoint owns ``vnodes`` points on a 64-bit ring (points are
keccak-derived, so placement is deterministic across processes — every
client computes the same owner for a key with zero coordination).
Lookups walk clockwise from the key's point collecting the first
``replication`` DISTINCT endpoints: the primary plus failover replicas,
in deterministic preference order.

Membership changes swap an immutable snapshot under a lock; readers
never block, so a rebalance cannot drop an in-flight read.

Epoch-fenced transitions (live rebalance, cluster/rebalance.py): every
committed snapshot carries a monotonically increasing ``epoch``.
``begin_transition(members)`` stages the NEXT epoch alongside the
committed one without changing any committed ownership; while the
transition is open, ``write_chains`` returns the union of old and new
owners (writes land in both worlds) and ``read_chain`` tries the new
owners first and falls back to the old — so no read can miss a key
mid-movement regardless of how far the key streaming has progressed.
``commit_transition`` is the atomic cutover; ``abort_transition``
drops the staged epoch and leaves the committed ring exactly as it
was. A direct ``add``/``remove`` (health verdicts) while a transition
is open aborts it first — a membership change invalidates the staged
plan, and the rebalancer notices via the bumped ``transition_aborts``.

The port's copy of ``khipu_tpu.cluster.ring``: the points come from the
host library's Keccak, so placement agrees with the reference key for
key.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from khipu_tpu_torch.base.keccak import keccak256

RING_BITS = 64
RING_SIZE = 1 << RING_BITS


def _point(data: bytes) -> int:
    """64-bit ring coordinate."""
    return int.from_bytes(keccak256(data)[:8], "big")


class RingSnapshot:
    """One immutable epoch of ring state: sorted vnode points, the
    endpoint owning each point, and the member tuple. Lookups on a
    snapshot are lock-free and stable — a rebalance plans against two
    snapshots knowing neither can change underneath it."""

    __slots__ = ("epoch", "members", "replication", "vnodes",
                 "points", "owners")

    def __init__(self, epoch: int, members: Tuple[str, ...],
                 replication: int, vnodes: int):
        self.epoch = epoch
        self.members = members
        self.replication = replication
        self.vnodes = vnodes
        # collisions on the 64-bit ring are vanishingly rare; last
        # writer wins (same tolerance as the pre-epoch ring)
        pairs: Dict[int, str] = {}
        for ep in members:
            for i in range(vnodes):
                pairs[_point(f"{ep}#{i}".encode())] = ep
        self.points = sorted(pairs)
        self.owners = [pairs[p] for p in self.points]

    def chain_at(self, point: int) -> List[str]:
        """Replica chain for a key whose ring coordinate is ``point``:
        first ``replication`` distinct endpoints clockwise. Short-
        circuits at ``len(members)`` distinct endpoints — with fewer
        members than replicas there is nothing more to find, so a
        1-member ring never walks all ``vnodes`` points."""
        points, owners = self.points, self.owners
        if not points:
            return []
        want = min(self.replication, len(self.members))
        idx = bisect.bisect_right(points, point)
        out: List[str] = []
        for i in range(len(points)):
            ep = owners[(idx + i) % len(points)]
            if ep not in out:
                out.append(ep)
                if len(out) == want:
                    break
        return out

    def replicas_for(self, key: bytes) -> List[str]:
        return self.chain_at(_point(key))


class HashRing:
    """Immutable-snapshot consistent-hash ring with virtual nodes."""

    def __init__(
        self,
        endpoints: Sequence[str] = (),
        replication: int = 2,
        vnodes: int = 64,
    ):
        if replication < 1:
            raise ValueError("replication must be >= 1")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.replication = replication
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self.transition_aborts = 0  # implicit aborts via add/remove
        self._next: Optional[RingSnapshot] = None
        self._snap = RingSnapshot(
            1, tuple(dict.fromkeys(endpoints)), replication, vnodes
        )

    # ------------------------------------------------------- membership

    def add(self, endpoint: str) -> bool:
        """Join (or re-join) an endpoint; True if membership changed.
        Aborts any open transition first (the staged plan assumed a
        membership that no longer holds)."""
        with self._lock:
            self._drop_next_locked()
            if endpoint in self._snap.members:
                return False
            self._snap = RingSnapshot(
                self._snap.epoch + 1,
                self._snap.members + (endpoint,),
                self.replication, self.vnodes,
            )
            return True

    def remove(self, endpoint: str) -> bool:
        """Leave the ring; True if membership changed. Aborts any open
        transition first."""
        with self._lock:
            self._drop_next_locked()
            if endpoint not in self._snap.members:
                return False
            self._snap = RingSnapshot(
                self._snap.epoch + 1,
                tuple(m for m in self._snap.members if m != endpoint),
                self.replication, self.vnodes,
            )
            return True

    def _drop_next_locked(self) -> None:
        if self._next is not None:
            self._next = None
            self.transition_aborts += 1

    @property
    def members(self) -> Tuple[str, ...]:
        return self._snap.members

    @property
    def epoch(self) -> int:
        """The COMMITTED epoch — what reads are guaranteed against."""
        return self._snap.epoch

    def __len__(self) -> int:
        return len(self._snap.members)

    # ------------------------------------------------------ transitions

    @property
    def snapshot(self) -> RingSnapshot:
        return self._snap

    @property
    def next_snapshot(self) -> Optional[RingSnapshot]:
        return self._next

    @property
    def in_transition(self) -> bool:
        return self._next is not None

    def begin_transition(
        self, members: Sequence[str]
    ) -> Tuple[RingSnapshot, RingSnapshot]:
        """Stage the next epoch's membership without changing any
        committed ownership. Returns ``(old, new)`` snapshots the
        rebalancer plans against. Only one transition may be open."""
        with self._lock:
            if self._next is not None:
                raise RuntimeError("a ring transition is already open")
            new = RingSnapshot(
                self._snap.epoch + 1,
                tuple(dict.fromkeys(members)),
                self.replication, self.vnodes,
            )
            # set comparison: placement is order-insensitive, so a
            # reordered member list is still a no-op transition
            if set(new.members) == set(self._snap.members):
                raise ValueError("transition changes no membership")
            self._next = new
            return self._snap, new

    def commit_transition(self) -> RingSnapshot:
        """Atomic cutover: the staged epoch becomes the committed one.
        Readers see either entirely-old or entirely-new ownership —
        never a blend."""
        with self._lock:
            if self._next is None:
                raise RuntimeError("no ring transition is open")
            self._snap, self._next = self._next, None
            return self._snap

    def abort_transition(self) -> bool:
        """Drop the staged epoch; the committed ring is untouched.
        True if a transition was actually open."""
        with self._lock:
            if self._next is None:
                return False
            self._next = None
            return True

    # ---------------------------------------------------------- lookups

    def replicas_for(self, key: bytes) -> List[str]:
        """The first ``replication`` distinct endpoints clockwise from
        the key's point in the COMMITTED ring: [primary, replica1,
        ...]. Fewer when the ring holds fewer members; empty on an
        empty ring."""
        return self._snap.replicas_for(key)

    def primary_for(self, key: bytes) -> str:
        owners = self.replicas_for(key)
        if not owners:
            raise LookupError("empty ring")
        return owners[0]

    def read_chain(self, key: bytes) -> List[str]:
        """Replica chain for reads. Mid-transition: new-epoch owners
        first (they may already hold the streamed copy), then the old
        owners (they definitely hold everything the old epoch owned) —
        so a read NEVER misses a key because a rebalance is running.
        Outside a transition this is exactly ``replicas_for``."""
        snap, nxt = self._snap, self._next
        if nxt is None:
            return snap.replicas_for(key)
        pt = _point(key)
        out = nxt.chain_at(pt)
        for ep in snap.chain_at(pt):
            if ep not in out:
                out.append(ep)
        return out

    def write_chains(self, key: bytes) -> List[str]:
        """Replica set for writes. Mid-transition: the union of old and
        new owners — a write lands in both worlds, so neither commit
        nor abort of the transition can lose it. Outside a transition
        this is exactly ``replicas_for``."""
        snap, nxt = self._snap, self._next
        if nxt is None:
            return snap.replicas_for(key)
        pt = _point(key)
        out = snap.chain_at(pt)
        for ep in nxt.chain_at(pt):
            if ep not in out:
                out.append(ep)
        return out
