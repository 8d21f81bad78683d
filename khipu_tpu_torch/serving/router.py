"""Routing policy for the replica fleet: consistent-read tokens,
the read/write method split, and health-weighted pick-2.

Kept separate from :mod:`khipu_tpu_torch.serving.fleet` so the policy is
unit-testable without standing up drivers: everything here is pure
(token codec, method classification) or takes its inputs as plain
callables (the picker).

**Consistent-read tokens.** Every FleetRouter response carries an
opaque ``khipuToken`` — the encoding of ``(chain_id, block_number,
block_hash)`` where ``block_number`` is the highest state height the
serving node vouched for on THIS response and ``block_hash`` anchors
it to a concrete chain (the durable header at that height; writes
mint it from the primary, reads re-mint from whichever node served).
A client that echoes its latest token on the next request gets
session-monotone reads-your-writes across the whole fleet: the router
only routes the read to a replica whose ReadView ``head_number`` has
reached the token height (waiting up to ``ServingConfig.ryw_wait_s``,
else redirecting to the primary and counting the redirect). When a
reorg RETRACTS the token's anchor block, the token re-anchors to the
fork ancestor — the write it certified is no longer on the canonical
chain, so the strongest honest guarantee left is "no older than the
ancestor", which any caught-up replica satisfies.

**Pick-2.** Replica choice is power-of-two-choices weighted by the
``khipu_shard_health`` score the cluster telemetry plane already
computes: draw two distinct candidates with probability proportional
to health, serve from the less-loaded of the two. Weighted sampling
keeps traffic off sick-but-alive replicas; the load tiebreak keeps
one healthy replica from absorbing the whole fleet's reads (the
thundering-herd failure of pure best-of-N).

The port's copy of ``khipu_tpu.serving.router``. Its tokens are
byte-compatible with the reference's: either package decodes the
other's, and the same seed gives the same pick-2.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, TypeVar

# reads a replica can answer from its own store + ReadView. Everything
# else — writes and executes (primary is the write plane), pool-backed
# reads (eth_getTransactionByHash must see the primary's pending set),
# stateful filter methods (filter ids live on the node that minted
# them), khipu_* introspection — routes to the primary.
REPLICA_METHODS = frozenset({
    "eth_blockNumber",
    "eth_call",
    "eth_getBalance",
    "eth_getBlockByHash",
    "eth_getBlockByNumber",
    "eth_getCode",
    "eth_getLogs",
    "eth_getStorageAt",
    "eth_getTransactionCount",
})

# the request/response envelope key the token rides in. Requests carry
# the client's latest token; every routed response carries a fresh one.
TOKEN_KEY = "khipuToken"


@dataclass(frozen=True)
class ReadToken:
    """``(chain_id, block_number, block_hash)`` — opaque on the wire
    (hex of a fixed binary layout), structured in-process."""

    chain_id: int
    number: int
    block_hash: Optional[bytes]  # None: height not yet durable at mint

    def encode(self) -> str:
        h = self.block_hash or b""
        body = (
            self.chain_id.to_bytes(8, "big")
            + self.number.to_bytes(8, "big")
            + h
        )
        return "0x" + body.hex()

    @classmethod
    def decode(cls, raw) -> Optional["ReadToken"]:
        """None on anything malformed — a garbage token downgrades the
        request to tokenless routing instead of erroring it."""
        if not isinstance(raw, str) or not raw.startswith("0x"):
            return None
        try:
            body = bytes.fromhex(raw[2:])
        except ValueError:
            return None
        if len(body) not in (16, 48):
            return None
        return cls(
            chain_id=int.from_bytes(body[:8], "big"),
            number=int.from_bytes(body[8:16], "big"),
            block_hash=body[16:] if len(body) == 48 else None,
        )


def routes_to_replica(method: str) -> bool:
    return method in REPLICA_METHODS


T = TypeVar("T")


def _weighted_pick(rng: random.Random, items: Sequence[T],
                   weights: Sequence[float]) -> T:
    total = sum(weights)
    if total <= 0.0:
        return items[rng.randrange(len(items))]
    r = rng.random() * total
    acc = 0.0
    for item, w in zip(items, weights):
        acc += w
        if r <= acc:
            return item
    return items[-1]


def pick2(
    rng: random.Random,
    candidates: List[T],
    weight_fn: Callable[[T], float],
    load_fn: Callable[[T], float],
) -> Optional[T]:
    """Health-weighted power-of-two-choices. ``weight_fn`` is the
    health score in [0, 1] (zero-weight candidates are excluded
    outright — a dead replica must receive NO traffic, not merely
    less); ``load_fn`` breaks the tie between the two draws, lower
    wins. Returns None when no candidate carries weight."""
    live = [(c, weight_fn(c)) for c in candidates]
    live = [(c, w) for c, w in live if w > 0.0]
    if not live:
        return None
    if len(live) == 1:
        return live[0][0]
    items = [c for c, _ in live]
    weights = [w for _, w in live]
    a = _weighted_pick(rng, items, weights)
    rest = [(c, w) for c, w in live if c is not a]
    b = _weighted_pick(
        rng, [c for c, _ in rest], [w for _, w in rest]
    )
    return a if load_fn(a) <= load_fn(b) else b
