"""The least time one NVIDIA H100 SXM could take for Keccak-256 sponges:
the yardstick of every ``*_roofline`` metric. ``bound_s`` takes the work
as counted (rate blocks absorbed, bytes moved), so rows of mixed lengths
are bounded by the sum of their blocks; the other functions count it for
rows of one length.

The counts are fixed per rate block and per byte and are never read from
a kernel, so they count the same work whatever implements it. Peaks are
the card's at its 700 W limit; the run reports the card's power limit
beside them.
"""

from __future__ import annotations

RATE = 136  # bytes a rate block of Keccak-256
DIGEST = 32
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's H100 SXM data sheet
# INT32 lanes: 64 per SM (Hopper architecture white paper) x 132 SMs x the
# 1.98 GHz boost clock. Logic ops and funnel shifts issue on these lanes.
H100_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit integer operations of one Keccak-f[1600] with three-input LOP3
# folding: theta 80 (column parities 20, D rotations 10, state update
# 50), rho 48 funnel shifts, chi 50 LOP3s, iota 2 -> 180 per round, 24
# rounds; absorbing a 136-byte block adds 34 XORs.
SPONGE_OPS_PER_BLOCK = 180 * 24 + 34


def rate_blocks(length: int) -> int:
    """Blocks a ``length``-byte message absorbs, the pad included."""
    return length // RATE + 1


def bound_s(rate_blocks_absorbed: int, bytes_moved: int):
    """(seconds, "operations" or "bytes"): the least time for sponges
    that absorb ``rate_blocks_absorbed`` rate blocks in all and move
    ``bytes_moved`` bytes."""
    ops_s = rate_blocks_absorbed * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S
    bytes_s = bytes_moved / H100_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def sponge_bound_s(rows: int, length: int, bytes_moved: int):
    """(seconds, "operations" or "bytes"): the least time for ``rows``
    sponges of ``length``-byte messages that move ``bytes_moved`` bytes."""
    return bound_s(rows * rate_blocks(length), bytes_moved)


def hash_bound_s(rows: int, length: int):
    """Digests of ``rows`` rows: each row read once, each digest written
    once."""
    return sponge_bound_s(rows, length, rows * (length + DIGEST))


def verify_bound_s(rows: int, length: int):
    """A verify of ``rows`` rows against their claimed digests: rows and
    claims read once, one count written."""
    return sponge_bound_s(rows, length, rows * (length + DIGEST) + 4)
