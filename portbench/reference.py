"""The benchmark's plain reference: Keccak-256 as Ethereum uses it (the
original Keccak pad, 0x01 ... 0x80), written for the benchmark alone.

It imports nothing of the program under test, so a fault there cannot
hide here. Two forms of one algorithm:

* ``keccak256_np``: NumPy, rows of equal length on the host (a single
  message is one row); the form the published vectors check.
* ``keccak256_rows``: plain PyTorch, rows of equal length on any device,
  in blocks of rows so that it fits beside the program's state.

``rounds`` is the number of Keccak-f[1600] rounds, the last ``rounds``
of the 24 (as Keccak-p in FIPS 202 counts them). 24 is Keccak-256; the
benchmark's control puts the 12-round sponge in the program's place.
"""

from __future__ import annotations

import numpy as np

RATE = 136  # bytes a block of Keccak-256
ROUNDS = 24
DELIM = 0x01  # Keccak's pad; FIPS 202's SHA3-256 uses 0x06


def _round_constants():
    """The 24 iota constants, from the LFSR x^8 + x^6 + x^5 + x^4 + 1."""
    state, out = 1, []
    for _ in range(24):
        rc = 0
        for j in range(7):
            if state & 1:
                rc |= 1 << ((1 << j) - 1)
            state <<= 1
            if state & 0x100:
                state ^= 0x171
        out.append(rc)
    return out


def _rho_pi():
    """For each destination lane X + 5Y: the source lane x + 5y that rho
    and pi move there, and its rotation."""
    rot = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        rot[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    src, amount = [0] * 25, [0] * 25
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            src[dst], amount[dst] = x + 5 * y, rot[x][y]
    return src, amount


RC = _round_constants()
PI_SRC, PI_ROT = _rho_pi()
# chi: lane x + 5y takes ~lane(x+1, y) & lane(x+2, y)
CHI1 = [(x + 1) % 5 + 5 * y for y in range(5) for x in range(5)]
CHI2 = [(x + 2) % 5 + 5 * y for y in range(5) for x in range(5)]
THETA_PREV = [4, 0, 1, 2, 3]
THETA_NEXT = [1, 2, 3, 4, 0]


def _padded(rows: np.ndarray, delim: int) -> np.ndarray:
    n, length = rows.shape
    nblocks = length // RATE + 1
    padded = np.zeros((n, nblocks * RATE), dtype=np.uint8)
    padded[:, :length] = rows
    padded[:, length] ^= delim
    padded[:, -1] ^= 0x80
    return padded


def _rotl_np(v: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def _permute_np(a: np.ndarray, rounds: int) -> np.ndarray:
    """Keccak-p[1600, rounds] over a uint64[25, n] state."""
    for i in range(24 - rounds, 24):
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = c[THETA_PREV] ^ _rotl_np(c[THETA_NEXT], 1)
        a = a ^ np.tile(d, (5, 1))
        b = np.stack([_rotl_np(a[PI_SRC[j]], PI_ROT[j]) for j in range(25)])
        a = b ^ (~b[CHI1] & b[CHI2])
        a[0] ^= np.uint64(RC[i])
    return a


def keccak256_np(rows, rounds: int = ROUNDS, delim: int = DELIM) -> np.ndarray:
    """u8[n, L] (or one ``bytes``) -> u8[n, 32] digests, on the host."""
    if isinstance(rows, (bytes, bytearray)):
        rows = np.frombuffer(bytes(rows), dtype=np.uint8)[None, :]
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n = rows.shape[0]
    lanes = _padded(rows, delim).view("<u8").T
    a = np.zeros((25, n), dtype=np.uint64)
    for blk in range(lanes.shape[0] // 17):
        a[:17] ^= lanes[17 * blk:17 * (blk + 1)]
        a = _permute_np(a, rounds)
    return np.ascontiguousarray(a[:4].T).view(np.uint8)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _torch_tables(torch, device):
    return {
        "src": torch.tensor(PI_SRC, device=device),
        "shl": torch.tensor(PI_ROT, dtype=torch.int64, device=device)[:, None],
        # a logical right shift by 64 - r, as an arithmetic shift and a mask
        "shr": torch.tensor([(64 - r) % 64 for r in PI_ROT],
                            dtype=torch.int64, device=device)[:, None],
        "low": torch.tensor([(1 << r) - 1 for r in PI_ROT],
                            dtype=torch.int64, device=device)[:, None],
        "chi1": torch.tensor(CHI1, device=device),
        "chi2": torch.tensor(CHI2, device=device),
        "prev": torch.tensor(THETA_PREV, device=device),
        "next": torch.tensor(THETA_NEXT, device=device),
    }


def _permute_torch(a, rounds: int, t):
    """Keccak-p[1600, rounds] over an int64[25, n] state (two's
    complement lanes)."""
    for i in range(24 - rounds, 24):
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        n1 = c[t["next"]]
        d = c[t["prev"]] ^ ((n1 << 1) | ((n1 >> 63) & 1))
        a = a ^ d.repeat(5, 1)
        s = a[t["src"]]
        b = (s << t["shl"]) | ((s >> t["shr"]) & t["low"])
        a = b ^ (~b[t["chi1"]] & b[t["chi2"]])
        a[0] ^= _signed(RC[i])
    return a


def keccak256_rows(rows, rounds: int = ROUNDS, block_rows: int = 1 << 20,
                   delim: int = DELIM):
    """u8[n, L] torch rows on any device -> u8[n, 32] digests on that
    device, ``block_rows`` rows at a time."""
    import torch

    n, length = rows.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=rows.device)
    t = _torch_tables(torch, rows.device)
    nblocks = length // RATE + 1
    for lo in range(0, n, block_rows):
        part = rows[lo:lo + block_rows]
        m = part.shape[0]
        padded = torch.zeros((m, nblocks * RATE), dtype=torch.uint8,
                             device=rows.device)
        padded[:, :length] = part
        padded[:, length] ^= delim
        padded[:, -1] ^= 0x80
        lanes = padded.view(torch.int64).t().contiguous()
        del padded
        a = torch.zeros((25, m), dtype=torch.int64, device=rows.device)
        for blk in range(nblocks):
            a[:17] ^= lanes[17 * blk:17 * (blk + 1)]
            a = _permute_torch(a, rounds, t)
        out[lo:lo + m] = a[:4].t().contiguous().view(torch.uint8)
    return out


def mismatches(rows, claims, rounds: int = ROUNDS) -> int:
    """Rows whose digest differs from ``claims`` (u8[n, 32]): the
    reference's snapshot verify."""
    return int((keccak256_rows(rows, rounds) != claims).any(dim=1).sum())
