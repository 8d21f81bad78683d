"""Seeded workloads of the state-root pipeline.

Shared by ``chip_smoke.py`` and ``scripts/torch_profile.py`` so both
drive the same data:

* ``genesis_pairs`` — the mainnet genesis alloc as state-trie pairs.
* ``fresh_state_pairs`` — BASELINE config #3: ``n`` accounts keyed
  ``address_key(i.to_bytes(20))`` holding ``Account(0, 10**18 + i)``.
* ``TransferBlocks`` — blocks of account writes over a state, in the
  shape of ~200 value transfers per block (sender nonce + 1 and both
  balances change) plus a few new accounts.

Addresses are hashed in one batch on ``device`` (K1 on the card).
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np

from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.ops.keccak import keccak256_fixed

Pairs = List[Tuple[bytes, bytes]]


def _hash_addresses(addrs: np.ndarray, device) -> List[bytes]:
    digests = keccak256_fixed(addrs, device=device).cpu().numpy()
    return [digests[i].tobytes() for i in range(digests.shape[0])]


def genesis_pairs(path: str, device=None) -> Pairs:
    """``path``: a gzip text file of ``<address hex> <balance>`` lines."""
    with gzip.open(path, "rt") as f:
        alloc = [line.split() for line in f]
    addrs = np.frombuffer(
        b"".join(bytes.fromhex(a) for a, _ in alloc), np.uint8
    ).reshape(-1, 20)
    keys = _hash_addresses(addrs, device)
    return [(k, Account(0, int(bal)).encode()) for k, (_, bal) in zip(keys, alloc)]


def fresh_state_pairs(n: int, device=None) -> Pairs:
    addrs = np.zeros((n, 20), np.uint8)
    addrs[:, 12:] = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    keys = _hash_addresses(addrs, device)
    return [(k, Account(0, 10**18 + i).encode()) for i, k in enumerate(keys)]


class TransferBlocks:
    """Blocks of account writes over the state ``pairs``. Each call of
    ``next`` returns one block's ``{key: account rlp}``: ``(writes -
    new_accounts) // 2`` transfers between distinct existing accounts,
    then ``new_accounts`` fresh accounts. Accounts are decoded when first
    touched."""

    GAS_COST = 21_000 * 10**9  # a plain transfer at 1 gwei

    def __init__(self, pairs: Pairs, rng: np.random.Generator):
        self.rng = rng
        self.keys = [k for k, _ in pairs]
        self._raw = dict(pairs)
        self._state: Dict[bytes, Account] = {}
        self.blocks = 0

    def _account(self, key: bytes) -> Account:
        acct = self._state.get(key)
        if acct is None:
            acct = self._state[key] = Account.decode(self._raw[key])
        return acct

    def next(self, writes: int = 400, new_accounts: int = 20) -> Dict[bytes, bytes]:
        n_transfers = (writes - new_accounts) // 2
        picks = self.rng.choice(len(self.keys), size=2 * n_transfers,
                                replace=False)
        out: Dict[bytes, bytes] = {}
        for j in range(n_transfers):
            snd = self.keys[picks[2 * j]]
            rcv = self.keys[picks[2 * j + 1]]
            value = int(self.rng.integers(1, 10**12))
            s = self._account(snd)
            s = Account(s.nonce + 1, s.balance - value - self.GAS_COST,
                        s.storage_root, s.code_hash)
            r = self._account(rcv).increase_balance(value)
            self._state[snd], self._state[rcv] = s, r
            out[snd], out[rcv] = s.encode(), r.encode()
        for j in range(new_accounts):
            k = address_key(b"new" + self.blocks.to_bytes(8, "big")
                            + j.to_bytes(9, "big"))
            self.keys.append(k)
            self._state[k] = Account(0, 10**18 + j)
            out[k] = self._state[k].encode()
        self.blocks += 1
        return out
