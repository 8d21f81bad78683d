"""Seeded workloads of the state-root pipeline.

Shared by ``chip_smoke.py`` and ``scripts/torch_profile.py`` so both
drive the same data:

* ``genesis_pairs`` — the mainnet genesis alloc as state-trie pairs.
* ``fresh_state_pairs`` — BASELINE config #3: ``n`` accounts keyed
  ``address_key(i.to_bytes(20))`` holding ``Account(0, 10**18 + i)``.
* ``TransferBlocks`` — blocks of account writes over a state, in the
  shape of ~200 value transfers per block (sender nonce + 1 and both
  balances change) plus a few new accounts.
* ``contract_snapshot`` — BASELINE config #5's source state: a state
  whose every ``CONTRACT_EVERY``-th account is a contract with a storage
  trie and a code blob, as the three node stores a fast sync downloads.

Addresses and slots are hashed in one batch on ``device`` (K1f on the
card).
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np

from khipu_tpu_torch.base.rlp import rlp_encode_int
from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.ops.keccak import keccak256_batch, keccak256_fixed

Pairs = List[Tuple[bytes, bytes]]

# contract_snapshot's shape: one contract per 100 accounts, each with a
# 64-slot storage trie and a 2,048 B code blob (16 rate blocks)
CONTRACT_EVERY = 100
CONTRACT_SLOTS = 64
CODE_BYTES = 2048


def _hash_rows(addrs: np.ndarray, device) -> List[bytes]:
    digests = keccak256_fixed(addrs, device=device).cpu().numpy()
    return [digests[i].tobytes() for i in range(digests.shape[0])]


def genesis_pairs(path: str, device=None) -> Pairs:
    """``path``: a gzip text file of ``<address hex> <balance>`` lines."""
    with gzip.open(path, "rt") as f:
        alloc = [line.split() for line in f]
    addrs = np.frombuffer(
        b"".join(bytes.fromhex(a) for a, _ in alloc), np.uint8
    ).reshape(-1, 20)
    keys = _hash_rows(addrs, device)
    return [(k, Account(0, int(bal)).encode()) for k, (_, bal) in zip(keys, alloc)]


def fresh_state_pairs(n: int, device=None) -> Pairs:
    addrs = np.zeros((n, 20), np.uint8)
    addrs[:, 12:] = np.arange(n, dtype=">u8").view(np.uint8).reshape(n, 8)
    keys = _hash_rows(addrs, device)
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


def contract_snapshot(pairs: Pairs, rng: np.random.Generator, device=None):
    """The state of ``pairs`` with every ``CONTRACT_EVERY``-th account
    made a contract: storage slots ``keccak(slot.to_bytes(32))`` ->
    ``rlp(slot + 1)`` (one storage trie, shared) and a ``CODE_BYTES``
    blob drawn from ``rng``. Built with the fused bulk build on
    ``device``. Returns ``(root, [state nodes, storage nodes, code
    blobs])``, each ``{hash: bytes}``."""
    from khipu_tpu_torch.trie.bulk import bulk_build

    slots = CONTRACT_SLOTS
    slot_rows = np.zeros((slots, 32), np.uint8)
    slot_rows[:, 24:] = (np.arange(slots, dtype=">u8").view(np.uint8)
                         .reshape(slots, 8))
    slot_pairs = [(k, rlp_encode_int(i + 1))
                  for i, k in enumerate(_hash_rows(slot_rows, device))]
    storage_root, storage_nodes = bulk_build(slot_pairs, fused=True,
                                             device=device)
    contracts = range(0, len(pairs), CONTRACT_EVERY)
    codes = [rng.integers(0, 256, CODE_BYTES, dtype=np.uint8).tobytes()
             for _ in contracts]
    code_hashes = keccak256_batch(codes, device=device)
    out = list(pairs)
    for i, code_hash in zip(contracts, code_hashes):
        acct = Account.decode(out[i][1])
        out[i] = (out[i][0], Account(acct.nonce, acct.balance, storage_root,
                                     code_hash).encode())
    root, state_nodes = bulk_build(out, fused=True, device=device)
    return root, [state_nodes, storage_nodes, dict(zip(code_hashes, codes))]


def snapshot_fetch(stores):
    """A fast-sync ``fetch`` callback serving ``stores`` (a list of
    ``{hash: bytes}``), as a peer would."""
    def fetch(want):
        out = {}
        for h in want:
            for store in stores:
                v = store.get(h)
                if v is not None:
                    out[h] = v
                    break
        return out

    return fetch
