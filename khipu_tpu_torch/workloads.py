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
* Replay chains: ``MAINNET_BLOCK1`` over ``mainnet_genesis_spec``, and
  fixture chains executed by ``ChainBuilder`` on the host —
  ``transfer_chain`` (value transfers), ``contended_transfer_chain``
  (a share of each block's transfers paying a few hot recipients),
  ``erc20_chain`` (a deploy block, then token ``transfer(to, amount)``
  calls), ``erc20_fork_chain`` (a heavier branch of it, for chain
  switches), ``erc20_log_blocks`` (blocks on its head calling a token
  that emits the Transfer event) and ``mixed_contract_chain`` (counter
  calls beside transfers). ``replay_config`` and ``prebyzantium_config`` give their
  configurations.

Addresses and slots are hashed in one batch on ``device`` (K1f on the
card).
"""

from __future__ import annotations

import functools
import gzip
from typing import Dict, List, Tuple

import numpy as np

from khipu_tpu_torch.base import EMPTY_TRIE_HASH
from khipu_tpu_torch.base.rlp import rlp_encode_int
from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.blockchain import GenesisSpec
from khipu_tpu_torch.observability.profiler import D2H, LEDGER
from khipu_tpu_torch.ops.keccak import keccak256_batch, keccak256_fixed

Pairs = List[Tuple[bytes, bytes]]

# contract_snapshot's shape: one contract per 100 accounts, each with a
# 64-slot storage trie and a 2,048 B code blob (16 rate blocks)
CONTRACT_EVERY = 100
CONTRACT_SLOTS = 64
CODE_BYTES = 2048


def _hash_rows(addrs: np.ndarray, device) -> List[bytes]:
    digests = keccak256_fixed(addrs, device=device)
    with LEDGER.transfer("ops.keccak", D2H, digests.numel()):
        digests = digests.cpu().numpy()
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


# ------------------------------------------------------------- replay

# Mainnet genesis and block 1: real chain data. Block 1's header is
# authenticated by its Ethash seal (mined 2015-07-30 at difficulty
# 17,171,480,576), so its state root is an oracle this repo did not
# produce.
MAINNET_GENESIS_HASH = bytes.fromhex(
    "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"
)
MAINNET_BLOCK1_HASH = bytes.fromhex(
    "88e96d4537bea4d9c05d12549907b32561d3bf31f45aae734cdc119f13406cb6"
)
MAINNET_BLOCK1 = BlockHeader(
    parent_hash=MAINNET_GENESIS_HASH,
    ommers_hash=bytes.fromhex(
        "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
    ),
    beneficiary=bytes.fromhex("05a56e2d52c817161883f50c441c3228cfe54d9f"),
    state_root=bytes.fromhex(
        "d67e4d450343046425ae4271474353857ab860dbc0a1dde64b41b5cd3a532bf3"
    ),
    transactions_root=EMPTY_TRIE_HASH,
    receipts_root=EMPTY_TRIE_HASH,
    logs_bloom=b"\x00" * 256,
    difficulty=17_171_480_576,
    number=1,
    gas_limit=5000,
    gas_used=0,
    unix_timestamp=1_438_269_988,
    extra_data=bytes.fromhex(
        "476574682f76312e302e302f6c696e75782f676f312e342e32"
    ),  # "Geth/v1.0.0/linux/go1.4.2"
    mix_hash=bytes.fromhex(
        "969b900de27b6ac6a67742365dd65f55a0526c41fd18e1b16f1a1215c2e66f59"
    ),
    nonce=bytes.fromhex("539bd4979fef1ec4"),
)


def mainnet_genesis_spec(path: str) -> GenesisSpec:
    """``path``: the gzip alloc file ``genesis_pairs`` reads."""
    with gzip.open(path, "rt") as f:
        alloc = {bytes.fromhex(a): int(b) for a, b in map(str.split, f)}
    return GenesisSpec(
        alloc=alloc,
        difficulty=0x400000000,
        gas_limit=0x1388,
        timestamp=0,
        extra_data=bytes.fromhex(
            "11bbe8db4e347b4e8c937c1c8370e4b5ed33adb3db69cbdb7a38e1e50b1b82fa"
        ),
        nonce=bytes.fromhex("0000000000000042"),
    )


# ERC-20 transfer(to, amount) with real keccak mapping slots: balances
# live at keccak(pad32(holder) ++ pad32(0)); the sender's slot is
# debited by the amount word (wrapping, as EVM SUB does), the
# recipient's credited. Calldata is the raw two words (no ABI
# selector): arg0 = recipient, arg1 = amount.
ERC20_RUNTIME = bytes([
    0x33,                    # CALLER
    0x60, 0x00, 0x52,        # PUSH1 0  MSTORE   mem[0:32] = caller
    0x60, 0x00,              # PUSH1 0  (mapping base slot)
    0x60, 0x20, 0x52,        # PUSH1 32 MSTORE   mem[32:64] = 0
    0x60, 0x40, 0x60, 0x00,  # PUSH1 64 PUSH1 0
    0x20,                    # SHA3              sender slot
    0x80, 0x54,              # DUP1 SLOAD        sender balance
    0x60, 0x20, 0x35,        # PUSH1 32 CALLDATALOAD   amount
    0x90, 0x03,              # SWAP1 SUB         bal - amount
    0x90, 0x55,              # SWAP1 SSTORE      debit sender
    0x60, 0x00, 0x35,        # PUSH1 0 CALLDATALOAD    recipient
    0x60, 0x00, 0x52,        # PUSH1 0  MSTORE   mem[0:32] = recipient
    0x60, 0x40, 0x60, 0x00,  # PUSH1 64 PUSH1 0  (mem[32:64] still 0)
    0x20,                    # SHA3              recipient slot
    0x80, 0x54,              # DUP1 SLOAD        recipient balance
    0x60, 0x20, 0x35,        # PUSH1 32 CALLDATALOAD   amount
    0x01,                    # ADD               bal + amount
    0x90, 0x55,              # SWAP1 SSTORE      credit recipient
    0x00,                    # STOP
])
# constructor: CODECOPY the runtime out of the init code and return it
ERC20_INIT = bytes([
    0x60, len(ERC20_RUNTIME),  # PUSH1 len
    0x60, 0x0C,                # PUSH1 12 (runtime offset in init code)
    0x60, 0x00,                # PUSH1 0
    0x39,                      # CODECOPY
    0x60, len(ERC20_RUNTIME),  # PUSH1 len
    0x60, 0x00,                # PUSH1 0
    0xF3,                      # RETURN
]) + ERC20_RUNTIME

# keccak256("Transfer(address,address,uint256)"), the ERC-20 event topic
TRANSFER_TOPIC = bytes.fromhex(
    "ddf252ad1be2c89b69c2b068fc378daa952ba7f163c4a11628f55a4df523b3ef")
# ERC20_RUNTIME with the Transfer event a mainnet token emits: after the
# credit, LOG3(data = amount; topics TRANSFER_TOPIC, caller, recipient)
ERC20_LOG_RUNTIME = ERC20_RUNTIME[:-1] + bytes([
    0x60, 0x20, 0x35,        # PUSH1 32 CALLDATALOAD   amount
    0x60, 0x00, 0x52,        # PUSH1 0  MSTORE   mem[0:32] = amount
    0x60, 0x00, 0x35,        # PUSH1 0 CALLDATALOAD    topic 2: recipient
    0x33,                    # CALLER                  topic 1: sender
    0x7F,                    # PUSH32                  topic 0
]) + TRANSFER_TOPIC + bytes([
    0x60, 0x20, 0x60, 0x00,  # PUSH1 32 PUSH1 0  (size, offset)
    0xA3,                    # LOG3
    0x00,                    # STOP
])
ERC20_LOG_INIT = bytes([
    0x60, len(ERC20_LOG_RUNTIME), 0x60, 0x0C, 0x60, 0x00, 0x39,
    0x60, len(ERC20_LOG_RUNTIME), 0x60, 0x00, 0xF3,
]) + ERC20_LOG_RUNTIME

COINBASE = b"\xaa" * 20
# room for 200 token calls a block at a 100,000 gas limit each
# (mainnet's limit was 30M at blocks 15.50M-15.51M)
REPLAY_GAS_LIMIT = 30_000_000


def replay_config(**sync):
    """Every fork active from genesis (``fixture_config``), serial
    execution, one block a commit; ``sync`` overrides ``SyncConfig``
    fields (``parallel_tx=True`` for the scheduled executor)."""
    import dataclasses

    from khipu_tpu_torch.config import SyncConfig, fixture_config

    fields = dict(parallel_tx=False, commit_window_blocks=1)
    fields.update(sync)
    return dataclasses.replace(fixture_config(chain_id=1),
                               sync=SyncConfig(**fields))


def prebyzantium_config(**sync):
    """``replay_config`` with the schedule cut at Spurious Dragon: every
    fork through EIP-155/160/161 active from genesis, Byzantium and the
    later forks unscheduled. Receipts then carry intermediate state
    roots, so ``parallel_tx`` runs the optimistic executor and its
    serial merge, and commits stay one block each."""
    import dataclasses

    from khipu_tpu_torch.config import FAR

    cfg = replay_config(**sync)
    return dataclasses.replace(cfg, blockchain=dataclasses.replace(
        cfg.blockchain, byzantium_block=FAR, constantinople_block=FAR,
        petersburg_block=FAR, istanbul_block=FAR,
    ))


def replay_keys(n: int, seed_base: int = 1):
    """``n`` private keys ``seed_base .. seed_base + n - 1`` (32 B big
    endian) and their addresses."""
    from khipu_tpu_torch.base.secp256k1 import (
        privkey_to_pubkey,
        pubkey_to_address,
    )

    keys = [(i + seed_base).to_bytes(32, "big") for i in range(n)]
    return keys, [pubkey_to_address(privkey_to_pubkey(k)) for k in keys]


def _builder(cfg, alloc):
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.chain_builder import ChainBuilder

    spec = GenesisSpec(alloc=alloc, gas_limit=REPLAY_GAS_LIMIT)
    return ChainBuilder(Blockchain(Storages(), cfg), cfg, spec), spec


def bulk_alloc(n: int):
    """bulk_100k's accounts as a genesis alloc: ``n`` addresses
    ``(2**32 + i).to_bytes(20, "big")`` holding ``10**18 + i`` wei."""
    return {(2**32 + i).to_bytes(20, "big"): 10**18 + i for i in range(n)}


def transfer_chain(cfg, n_blocks: int, txs_per_block: int,
                   senders: int = 16):
    """``n_blocks`` blocks of ``txs_per_block`` value transfers, executed
    on the host: ``senders`` funded keys take turns, each transfer pays
    a varying value to a fresh address (a new account). Returns
    ``(builder, genesis spec, blocks)``."""
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        sign_transaction,
    )

    keys, addrs = replay_keys(senders, seed_base=301)
    builder, spec = _builder(cfg, {a: 10**24 for a in addrs})
    nonces = [0] * senders
    blocks = []
    for n in range(n_blocks):
        txs = []
        for j in range(txs_per_block):
            i = (n * txs_per_block + j) % senders
            to = (0xE1000000 + n * txs_per_block + j).to_bytes(20, "big")
            tx = Transaction(nonces[i], 10**9, 21_000, to,
                             10**15 + 7 * n + j)
            txs.append(sign_transaction(tx, keys[i], chain_id=1))
            nonces[i] += 1
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return builder, spec, blocks


def contended_transfer_chain(cfg, n_blocks: int, txs_per_block: int,
                             hot_recipients: int = 4,
                             hot_fraction: float = 0.2):
    """``n_blocks`` blocks of ``txs_per_block`` value transfers from
    ``txs_per_block`` funded keys (one transfer a sender a block): the
    first ``hot_fraction`` of each block pays one of ``hot_recipients``
    shared addresses in turn, the rest pay fresh addresses (new
    accounts). The shape of the JAX package's contended-replay bench,
    with plain transfers in place of its token calls. Returns
    ``(builder, genesis spec, blocks)``."""
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        sign_transaction,
    )

    keys, addrs = replay_keys(txs_per_block, seed_base=101)
    builder, spec = _builder(cfg, {a: 10**24 for a in addrs})
    hot = [(0xA0000000 + i).to_bytes(20, "big")
           for i in range(hot_recipients)]
    n_hot = max(1, int(txs_per_block * hot_fraction))
    blocks = []
    for n in range(n_blocks):
        txs = []
        for j in range(txs_per_block):
            if j < n_hot:
                to = hot[(j + n) % hot_recipients]
            else:
                to = (0xB0000000 + n * txs_per_block + j).to_bytes(20, "big")
            tx = Transaction(n, 10**9, 21_000, to, 10**15 + 7 * n + j)
            txs.append(sign_transaction(tx, keys[j], chain_id=1))
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return builder, spec, blocks


# counter runtime: storage[0] += 1 (a literal slot)
COUNTER_RUNTIME = bytes([
    0x60, 0x00, 0x54,        # PUSH1 0 SLOAD
    0x60, 0x01, 0x01,        # PUSH1 1 ADD
    0x60, 0x00, 0x55,        # PUSH1 0 SSTORE
    0x00,                    # STOP
])


def mixed_contract_chain(cfg, n_blocks: int, txs_per_block: int,
                         call_fraction: float = 0.6):
    """A deploy block, then ``n_blocks`` blocks of ``txs_per_block``
    transactions, one a sender: the first ``call_fraction`` call a
    ``COUNTER_RUNTIME`` contract (every call writes the same slot), the
    rest are value transfers to 64 receivers in turn. The shape of the
    JAX package's mixed-contract bench. Returns ``(builder, genesis
    spec, blocks)``."""
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        contract_address,
        sign_transaction,
    )

    keys, addrs = replay_keys(txs_per_block, seed_base=401)
    builder, spec = _builder(cfg, {a: 10**24 for a in addrs})
    runtime = COUNTER_RUNTIME
    init = (
        bytes([0x60 + len(runtime) - 1]) + runtime
        + bytes([0x60, 0x00, 0x52])
        + bytes([0x60, len(runtime), 0x60, 32 - len(runtime), 0xF3])
    )
    counter = contract_address(addrs[0], 0)
    receivers = [(0xD00D0000 + i).to_bytes(20, "big") for i in range(64)]
    n_calls = int(txs_per_block * call_fraction)
    deploy = Transaction(0, 10**9, 500_000, None, 0, payload=init)
    blocks = [builder.add_block([sign_transaction(deploy, keys[0],
                                                  chain_id=1)],
                                coinbase=COINBASE)]
    nonces = [1] + [0] * (txs_per_block - 1)
    for n in range(n_blocks):
        txs = []
        for j in range(txs_per_block):
            if j < n_calls:
                tx = Transaction(nonces[j], 10**9, 100_000, counter, 0)
            else:
                tx = Transaction(nonces[j], 10**9, 21_000,
                                 receivers[(j * 5 + n) % len(receivers)],
                                 1_000 + n)
            txs.append(sign_transaction(tx, keys[j], chain_id=1))
            nonces[j] += 1
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return builder, spec, blocks


def erc20_chain(cfg, n_blocks: int, txs_per_block: int, holders: int,
                extra_alloc=None):
    """A deploy block, then ``n_blocks`` blocks of ``txs_per_block``
    token ``transfer(to, amount)`` calls against one ``ERC20_RUNTIME``
    contract, executed on the host: one call a sender a block
    (``txs_per_block`` distinct senders), recipients drawn in turn from
    ``holders`` addresses, amounts varying per call. ``extra_alloc``
    (address -> balance) adds accounts to the genesis, which gives the
    account trie a realistic depth (``bulk_alloc``). Returns
    ``(builder, genesis spec, blocks)``."""
    return _erc20_blocks(cfg, n_blocks, txs_per_block, holders, extra_alloc)


# the heavier branch of erc20_fork_chain: another miner, and every
# transfer's amount shifted, so each of its transactions differs from the
# base chain's at the same sender and nonce
FORK_COINBASE = b"\xbb" * 20
FORK_AMOUNT_SHIFT = 1_000_000


def erc20_fork_chain(cfg, ancestor: int, fork_blocks: int,
                     txs_per_block: int, holders: int, extra_alloc=None):
    """A branch off ``erc20_chain(cfg, n, txs_per_block, holders)`` for
    a chain switch: that chain's deploy block and transfer blocks
    through block ``ancestor`` (the same blocks, hash for hash), then
    ``fork_blocks`` blocks of the same senders' next transfers with
    every amount shifted by ``FORK_AMOUNT_SHIFT``, mined by
    ``FORK_COINBASE``. With ``fork_blocks`` greater than the base
    chain's blocks above ``ancestor`` it is longer, so its total
    difficulty is heavier, and every base transaction above the ancestor
    is mined on the losing branch only (an orphan to recycle). Returns
    ``(builder, genesis spec, blocks)``, blocks 1 ..
    ``ancestor + fork_blocks``."""
    if ancestor < 1:
        raise ValueError("the branch forks after the deploy block")
    return _erc20_blocks(cfg, ancestor - 1 + fork_blocks, txs_per_block,
                         holders, extra_alloc, diverge_at=ancestor - 1)


def _erc20_blocks(cfg, n_blocks, txs_per_block, holders, extra_alloc,
                  diverge_at=None):
    """``erc20_chain``'s blocks; transfer blocks from index
    ``diverge_at`` on are the fork's (shifted amounts, FORK_COINBASE)."""
    from khipu_tpu_torch.domain.transaction import Transaction, sign_transaction

    keys, addrs = _erc20_senders(txs_per_block)
    alloc = dict(extra_alloc or {})
    alloc.update({a: 10**24 for a in addrs})
    builder, spec = _builder(cfg, alloc)
    deploy = Transaction(0, 10**9, 500_000, None, 0, payload=ERC20_INIT)
    blocks = [builder.add_block([sign_transaction(deploy, keys[0],
                                                  chain_id=1)],
                                coinbase=COINBASE)]
    for n in range(n_blocks):
        forked = diverge_at is not None and n >= diverge_at
        txs = erc20_transfers(n, txs_per_block, holders, forked)
        blocks.append(builder.add_block(
            txs, coinbase=FORK_COINBASE if forked else COINBASE))
    return builder, spec, blocks


@functools.lru_cache(maxsize=4)
def _erc20_senders(txs_per_block: int):
    return replay_keys(txs_per_block, seed_base=501)


def erc20_log_blocks(builder, transfer_blocks: int, n_blocks: int,
                     txs_per_block: int, holders: int):
    """``n_blocks`` blocks on top of ``erc20_chain``'s head after
    ``transfer_blocks`` transfer blocks, built by ``builder`` (whose head
    must be that block): the first opens with a deploy of an
    ``ERC20_LOG_RUNTIME`` token by sender 0, then every sender's next
    ``transfer(to, amount)`` on that token, each emitting one Transfer
    log. Returns ``(token address, blocks)``."""
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        contract_address,
        sign_transaction,
    )

    keys, addrs = _erc20_senders(txs_per_block)
    # sender 0 deployed the first token: one nonce ahead of the others
    nonces = [transfer_blocks + 1] + [transfer_blocks] * (txs_per_block - 1)
    token = contract_address(addrs[0], nonces[0])
    blocks = []
    for n in range(n_blocks):
        txs = []
        for j in range(txs_per_block):
            if n == 0 and j == 0:
                tx = Transaction(nonces[0], 10**9, 500_000, None, 0,
                                 payload=ERC20_LOG_INIT)
            else:
                rcpt = (0xE30E3000 + (j + n * 5) % holders).to_bytes(
                    20, "big")
                amount = 2_000 + 17 * j + n
                tx = Transaction(nonces[j], 10**9, 100_000, token, 0,
                                 payload=rcpt.rjust(32, b"\x00")
                                 + amount.to_bytes(32, "big"))
            txs.append(sign_transaction(tx, keys[j], chain_id=1))
            nonces[j] += 1
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return token, blocks


def erc20_transfers(n: int, txs_per_block: int, holders: int,
                    forked: bool = False):
    """The signed token transfers of ``erc20_chain``'s transfer block
    ``n`` (0-based, after the deploy block): one a sender, each at its
    next nonce. ``erc20_transfers(k, ...)`` for a chain of ``k`` transfer
    blocks is the block a miner would seal next."""
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        contract_address,
        sign_transaction,
    )

    keys, addrs = _erc20_senders(txs_per_block)
    token = contract_address(addrs[0], 0)
    txs = []
    for j in range(txs_per_block):
        rcpt = (0xE20E2000 + (j + n * 7) % holders).to_bytes(20, "big")
        amount = 1_000 + 13 * j + n + (FORK_AMOUNT_SHIFT if forked else 0)
        payload = rcpt.rjust(32, b"\x00") + amount.to_bytes(32, "big")
        nonce = n + (1 if j == 0 else 0)  # sender 0 deployed the token
        tx = Transaction(nonce, 10**9, 100_000, token, 0, payload=payload)
        txs.append(sign_transaction(tx, keys[j], chain_id=1))
    return txs
