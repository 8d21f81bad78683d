"""The DAO drain's EIP-161 sweep on every executor of the port, against
the JAX package's serial execution of the same blocks.

The fork block's irregular transfers drain ``a2`` and ``a3`` into the
refund contract and mark both touched. The serial fold and the
optimistic executor sweep those marks at the end of the block's first
transaction, so ``a2`` (empty after the drain) is deleted. The scheduled
executor runs plain transfers as one vectorized batch, which drops
marks without a sweep; it sweeps the marks set before the batch instead,
as that first transaction's sweep would. ``a3`` is credited by the
block's first transaction, so it survives on every path.

A DAO block with no transaction runs no sweep on any path: ``a2`` stays
as an empty account.

The chains are built by the JAX package's serial ``ChainBuilder``
(``parallel_tx=False``); the port replays them with each executor,
serially and at windows 3 and 4 (the windowed commit's plain versions
on the CPU). A root the port got wrong fails its import.
"""

import dataclasses

import pytest

from khipu_tpu.base.crypto.secp256k1 import (
    privkey_to_pubkey as jax_pub,
    pubkey_to_address as jax_addr,
)
from khipu_tpu.config import SyncConfig as JaxSyncConfig
from khipu_tpu.config import fixture_config as jax_fixture_config
from khipu_tpu.domain.blockchain import Blockchain as JaxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JaxGenesisSpec
from khipu_tpu.domain.transaction import Transaction as JaxTransaction
from khipu_tpu.domain.transaction import sign_transaction as jax_sign
from khipu_tpu.storage.storages import Storages as JaxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JaxChainBuilder

KEYS = [(i + 1).to_bytes(32, "big") for i in range(4)]
ADDRS = [jax_addr(jax_pub(k)) for k in KEYS]
REFUND = b"\xbf" * 20
OTHER = b"\x11" * 20
N_BLOCKS = 6

EXECUTORS = {
    "serial": dict(parallel_tx=False),
    "scheduled": dict(parallel_tx=True, scheduled_tx=True),
    "optimistic": dict(parallel_tx=True, scheduled_tx=False),
}


def _dao_kwargs(fork):
    return dict(
        dao_fork_block_number=fork,
        dao_drain_list=(ADDRS[2], ADDRS[3]),
        dao_refund_contract=REFUND,
        dao_fork_extra_data=None,
        dao_fork_block_hash=None,
    )


def _jax_chain(fork, empty_fork_block):
    """N_BLOCKS blocks of two plain transfers (a0 -> a3 first, so the
    drained a3 is credited by the first transaction; a1 -> OTHER), built
    serially by the JAX package. With ``empty_fork_block`` the fork
    block carries no transaction."""
    cfg = dataclasses.replace(
        jax_fixture_config(chain_id=1, **_dao_kwargs(fork)),
        sync=JaxSyncConfig(parallel_tx=False, commit_window_blocks=1),
    )
    builder = JaxChainBuilder(
        JaxBlockchain(JaxStorages(), cfg), cfg,
        JaxGenesisSpec(alloc={a: 10**21 for a in ADDRS}),
    )
    blocks, nonce = [], 0
    for n in range(1, N_BLOCKS + 1):
        txs = []
        if not (empty_fork_block and n == fork):
            txs = [
                jax_sign(JaxTransaction(nonce, 10**9, 21_000, ADDRS[3], 5),
                         KEYS[0], chain_id=1),
                jax_sign(JaxTransaction(nonce, 10**9, 21_000, OTHER, 7),
                         KEYS[1], chain_id=1),
            ]
            nonce += 1
        blocks.append(builder.add_block(txs, coinbase=b"\xaa" * 20))
    return builder.blockchain, blocks


_CHAINS = {}


def jax_chain(fork, empty_fork_block=False):
    key = (fork, empty_fork_block)
    if key not in _CHAINS:
        _CHAINS[key] = _jax_chain(fork, empty_fork_block)
    return _CHAINS[key]


def port_replay(fork, blocks, executor, window):
    from khipu_tpu_torch.config import SyncConfig, fixture_config
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
    from khipu_tpu_torch.ledger import schedule
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.replay import ReplayDriver

    cfg = dataclasses.replace(
        fixture_config(chain_id=1, **_dao_kwargs(fork)),
        sync=SyncConfig(tx_workers=2, commit_window_blocks=window,
                        **EXECUTORS[executor]),
    )
    schedule.reset_learner()
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc={a: 10**21 for a in ADDRS}),
                    on_device=True, device="cpu")
    stats = ReplayDriver(bc, cfg, device_commit=True, device="cpu").replay(
        [Block.decode(b.encode()) for b in blocks])
    return bc, stats


def _roots(bc, n):
    return [bc.get_header_by_number(i).state_root for i in range(n + 1)]


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("fork", [1, 2, 4])
def test_dao_drain_sweep_matches_serial_reference(fork, executor):
    ref_bc, blocks = jax_chain(fork)
    ref_roots = _roots(ref_bc, N_BLOCKS)
    fork_root = ref_roots[fork]
    assert ref_bc.get_account(ADDRS[2], fork_root) is None  # swept
    assert ref_bc.get_account(ADDRS[3], fork_root).balance == 5
    for window in (1, 3, 4):
        bc, stats = port_replay(fork, blocks, executor, window)
        assert bc.best_block_number == N_BLOCKS
        assert _roots(bc, N_BLOCKS) == ref_roots, (executor, window)
        # a windowed chain stores each window's last state: read the tip
        tip = ref_roots[N_BLOCKS]
        assert bc.get_account(ADDRS[2], tip) is None
        assert (bc.get_account(REFUND, tip).balance
                == ref_bc.get_account(REFUND, tip).balance)
        if executor == "scheduled":
            # the fork block really ran the vectorized transfer batch
            assert stats.fast_path_txs > 0, window


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_dao_block_without_transactions_sweeps_nothing(executor):
    fork = 2
    ref_bc, blocks = jax_chain(fork, empty_fork_block=True)
    assert not blocks[fork - 1].body.transactions
    ref_roots = _roots(ref_bc, N_BLOCKS)
    kept = ref_bc.get_account(ADDRS[2], ref_roots[fork])
    assert kept is not None and kept.balance == 0
    for window in (1, 3, 4):
        bc, _ = port_replay(fork, blocks, executor, window)
        assert _roots(bc, N_BLOCKS) == ref_roots, (executor, window)
        acc = bc.get_account(ADDRS[2], ref_roots[N_BLOCKS])
        assert acc is not None and acc.balance == 0
