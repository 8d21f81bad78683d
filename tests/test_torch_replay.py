"""Regular-sync replay, the port against the JAX package: chains built by
the JAX package's ChainBuilder on the host are replayed by both drivers
(the JAX one with the host fold, the port's with ``device_commit`` on the
CPU), and the per-block roots, receipt bytes and persisted node stores
must be equal; mainnet block 1 replays to its sealed state root; the
state-test corpus passes through both runners. Every comparison is
byte-exact."""

import dataclasses
import glob
import os

import pytest

from khipu_tpu import statetest as jx_statetest
from khipu_tpu.base.crypto import secp256k1 as jx_secp
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain import block as jx_block
from khipu_tpu.domain import transaction as jx_tx
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder
from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

from khipu_tpu_torch import statetest as pt_statetest
from khipu_tpu_torch import workloads
from khipu_tpu_torch.config import KhipuConfig, SyncConfig
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.ops import keccak_cuda
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync import prefetch
from khipu_tpu_torch.sync.replay import ReplayDriver

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GWEI = 10**9
COINBASE = b"\xaa" * 20
NODE_STORES = ("account_node_storage", "storage_node_storage",
               "evmcode_storage")


def _keys(n, base):
    keys = [(base + i).to_bytes(32, "big") for i in range(n)]
    return keys, [jx_secp.pubkey_to_address(jx_secp.privkey_to_pubkey(k))
                  for k in keys]


def _sign(key, nonce, to, value=0, payload=b"", gas=21000):
    return jx_tx.sign_transaction(
        jx_tx.Transaction(nonce, GWEI, gas, to, value, payload=payload),
        key, chain_id=1)


def _transfers(builder, keys, addrs):
    """4 blocks x 8 transfers, each to a fresh address."""
    nonces = [0] * 8
    blocks = []
    for n in range(4):
        txs = []
        for j in range(8):
            to = (0xE1000000 + 8 * n + j).to_bytes(20, "big")
            txs.append(_sign(keys[j], nonces[j], to, 10**15 + 7 * n + j))
            nonces[j] += 1
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return blocks


def _erc20(builder, keys, addrs):
    """A deploy block, then 3 blocks x 8 token transfers over 12
    holders (the chip's replay_erc20 at a small size)."""
    token = jx_tx.contract_address(addrs[0], 0)
    blocks = [builder.add_block(
        [_sign(keys[0], 0, None, payload=workloads.ERC20_INIT, gas=500_000)],
        coinbase=COINBASE)]
    nonces = [1] + [0] * 7
    for n in range(3):
        txs = []
        for j in range(8):
            rcpt = (0xE20E2000 + (j + 7 * n) % 12).to_bytes(20, "big")
            payload = rcpt.rjust(32, b"\x00") + (1000 + 13 * j + n).to_bytes(32, "big")
            txs.append(_sign(keys[j], nonces[j], token, payload=payload,
                             gas=100_000))
            nonces[j] += 1
        blocks.append(builder.add_block(txs, coinbase=COINBASE))
    return blocks


def _one_sender(builder, keys, addrs):
    """A block where one sender sends five transactions (to addresses
    another sender pays too, and to that other sender), then a block
    of one transaction."""
    to = [(0xE3000000 + i).to_bytes(20, "big") for i in range(3)]
    b1 = builder.add_block(
        [_sign(keys[0], i, to[i % 3], 10**16 + i) for i in range(5)]
        + [_sign(keys[1], 0, to[0], 5), _sign(keys[1], 1, addrs[0], 10**18)],
        coinbase=COINBASE)
    b2 = builder.add_block([_sign(keys[0], 5, addrs[2], 1)],
                           coinbase=COINBASE)
    return [b1, b2]


def _configs():
    jx = dataclasses.replace(jx_fixture_config(chain_id=1),
                             sync=JxSyncConfig(parallel_tx=False))
    return jx, workloads.replay_config()


@pytest.mark.parametrize("build", [_transfers, _erc20, _one_sender],
                         ids=["transfers_4x8", "erc20_deploy_3x8",
                              "one_sender_several_txs"])
def test_replay_matches_reference(build):
    jx_cfg, pt_cfg = _configs()
    keys, addrs = _keys(8, 70)
    alloc = {a: 10**22 for a in addrs}
    builder = JxChainBuilder(JxBlockchain(JxStorages(), jx_cfg), jx_cfg,
                             JxGenesisSpec(alloc=alloc))
    blocks = build(builder, keys, addrs)
    wire = [b.encode() for b in blocks]

    jx_chain = JxBlockchain(JxStorages(), jx_cfg)
    jx_chain.load_genesis(JxGenesisSpec(alloc=alloc))
    jx_stats = JxReplayDriver(jx_chain, jx_cfg).replay(
        [type(blocks[0]).decode(w) for w in wire])

    pt_chain = Blockchain(Storages(), pt_cfg)
    pt_chain.load_genesis(GenesisSpec(alloc=alloc), on_device=True,
                          device="cpu")
    stats = ReplayDriver(pt_chain, pt_cfg, device_commit=True,
                         device="cpu").replay([Block.decode(w) for w in wire])

    assert (stats.blocks, stats.txs, stats.gas) == (
        jx_stats.blocks, jx_stats.txs, jx_stats.gas)
    assert set(stats.phases) == {"senders", "validate", "execute", "commit",
                                 "save", "senders_bg"}
    for n in range(1, len(blocks) + 1):
        header = pt_chain.get_header_by_number(n)
        assert header.encode() == jx_chain.get_header_by_number(n).encode()
        assert header.state_root == blocks[n - 1].header.state_root
        assert (pt_chain.storages.receipts_storage.get(n)
                == jx_chain.storages.receipts_storage.get(n))
        assert pt_chain.get_total_difficulty(n) == jx_chain.get_total_difficulty(n)
    for name in NODE_STORES:
        got = getattr(pt_chain.storages, name).source._map
        assert got == getattr(jx_chain.storages, name).source._map
        assert got == getattr(builder.blockchain.storages, name).source._map
    assert pt_chain.best_block_number == len(blocks)


def test_port_chain_builder_matches_reference():
    """workloads.transfer_chain (the port's ChainBuilder) builds the same
    blocks as the JAX package's from the same transactions."""
    cfg = workloads.replay_config()
    pt_builder, spec, blocks = workloads.transfer_chain(cfg, 3, 4, senders=3)
    jx_cfg = dataclasses.replace(jx_fixture_config(chain_id=1),
                                 sync=JxSyncConfig(parallel_tx=False))
    jx_builder = JxChainBuilder(
        JxBlockchain(JxStorages(), jx_cfg), jx_cfg,
        JxGenesisSpec(alloc=spec.alloc, gas_limit=spec.gas_limit))
    for b in blocks:
        txs = [jx_tx.SignedTransaction.decode(t.encode())
               for t in b.body.transactions]
        jb = jx_builder.add_block(txs, coinbase=b.header.beneficiary)
        assert jb.encode() == b.encode()


def test_mainnet_block1_replays_to_sealed_root():
    """Genesis alloc (8,893 accounts) built a level at a time by the
    device hasher's plain version, then block 1 replayed with
    device_commit: the root must be the PoW-sealed header's and the
    miner must hold the 5 ETH Frontier reward."""
    cfg = dataclasses.replace(KhipuConfig(),
                              sync=SyncConfig(parallel_tx=False))
    chain = Blockchain(Storages(), cfg)
    genesis = chain.load_genesis(
        workloads.mainnet_genesis_spec(
            os.path.join(FIXTURES, "mainnet_genesis_alloc.txt.gz")),
        on_device=True, device="cpu")
    assert genesis.hash == workloads.MAINNET_GENESIS_HASH
    header = workloads.MAINNET_BLOCK1
    assert header.hash == workloads.MAINNET_BLOCK1_HASH
    stats = ReplayDriver(chain, cfg, device_commit=True, device="cpu").replay(
        [Block(header, BlockBody())])
    assert stats.blocks == 1 and chain.best_block_number == 1
    assert chain.get_header_by_number(1).state_root == header.state_root
    miner = chain.get_account(header.beneficiary, header.state_root)
    assert miner.balance == 5 * 10**18


@pytest.mark.parametrize("window", [4, 16])
@pytest.mark.parametrize("build", [
    lambda cfg: workloads.transfer_chain(cfg, 20, 2, senders=3),
    lambda cfg: workloads.erc20_chain(cfg, 19, 3, 8),
], ids=["transfer_chain_20x2", "erc20_chain_deploy_19x3"])
def test_windowed_replay_matches_reference(build, window):
    """The serial replay's chains at ``commit_window_blocks`` 4 and 16
    (20 blocks: several windows, the last one short), replayed by both
    drivers' windowed pipelines — the port's with ``device_commit`` on
    the CPU (the plain K5 and a CPU mirror): headers, receipts and the
    nodes reachable from the head root equal the JAX package's, and the
    head root is the host-built chain's."""
    from tests.test_torch_window import _reachable

    from khipu_tpu.storage.compactor import compact as jx_compact

    pt_cfg = workloads.replay_config(commit_window_blocks=window,
                                     adaptive_commit=False)
    jx_cfg = dataclasses.replace(
        jx_fixture_config(chain_id=1),
        sync=JxSyncConfig(parallel_tx=False, commit_window_blocks=window))
    builder, spec, blocks = build(workloads.replay_config())
    wire = [b.encode() for b in blocks]

    jx_chain = JxBlockchain(JxStorages(), jx_cfg)
    jx_chain.load_genesis(JxGenesisSpec(alloc=spec.alloc,
                                        gas_limit=spec.gas_limit))
    jx_stats = JxReplayDriver(jx_chain, jx_cfg).replay(
        [jx_block.Block.decode(w) for w in wire])
    pt_chain = Blockchain(Storages(), pt_cfg)
    pt_chain.load_genesis(spec, on_device=True, device="cpu")
    stats = ReplayDriver(pt_chain, pt_cfg, device_commit=True,
                         device="cpu").replay([Block.decode(w) for w in wire])

    n = len(blocks)
    assert (stats.blocks, stats.txs, stats.gas) == (
        jx_stats.blocks, jx_stats.txs, jx_stats.gas) and stats.blocks == n
    for i in range(1, n + 1):
        assert (pt_chain.get_header_by_number(i).encode()
                == jx_chain.get_header_by_number(i).encode())
        assert (pt_chain.storages.receipts_storage.get(i)
                == jx_chain.storages.receipts_storage.get(i))
    root = blocks[-1].header.state_root
    assert pt_chain.get_header_by_number(n).state_root == root
    assert (_reachable(pt_chain.storages, root)
            == _reachable(jx_chain.storages, root, jx_compact))
    assert pt_chain.storages.window_journal.pending() == []


def test_parallel_replay_raises_for_multi_tx_blocks():
    """The name is older than the port's parallel executors: a replay at
    ``parallel_tx`` of multi-transaction blocks no longer raises; it
    runs their transfers through the scheduled executor's fast path and
    lands on the serially built chain."""
    cfg = workloads.replay_config()
    builder, spec, blocks = workloads.transfer_chain(cfg, 1, 2, senders=2)
    cfg = workloads.replay_config(parallel_tx=True)
    chain = Blockchain(Storages(), cfg)
    chain.load_genesis(spec)
    stats = ReplayDriver(chain, cfg, device="cpu").replay(blocks)
    assert (stats.txs, stats.parallel_txs, stats.fast_path_txs) == (2, 2, 2)
    assert chain.get_header_by_number(1).hash == blocks[0].hash


def test_sender_recovery_on_cpu_hashes_on_host():
    """With ``device="cpu"`` the prefetch path hashes on the host (no
    card batch, no K1r launch) and recovers the JAX package's senders."""
    keys, addrs = _keys(6, 90)
    stxs = [_sign(k, 0, addrs[0], 1) for k in keys]
    port = [SignedTransaction.decode(s.encode()) for s in stxs]
    prefetch.flush_sender_cache()
    batches = prefetch.PREFETCH_GAUGES["device_batches"]
    launches = keccak_cuda.RAGGED_LAUNCHES
    prefetch.recover_block_senders(port, batch_hash=True, device="cpu")
    assert [p.sender for p in port] == [s.sender for s in stxs] == addrs
    assert prefetch.PREFETCH_GAUGES["device_batches"] == batches
    assert keccak_cuda.RAGGED_LAUNCHES == launches


STATE_TESTS = sorted(glob.glob(os.path.join(FIXTURES, "state_tests", "*.json")))


@pytest.mark.parametrize("path", STATE_TESTS,
                         ids=[os.path.basename(p) for p in STATE_TESTS])
def test_state_tests_through_both_runners(path):
    ours = pt_statetest.run_file(path)
    theirs = jx_statetest.run_file(path)
    assert ours and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.ok, f"{a.name}[{a.fork}#{a.index}]: {a.detail}"
        assert (a.got_hash, a.got_logs) == (a.want_hash, a.want_logs)
        assert (a.got_hash, a.got_logs) == (b.got_hash, b.got_logs)
        assert (a.name, a.fork, a.index) == (b.name, b.fork, b.index)
