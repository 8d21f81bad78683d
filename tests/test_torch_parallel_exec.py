"""The port's parallel and scheduled block execution (khipu_tpu_torch
ledger/ledger.py's scheduled, optimistic and serial paths, the batch
lanes, ReplayDriver's counters) and the execute stage's row validation
(trie/fused.py, K6's plain version) against the JAX package's, on the
CPU.

Chains come from the port's workloads (built by its serial fold on the
host) and reach both packages as wire RLP: a small ERC-20 chain, a
contended transfer chain, a mixed contract chain, a pre-Byzantium
contended chain (the optimistic merge with intermediate-root receipts)
and a block over the cumulative gas limit. ``execute_block`` and
``ReplayDriver`` (windows 1 and 8; the port's on ``device="cpu"`` with
``device_commit``, the reference on its host-hasher path) must give
equal encoded receipts, gas, roots, persisted nodes, ``Stats`` /
``ReplayStats`` counters and execute-stage gauge deltas. Both packages'
process-global learners are reset before every replay."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from khipu_tpu.config import FAR as JX_FAR
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain.block import Block as JxBlock
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.ledger import batch_exec as jx_batch_exec
from khipu_tpu.ledger import ledger as jx_ledger
from khipu_tpu.ledger import schedule as jx_sched
from khipu_tpu.storage.compactor import compact as jx_compact
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver
from khipu_tpu.trie import fused as jx_fused

from khipu_tpu_torch import workloads
from khipu_tpu_torch.config import fixture_config
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.domain.transaction import Transaction, sign_transaction
from khipu_tpu_torch.ledger import batch_exec as pt_batch_exec
from khipu_tpu_torch.ledger import ledger as pt_ledger
from khipu_tpu_torch.ledger import schedule as pt_sched
from khipu_tpu_torch.ops import build
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync import adaptive
from khipu_tpu_torch.sync.replay import ReplayDriver
from khipu_tpu_torch.trie import exec_validate_cuda, fused
from tests.test_torch_window import _reachable

SEED = 20261017
U64 = (1 << 64) - 1
U256 = (1 << 256) - 1

CHAINS = {
    "erc20_4x40": (workloads.replay_config,
                   lambda cfg: workloads.erc20_chain(cfg, 4, 40, 64)),
    "contended_4x30": (workloads.replay_config,
                       lambda cfg: workloads.contended_transfer_chain(cfg, 4,
                                                                      30)),
    "mixed_4x20": (workloads.replay_config,
                   lambda cfg: workloads.mixed_contract_chain(cfg, 4, 20)),
    "prebyz_contended_4x30": (
        workloads.prebyzantium_config,
        lambda cfg: workloads.contended_transfer_chain(cfg, 4, 30)),
}
_BUILT = {}


def _chain(name):
    """(make_config, genesis spec, wire blocks) of a CHAINS entry,
    built once a process by the port's serial fold."""
    if name not in _BUILT:
        make_cfg, build_chain = CHAINS[name]
        _, spec, blocks = build_chain(make_cfg())
        _BUILT[name] = (make_cfg, spec, [b.encode() for b in blocks])
    return _BUILT[name]


def _jx_cfg(prebyz, **sync):
    cfg = jx_fixture_config(chain_id=1)
    if prebyz:
        cfg = dataclasses.replace(cfg, blockchain=dataclasses.replace(
            cfg.blockchain, byzantium_block=JX_FAR,
            constantinople_block=JX_FAR, petersburg_block=JX_FAR,
            istanbul_block=JX_FAR))
    return dataclasses.replace(cfg, sync=JxSyncConfig(**sync))


def _jx_spec(spec):
    return JxGenesisSpec(alloc=spec.alloc, gas_limit=spec.gas_limit)


def _reset_both():
    pt_sched.reset_learner()
    jx_sched.reset_learner()


_GAUGES = [k for k in pt_sched.EXEC_GAUGES if k != "max_batch_width"]
_STATS = ("tx_count", "gas_used", "parallel_count", "conflict_count",
          "fast_path_txs", "residue_txs", "mispredicted_txs")
_REPLAY = ("blocks", "txs", "gas", "parallel_txs", "conflicts",
           "fast_path_txs", "residue_txs", "mispredictions")


class _Gauges:
    """Execute-stage gauge deltas of both packages since construction."""

    def __init__(self):
        self.pt = dict(pt_sched.EXEC_GAUGES)
        self.jx = dict(jx_sched.EXEC_GAUGES)

    def deltas(self):
        return ({k: pt_sched.EXEC_GAUGES[k] - self.pt[k] for k in _GAUGES},
                {k: jx_sched.EXEC_GAUGES[k] - self.jx[k] for k in _GAUGES})


# ----------------------------------------------------------- execute_block


@pytest.mark.parametrize("scheduled", [True, False],
                         ids=["scheduled", "optimistic"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_execute_block_matches_reference(name, scheduled):
    """Every block of the chain through both packages' execute_block
    (with the header gate): equal receipts, gas, post roots, per-block
    Stats counters and gauge deltas."""
    make_cfg, spec, wire = _chain(name)
    prebyz = name.startswith("prebyz")
    pt_cfg = make_cfg(parallel_tx=True, scheduled_tx=scheduled)
    jx_cfg = _jx_cfg(prebyz, scheduled_tx=scheduled)
    pt_bc = Blockchain(Storages(), pt_cfg)
    pt_bc.load_genesis(spec)
    jx_bc = JxBlockchain(JxStorages(), jx_cfg)
    jx_bc.load_genesis(_jx_spec(spec))
    root = pt_bc.get_header_by_number(0).state_root
    assert root == jx_bc.get_header_by_number(0).state_root
    _reset_both()
    gauges = _Gauges()
    for w in wire:
        pt_block, jx_block = Block.decode(w), JxBlock.decode(w)
        got = pt_ledger.execute_block(pt_block, root, pt_bc.get_world_state,
                                      pt_cfg)
        want = jx_ledger.execute_block(jx_block, root, jx_bc.get_world_state,
                                       jx_cfg)
        assert ([r.encode() for r in got.receipts]
                == [r.encode() for r in want.receipts])
        assert got.gas_used == want.gas_used == pt_block.header.gas_used
        assert ([getattr(got.stats, k) for k in _STATS]
                == [getattr(want.stats, k) for k in _STATS])
        assert got.world.account_trie.root_hash == pt_block.header.state_root
        pt_bc.save_block(pt_block, got.receipts, 0, got.world)
        jx_bc.save_block(jx_block, want.receipts, 0, want.world)
        root = pt_block.header.state_root
    d_pt, d_jx = gauges.deltas()
    assert d_pt == d_jx
    if prebyz:
        assert d_pt["planned_blocks"] == 0  # never scheduled
        assert isinstance(got.receipts[0].post_tx_state, bytes)
    elif scheduled:
        assert d_pt["planned_blocks"] == len(wire) - name.startswith(
            ("erc20", "mixed"))  # the one-tx deploy block runs serially


def _over_limit_block():
    """A block of five transfers whose gas limits (40,000 each) cross
    the 100,000 block gas limit at the fourth, though the gas used (21,000
    each) would fit."""
    keys, addrs = workloads.replay_keys(5, seed_base=901)
    txs = tuple(sign_transaction(
        Transaction(0, 10**9, 40_000, (0xC1000000 + i).to_bytes(20, "big"),
                    1_000 + i), keys[i], chain_id=1) for i in range(5))
    header = BlockHeader(
        parent_hash=b"\x11" * 32, ommers_hash=b"\x22" * 32,
        beneficiary=workloads.COINBASE, state_root=b"\x00" * 32,
        transactions_root=b"\x00" * 32, receipts_root=b"\x00" * 32,
        logs_bloom=b"\x00" * 256, difficulty=131_072, number=1,
        gas_limit=100_000, gas_used=0, unix_timestamp=13)
    return {a: 10**24 for a in addrs}, Block(header, BlockBody(txs, ())).encode()


@pytest.mark.parametrize("mode", ["scheduled", "optimistic", "serial",
                                  "prebyz"])
def test_cumulative_gas_limit_breaks_the_same_way(mode):
    """The block over the cumulative gas limit raises the same
    TxValidationError (index and text) in both packages, on every path,
    with equal gauge deltas (the scheduled attempt falls back)."""
    prebyz = mode == "prebyz"
    sync = dict(parallel_tx=mode != "serial",
                scheduled_tx=mode == "scheduled")
    alloc, w = _over_limit_block()
    make_cfg = workloads.prebyzantium_config if prebyz else workloads.replay_config
    pt_cfg, jx_cfg = make_cfg(**sync), _jx_cfg(prebyz, **sync)
    pt_bc = Blockchain(Storages(), pt_cfg)
    pt_bc.load_genesis(GenesisSpec(alloc=alloc))
    jx_bc = JxBlockchain(JxStorages(), jx_cfg)
    jx_bc.load_genesis(JxGenesisSpec(alloc=alloc))
    root = pt_bc.get_header_by_number(0).state_root
    _reset_both()
    gauges = _Gauges()
    with pytest.raises(pt_ledger.TxValidationError) as got:
        pt_ledger.execute_block(Block.decode(w), root, pt_bc.get_world_state,
                                pt_cfg, validate=False)
    with pytest.raises(jx_ledger.TxValidationError) as want:
        jx_ledger.execute_block(JxBlock.decode(w), root,
                                jx_bc.get_world_state, jx_cfg,
                                validate=False)
    assert (got.value.index, str(got.value)) == (want.value.index,
                                                 str(want.value))
    assert got.value.index == 3
    d_pt, d_jx = gauges.deltas()
    assert d_pt == d_jx
    assert d_pt["fallbacks"] == (mode == "scheduled")


# ---------------------------------------------------------------- replays


def _replay_both(name, window, **sync):
    """Replay the chain through both drivers: the port's with
    device_commit on the CPU, the reference's host path. Returns the
    port's stats and chain."""
    make_cfg, spec, wire = _chain(name)
    prebyz = name.startswith("prebyz")
    pt_cfg = make_cfg(parallel_tx=True, commit_window_blocks=window, **sync)
    jx_cfg = _jx_cfg(prebyz, commit_window_blocks=window)
    _reset_both()
    gauges = _Gauges()
    pt_bc = Blockchain(Storages(), pt_cfg)
    pt_bc.load_genesis(spec, on_device=True, device="cpu")
    stats = ReplayDriver(pt_bc, pt_cfg, device_commit=True,
                         device="cpu").replay([Block.decode(w) for w in wire])
    jx_bc = JxBlockchain(JxStorages(), jx_cfg)
    jx_bc.load_genesis(_jx_spec(spec))
    jx_stats = JxReplayDriver(jx_bc, jx_cfg).replay(
        [JxBlock.decode(w) for w in wire])
    d_pt, d_jx = gauges.deltas()
    assert d_pt == d_jx
    assert ([getattr(stats, k) for k in _REPLAY]
            == [getattr(jx_stats, k) for k in _REPLAY])
    n = len(wire)
    assert stats.blocks == n
    for i in range(1, n + 1):
        assert (pt_bc.get_header_by_number(i).encode()
                == jx_bc.get_header_by_number(i).encode()
                == JxBlock.decode(wire[i - 1]).header.encode())
        assert (pt_bc.storages.receipts_storage.get(i)
                == jx_bc.storages.receipts_storage.get(i))
    root = pt_bc.get_header_by_number(n).state_root
    assert (_reachable(pt_bc.storages, root)
            == _reachable(jx_bc.storages, root, jx_compact))
    return stats, pt_bc


_REPLAYS = [(n, w) for n in CHAINS for w in (1, 8)
            if not (n.startswith("prebyz") and w > 1)]


@pytest.mark.parametrize("name,window", _REPLAYS,
                         ids=[f"{n}-w{w}" for n, w in _REPLAYS])
def test_replay_driver_matches_reference(name, window):
    """ReplayDriver at the default SyncConfig's parallel_tx and
    scheduled_tx: headers, receipts, reachable nodes, the replay's
    execute-stage counters and gauge deltas equal the JAX package's."""
    stats, _ = _replay_both(name, window)
    if name == "erc20_4x40":
        # block 2 teaches, block 3 runs checked, blocks 4-5 trusted
        assert (stats.residue_txs, stats.fast_path_txs, stats.parallel_txs,
                stats.mispredictions) == (40, 80, 120, 0)
    if name.startswith("prebyz"):
        assert stats.conflicts > 0 and stats.fast_path_txs == 0


@pytest.mark.parametrize("probe", [False, True],
                         ids=["probe_off", "probe_on"])
def test_exec_device_routes_rows_by_probe(probe, monkeypatch):
    """With ``exec_device`` on the CPU: the probe off sends every fast
    batch's rows through ``fused_exec_validate`` (K6's plain version on
    the CPU), the probe on reports no device memory and keeps the host
    pass; the replay equals the reference's either way."""
    calls = []
    real = fused.fused_exec_validate

    def counting(*args, **kwargs):
        calls.append(args[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(fused, "fused_exec_validate", counting)
    stats, _ = _replay_both("contended_4x30", 8, exec_device=True,
                            adaptive_probe=probe)
    assert stats.fast_path_txs == 120
    assert len(calls) == (0 if probe else 4)
    assert all(torch.device(d).type == "cpu" for d in calls)
    assert adaptive.exec_device_allowed(
        workloads.replay_config(exec_device=True, adaptive_probe=probe).sync,
        "cpu") is (not probe)


def test_readme_fixture_config_replays_on_the_cpu():
    """The quick start's default config (parallel_tx and scheduled_tx
    on) replays multi-transaction blocks in the port, and its receipts
    equal the serial build's."""
    cfg = fixture_config(chain_id=1)
    assert cfg.sync.parallel_tx and cfg.sync.scheduled_tx
    _, spec, wire = _chain("erc20_4x40")
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(spec, on_device=True, device="cpu")
    pt_sched.reset_learner()
    stats = ReplayDriver(bc, cfg, device_commit=True, device="cpu").replay(
        [Block.decode(w) for w in wire])
    assert stats.blocks == len(wire) and stats.parallel_txs == 120
    assert bc.get_header_by_number(len(wire)).hash == Block.decode(
        wire[-1]).hash


# --------------------------------------------------- row validation (K6)


def _edge_rows():
    """(tx nonce, account nonce, balance, upfront) edge rows."""
    big = 2**255 + 12345
    return [
        (U64, U64, 1, 1), (U64, U64 - 1, 1, 1), (0, U64, 5, 0),
        (7, 7, big, big),                      # balance == upfront
        (1, 1, big + 1, big), (1, 1, big, big + 1),  # limb 7 only
        (1, 1, big + (1 << 224), big), (1, 1, big, big + (1 << 224)),  # limb 0
        (0, 0, 0, 0),                          # all-zero
        (3, 3, U256, U256), (3, 3, U256, U256 - 1), (3, 3, U256 - 1, U256),
        (3, 3, U256, 0), (2**32, 2**32, 2**32, 2**32 + 1),
        (2**32 - 1, 2**32, 1, 0),
    ]


def _seeded_rows(n):
    rng = np.random.default_rng(SEED)
    rows = []
    for _ in range(n):
        t = int(rng.integers(0, 2**63))
        a = t if rng.random() < 0.7 else int(rng.integers(0, 2**63))
        b = int.from_bytes(rng.bytes(32), "big")
        mode = rng.random()
        if mode < 0.3:
            u = b  # equal
        elif mode < 0.6:  # share a random prefix of limbs
            cut = int(rng.integers(0, 8)) * 32
            mask = ((1 << 256) - 1) >> (256 - cut) if cut else 0
            u = (b & ~mask) | (int.from_bytes(rng.bytes(32), "big") & mask)
        else:
            u = int.from_bytes(rng.bytes(32), "big")
        rows.append((t, a, b, u))
    return rows


def _oracle(rows):
    return [t == a and b >= u for t, a, b, u in rows]


def test_exec_validate_plain_matches_reference_kernel():
    """K6's plain version on the packed rows equals the JAX package's
    jitted ``_exec_validate_fn`` (JAX on the CPU) and the integer
    oracle on every seeded and edge row, and ``fused_exec_validate`` on
    the CPU returns the same mask."""
    rows = _edge_rows() + _seeded_rows(4096)
    cols = [list(c) for c in zip(*rows)]
    packed = fused.pack_exec_rows(*cols)
    assert packed.dtype == np.uint32 and packed.shape == (len(rows), 20)
    got = fused.exec_validate_plain(torch.from_numpy(packed.view(np.int32)))
    assert got.dtype == torch.uint8
    want = np.asarray(jx_fused._exec_validate_fn()(
        packed[:, 0:2], packed[:, 2:4], packed[:, 4:12], packed[:, 12:20]))
    assert got.numpy().astype(bool).tolist() == want.tolist() == _oracle(rows)
    assert fused.fused_exec_validate(*cols, device="cpu").tolist() == _oracle(rows)
    # the reference's padded dispatcher agrees on the real rows
    edge = [list(c) for c in zip(*_edge_rows())]
    assert (jx_fused.fused_exec_validate(*edge).tolist()
            == fused.fused_exec_validate(*edge, device="cpu").tolist())
    assert fused.fused_exec_validate([], [], [], [], device="cpu").shape == (0,)


class _World:
    """The two reads gather_validate_rows makes."""

    def __init__(self, nonces, balances):
        self.nonces, self.balances = nonces, balances

    def get_nonce(self, a):
        return self.nonces[a]

    def get_balance(self, a):
        return self.balances[a]


class _Stx:
    def __init__(self, nonce):
        self.tx = type("T", (), {"nonce": nonce})()


def _rows_and_world(bad):
    """Eight rows, row ``bad[0]`` broken as ``bad[1]`` says."""
    nonces = {bytes([i]) * 20: i for i in range(8)}
    balances = {bytes([i]) * 20: 10**18 + i for i in range(8)}
    rows = [(10 + i, _Stx(i), bytes([i]) * 20, 10**18) for i in range(8)]
    i, how = bad
    if how == "nonce":
        rows[i] = (10 + i, _Stx(i + 1), rows[i][2], 10**18)
    elif how == "balance":
        rows[i] = (10 + i, _Stx(i), rows[i][2], 10**18 + i + 1)
    elif how == "width":
        rows[i] = (10 + i, _Stx(i), rows[i][2], 1 << 256)
    return rows, _World(nonces, balances)


@pytest.mark.parametrize("bad", [(None, "none"), (3, "nonce"), (0, "balance"),
                                 (7, "balance"), (5, "width")],
                         ids=["valid", "nonce", "balance_first",
                              "balance_last", "width"])
def test_gather_validate_rows_raises_the_same_error(bad):
    """The port's host pass, its device pass on the CPU (K6's plain
    version) and the reference raise the same error, index and text."""
    rows, world = _rows_and_world(bad)
    outcomes = []
    for run in (
        lambda: pt_batch_exec.gather_validate_rows(world, rows),
        lambda: pt_batch_exec.gather_validate_rows(
            world, rows, device_validate=functools.partial(
                fused.fused_exec_validate, device="cpu")),
        lambda: jx_batch_exec.gather_validate_rows(world, rows),
    ):
        try:
            run()
            outcomes.append(None)
        except Exception as e:  # noqa: BLE001 - compared below
            outcomes.append((type(e).__name__, getattr(e, "index", None),
                             str(e)))
    assert outcomes[0] == outcomes[1] == outcomes[2]
    assert (outcomes[0] is None) == (bad[1] == "none")


def test_device_validate_error_propagates(monkeypatch):
    """A failing device validation stops the block: no host pass runs
    in its place, in gather_validate_rows or through a replay."""
    rows, world = _rows_and_world((None, "none"))

    def boom(*args, **kwargs):
        raise RuntimeError("K6 exec-validate kernel launch failed")

    with pytest.raises(RuntimeError, match="K6"):
        pt_batch_exec.gather_validate_rows(world, rows, device_validate=boom)
    monkeypatch.setattr(fused, "fused_exec_validate", boom)
    make_cfg, spec, wire = _chain("contended_4x30")
    cfg = make_cfg(parallel_tx=True, exec_device=True, adaptive_probe=False)
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(spec)
    pt_sched.reset_learner()
    with pytest.raises(RuntimeError, match="K6"):
        ReplayDriver(bc, cfg, device="cpu").replay(
            [Block.decode(w) for w in wire])
    assert bc.best_block_number == 0


def test_k6_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper checks before it builds or launches: a CPU tensor is
    refused whatever its shape, nothing is built, no launch is
    counted."""
    def no_build():
        raise AssertionError("the kernel library must not be built")

    monkeypatch.setattr(build, "load", no_build)
    launches = exec_validate_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        exec_validate_cuda.validate_rows(torch.zeros((4, 20),
                                                     dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        exec_validate_cuda.validate_rows(torch.zeros((4, 19),
                                                     dtype=torch.int32))
    assert exec_validate_cuda.LAUNCHES == launches
