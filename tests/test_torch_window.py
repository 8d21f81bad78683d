"""The port's windowed, pipelined replay commit (khipu_tpu_torch
ledger/window.py, the staged collector and ReplayDriver.replay_windowed)
against the JAX package's, on the CPU: the same chains, built by the JAX
package's ChainBuilder and round-tripped through wire RLP, replayed by
both drivers. The reference runs its host-hasher path (no XLA compile);
the port runs ``device_commit`` on ``device="cpu"`` with the adaptive
controller off (every window through the plain version of K5 and a CPU
device mirror) and on (the probe holds host mode on a CPU device).

Placeholder prefixes are random per process and per package, so only
real digests are compared: per-block headers, receipts, and the node
sets reachable from the head root (``compact``; dead nodes the window
split leaves behind may differ). Every comparison is byte-exact."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from khipu_tpu.base.crypto import secp256k1 as jx_secp
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain import transaction as jx_tx
from khipu_tpu.domain.block import Block as JxBlock
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.ledger.window import WindowCommitter as JxWindowCommitter
from khipu_tpu.storage.compactor import compact as jx_compact
from khipu_tpu.storage.datasource import (
    MemoryKeyValueDataSource as JxKVSource,
)
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder
from khipu_tpu.sync.journal import WindowJournal as JxWindowJournal
from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver
from khipu_tpu.trie.bulk import host_hasher as jx_host_hasher
from khipu_tpu.trie.mpt import EMPTY_TRIE_HASH as JX_EMPTY

from khipu_tpu_torch import workloads
from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.ledger import window as window_mod
from khipu_tpu_torch.ledger.window import (
    WindowCommitter,
    WindowMismatch,
    WindowPlaceholderError,
)
from khipu_tpu_torch.storage.compactor import compact, verify_reachable
from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync import journal as journal_mod
from khipu_tpu_torch.sync import replay as replay_mod
from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES, ReplayDriver
from khipu_tpu_torch.trie import deferred, fused
from khipu_tpu_torch.trie.bulk import host_hasher
from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH

KEYS = [(i + 1).to_bytes(32, "big") for i in range(4)]
ADDRS = [jx_secp.pubkey_to_address(jx_secp.privkey_to_pubkey(k)) for k in KEYS]
ETH = 10**18
MINER = b"\xaa" * 20
ALLOC = {a: 1000 * ETH for a in ADDRS}

# SSTORE(0, 42), then return a runtime that returns slot 0
RUNTIME = bytes.fromhex("60005460005260206000f3")
_SS = bytes.fromhex("602a600055")
_COPY = bytes(
    [0x60, len(RUNTIME), 0x60, len(_SS) + 12, 0x60, 0, 0x39,
     0x60, len(RUNTIME), 0x60, 0, 0xF3]
)
INIT = _SS + _COPY + RUNTIME


def _tx(i, nonce, to, value, gas=21000, payload=b""):
    return jx_tx.sign_transaction(
        jx_tx.Transaction(nonce, 10**9, gas, to, value, payload),
        KEYS[i], chain_id=1,
    )


def _jx_cfg(window, depth=2, **sync):
    return dataclasses.replace(
        jx_fixture_config(chain_id=1),
        sync=JxSyncConfig(parallel_tx=False, commit_window_blocks=window,
                          pipeline_depth=depth, **sync),
    )


def _pt_cfg(window, depth=2, adaptive=False, **sync):
    return workloads.replay_config(commit_window_blocks=window,
                                   pipeline_depth=depth,
                                   adaptive_commit=adaptive, **sync)


@pytest.fixture(scope="module")
def chain():
    """test_window's 5 blocks: deploy, cross-block call, second deploy +
    transfers, two transfers back. Returns (wire blocks, contract)."""
    cfg = _jx_cfg(1)
    builder = JxChainBuilder(JxBlockchain(JxStorages(), cfg), cfg,
                             JxGenesisSpec(alloc=ALLOC))
    blocks = [builder.add_block(
        [_tx(0, 0, None, 0, gas=300_000, payload=INIT)], coinbase=MINER)]
    caddr = jx_tx.contract_address(ADDRS[0], 0)
    blocks.append(builder.add_block(
        [_tx(0, 1, caddr, 0, gas=100_000), _tx(1, 0, ADDRS[2], 123)],
        coinbase=MINER))
    blocks.append(builder.add_block(
        [_tx(0, 2, None, 1000, gas=300_000, payload=INIT),
         _tx(1, 1, ADDRS[3], 7)], coinbase=MINER))
    blocks.append(builder.add_block([_tx(2, 0, ADDRS[0], 1)], coinbase=MINER))
    blocks.append(builder.add_block([_tx(2, 1, ADDRS[0], 1)], coinbase=MINER))
    return [b.encode() for b in blocks], caddr


def _pt_blocks(wire):
    return [Block.decode(w) for w in wire]


def _jx_replay(wire, cfg):
    bc = JxBlockchain(JxStorages(), cfg)
    bc.load_genesis(JxGenesisSpec(alloc=ALLOC))
    JxReplayDriver(bc, cfg).replay([JxBlock.decode(w) for w in wire])
    return bc


def _pt_chain(cfg):
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc=ALLOC))
    return bc


def _pt_replay(wire, cfg, **driver):
    bc = _pt_chain(cfg)
    drv = ReplayDriver(bc, cfg, device_commit=True, device="cpu", **driver)
    stats = drv.replay(_pt_blocks(wire))
    return bc, drv, stats


class _DictStore:
    """Capture sink for compact(): the reachable subgraph."""

    def __init__(self):
        self.nodes = {}

    def update(self, removes, upserts):
        self.nodes.update(upserts)


def _reachable(storages, root, compact_fn=compact):
    """(account, storage, code) nodes reachable from ``root``."""
    sinks = [_DictStore() for _ in range(3)]
    report = compact_fn(storages.account_node_storage,
                        storages.storage_node_storage,
                        storages.evmcode_storage, root, *sinks)
    assert report.missing == 0
    return tuple(s.nodes for s in sinks)


def _assert_same_chain(pt_bc, jx_bc, n):
    """Headers, receipts and td of blocks 1..n, and the node sets
    reachable from block n's root, equal the reference's."""
    for i in range(1, n + 1):
        header = pt_bc.get_header_by_number(i)
        assert header.encode() == jx_bc.get_header_by_number(i).encode()
        assert (pt_bc.storages.receipts_storage.get(i)
                == jx_bc.storages.receipts_storage.get(i))
        assert pt_bc.get_total_difficulty(i) == jx_bc.get_total_difficulty(i)
    root = pt_bc.get_header_by_number(n).state_root
    got = _reachable(pt_bc.storages, root)
    assert got == _reachable(jx_bc.storages, root, jx_compact)
    assert all(got)  # accounts, storage and code all reached
    assert pt_bc.best_block_number == jx_bc.best_block_number == n


class TestWindowedReplay:
    def test_window1_device_path_uses_hasher(self, chain):
        """window=1 with a device hasher: the in-place root validation
        flushes with THAT hasher, not the eager host path."""
        wire, _ = chain
        calls = [0]

        def counting_hasher(msgs):
            calls[0] += 1
            return host_hasher(msgs)

        cfg = _pt_cfg(1)
        bc = _pt_chain(cfg)
        driver = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        driver.hasher = counting_hasher
        stats = driver.replay(_pt_blocks(wire))
        assert stats.blocks == 5
        assert calls[0] > 0, "batched hasher never ran on the w=1 path"
        assert bc.get_header_by_number(5).hash == _pt_blocks(wire)[-1].hash

    @pytest.mark.parametrize("adaptive", [False, True],
                             ids=["plain_k5", "adaptive"])
    @pytest.mark.parametrize("window", [2, 3, 5, 8])
    def test_windowed_equals_reference(self, chain, window, adaptive):
        """Any window size: the same headers, receipts and reachable
        nodes as the JAX package's windowed replay, readable from the
        persisted stores alone."""
        wire, caddr = chain
        jx_bc = _jx_replay(wire, _jx_cfg(window))
        cfg = _pt_cfg(window, adaptive=adaptive)
        bc, drv, stats = _pt_replay(wire, cfg)
        assert (stats.blocks, stats.txs) == (5, 7)
        _assert_same_chain(bc, jx_bc, 5)
        head = bc.get_header_by_number(5).state_root
        bc.storages.detach_mirror()  # persisted-store-only reads
        world = Blockchain(bc.storages, cfg).get_world_state(head)
        assert world.get_storage(caddr, 0) == 42
        assert world.get_code(caddr) == bytes.fromhex(
            "60005460005260206000f3")
        report = verify_reachable(
            bc.storages.account_node_storage,
            bc.storages.storage_node_storage,
            bc.storages.evmcode_storage, head, verify_hashes=True,
        )
        assert report.missing == 0 and report.corrupt == 0
        assert drv.adaptive is None if not adaptive else (
            drv.adaptive.mode() == "host")

    def test_cross_block_reads_inside_window(self, chain):
        """Block 2 calls the contract block 1 deployed, both inside ONE
        open window — the staged read-through is load-bearing."""
        wire, _ = chain
        bc, _, _ = _pt_replay(wire, _pt_cfg(5))
        assert bc.get_header_by_number(5).hash == _pt_blocks(wire)[-1].hash

    def test_mismatch_pinpoints_block(self, chain):
        wire, _ = chain
        blocks = _pt_blocks(wire)
        bad = Block(dataclasses.replace(blocks[2].header,
                                        state_root=b"\x13" * 32),
                    blocks[2].body)
        cfg = _pt_cfg(4)
        with pytest.raises(WindowMismatch) as e:
            ReplayDriver(_pt_chain(cfg), cfg, validate_headers=False,
                         device_commit=True, device="cpu").replay(
                [blocks[0], blocks[1], bad])
        assert e.value.number == 3

    def test_pre_byzantium_window_rejected(self, chain):
        wire, _ = chain
        cfg = dataclasses.replace(
            workloads.replay_config(), blockchain=dataclasses.replace(
                workloads.replay_config().blockchain, byzantium_block=10**9),
            sync=dataclasses.replace(_pt_cfg(4).sync))
        with pytest.raises(ValueError, match="Byzantium"):
            ReplayDriver(_pt_chain(cfg), cfg, validate_headers=False,
                         device_commit=True, device="cpu").replay(
                _pt_blocks(wire)[:2])

    def test_balance_accounting_through_windows(self, chain):
        wire, _ = chain
        bc, _, _ = _pt_replay(wire, _pt_cfg(3))
        root = bc.get_header_by_number(5).state_root
        # ADDRS[2]: +123 (block 2), then sent 1 wei twice with fees
        acc = bc.get_account(ADDRS[2], root)
        assert acc.balance == 1000 * ETH + 123 - 2 * (21000 * 10**9 + 1)
        assert acc.nonce == 2

    def test_epoch_reset_and_staged_prune(self, chain):
        """The epoch reset rebuilds the session committer after every
        window without changing any result: still the reference's
        chain, readable from the persisted stores alone."""
        wire, caddr = chain
        cfg = _pt_cfg(2)
        bc = _pt_chain(cfg)
        driver = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        driver.session_epoch_blocks = 2  # reset after every window
        made = []
        orig = replay_mod.WindowCommitter

        def spy(*a, **kw):
            made.append(orig(*a, **kw))
            return made[-1]

        replay_mod.WindowCommitter = spy
        try:
            stats = driver.replay(_pt_blocks(wire))
        finally:
            replay_mod.WindowCommitter = orig
        assert stats.blocks == 5 and len(made) == 3
        _assert_same_chain(bc, _jx_replay(wire, _jx_cfg(2)), 5)
        bc.storages.detach_mirror()
        world = Blockchain(bc.storages, cfg).get_world_state(
            bc.get_header_by_number(5).state_root)
        assert world.get_storage(caddr, 0) == 42

    def test_collect_prunes_session_memory(self, chain, monkeypatch):
        """After the last window persists the committer's staged dict is
        empty (all placeholders resolved and pruned)."""
        wire, _ = chain
        seen = []
        orig = WindowCommitter.persist

        def spy(self, job):
            r = orig(self, job)
            seen.append((len(self._staged), len(self._resolved_global)))
            return r

        monkeypatch.setattr(WindowCommitter, "persist", spy)
        _pt_replay(wire, _pt_cfg(5))
        assert seen, "persist never ran"
        staged_left, resolved = seen[-1]
        assert staged_left == 0 and resolved > 0

    def test_mismatch_after_pipeline_overlap_persists_nothing(self, chain):
        """A root mismatch in window N surfaces at its collect — after
        window N+1 already executed. Nothing from either window reaches
        block storage."""
        wire, _ = chain
        blocks = _pt_blocks(wire)
        bad = Block(dataclasses.replace(blocks[1].header,
                                        state_root=b"\x55" * 32),
                    blocks[1].body)
        cfg = _pt_cfg(2)
        bc = _pt_chain(cfg)
        with pytest.raises(WindowMismatch) as e:
            ReplayDriver(bc, cfg, validate_headers=False, device_commit=True,
                         device="cpu").replay(
                [blocks[0], bad, blocks[2], blocks[3]])
        assert e.value.number == 2
        assert bc.get_header_by_number(1) is None
        assert bc.get_header_by_number(2) is None


class TestDeepPipeline:
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_pipeline_depth_equals_reference(self, chain, depth):
        """Any pipeline depth: collects run FIFO on the stage threads,
        every root gates, and the chain is the reference's."""
        wire, _ = chain
        bc, _, stats = _pt_replay(wire, _pt_cfg(2, depth))
        assert stats.blocks == 5
        assert 0.0 <= stats.pipeline_occupancy <= 1.0
        assert set(stats.phases) == set(replay_mod.WINDOWED_PHASES)
        _assert_same_chain(bc, _jx_replay(wire, _jx_cfg(2, depth)), 5)
        assert PIPELINE_GAUGES["depth"] == depth
        assert PIPELINE_GAUGES["in_flight"] == 0
        assert bc.storages.window_journal.pending() == []
        assert bc.storages.window_journal.depth == 0  # pruned

    def test_cross_window_tiles_bit_exact_vs_finalize(self):
        """seal(N+1) while window N is STILL IN FLIGHT: refs into N ride
        the fused dispatch as resolved-input tile rows. The collected
        state equals the one-window host finalize — the port's and the
        reference's — root and reachable node set."""

        def put_range(committer, rng):
            trie = committer.account_trie
            for i in rng:
                trie = trie.put(
                    address_key(i.to_bytes(20, "big")),
                    Account(nonce=i, balance=10**18 + i).encode(),
                )
            committer.account_trie = trie

        fused_cm = WindowCommitter(Storages(), EMPTY_TRIE_HASH,
                                   hasher=host_hasher, fused=True,
                                   device="cpu")
        put_range(fused_cm, range(30))
        job1 = fused_cm.seal()
        fused_cm.pack_and_dispatch(job1)
        assert job1.fused_job is not None, "fused path not taken"
        assert fused_cm._inflight_rows, "window 1 not registered in flight"
        put_range(fused_cm, range(30, 60))
        root_ref = fused_cm.account_trie.force_hashed_root()
        job2 = fused_cm.seal()
        gathered = []
        orig = fused.ExtRows.tile

        def spy(self, device):
            out = orig(self, device)
            gathered.append((out, dict(self.pos)))
            return out

        fused.ExtRows.tile = spy
        try:
            fused_cm.pack_and_dispatch(job2)  # against in-flight window 1
        finally:
            fused.ExtRows.tile = orig
        w1_phs = set(job1.to_resolve)
        refs = set()
        for enc in job2.to_resolve.values():
            pos = enc.find(deferred._PLACEHOLDER_PREFIX)
            while pos >= 0:
                refs.add(enc[pos : pos + 32])
                pos = enc.find(deferred._PLACEHOLDER_PREFIX, pos + 32)
        assert refs & w1_phs, "no cross-window refs — test is vacuous"
        (tile, ext_pos), = gathered
        assert set(ext_pos) == refs & w1_phs
        assert tile.shape == (len(ext_pos), 32)
        fused_cm.collect(job1)
        fused_cm.collect(job2)
        assert not fused_cm._inflight_rows
        real_root = fused_cm._resolved_global[root_ref]

        host = WindowCommitter(Storages(), EMPTY_TRIE_HASH,
                               hasher=host_hasher, fused=False)
        put_range(host, range(60))
        host_ref = host.account_trie.force_hashed_root()
        host.finalize()
        assert host._resolved_global[host_ref] == real_root
        assert (_reachable(fused_cm.storages, real_root)
                == _reachable(host.storages, real_root))

        ref = JxWindowCommitter(JxStorages(), JX_EMPTY,
                                hasher=jx_host_hasher, fused=False)
        trie = ref.account_trie
        for i in range(60):
            trie = trie.put(
                address_key(i.to_bytes(20, "big")),
                Account(nonce=i, balance=10**18 + i).encode(),
            )
        ref.account_trie = trie
        ref_ref = trie.force_hashed_root()
        ref.finalize()
        assert ref._resolved_global[ref_ref] == real_root
        assert (_reachable(ref.storages, real_root, jx_compact)
                == _reachable(fused_cm.storages, real_root))

    def test_pipeline_under_fast_thread_switching(self, chain):
        """The stage threads, the prefetch thread and the driver share
        the session's dicts and the mirror: with the interpreter switching
        threads every microsecond, one-block windows at depth 4 still
        persist the reference's chain, and the mirror's rows stay
        claim-consistent."""
        import sys

        wire, _ = chain
        cfg = _pt_cfg(1, 4)
        bc = _pt_chain(cfg)
        drv = ReplayDriver(bc, cfg, device_commit=True, device="cpu")
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            stats = drv.replay_windowed(iter(_pt_blocks(wire)), 1)
        finally:
            sys.setswitchinterval(old)
        assert stats.blocks == 5
        _assert_same_chain(bc, _jx_replay(wire, _jx_cfg(1, 4)), 5)
        assert drv._mirror.verify() == 0
        assert drv._mirror.unspilled_count == 0

    def test_mid_pipeline_mismatch_drains_and_persists_nothing(self, chain):
        """Corrupt root in the FIRST of five one-block windows at depth
        4: the pipeline aborts, queued windows are dropped, the mismatch
        names the block, and NO window reaches block storage."""
        wire, _ = chain
        blocks = _pt_blocks(wire)
        bad = Block(dataclasses.replace(blocks[0].header,
                                        state_root=b"\x66" * 32),
                    blocks[0].body)
        cfg = _pt_cfg(1, 4)
        bc = _pt_chain(cfg)
        driver = ReplayDriver(bc, cfg, validate_headers=False,
                              device_commit=True, device="cpu")
        with pytest.raises(WindowMismatch) as e:
            driver.replay_windowed(iter([bad] + blocks[1:]), 1)
        assert e.value.number == 1
        for n in range(1, 6):
            assert bc.get_header_by_number(n) is None
        assert PIPELINE_GAUGES["in_flight"] == 0
        # the failed window's intent stays pending: it never committed
        assert [r.lo for r in bc.storages.window_journal.pending()][:1] == [1]

    def test_live_placeholder_skipped_at_seal_names_index(self):
        """A live placeholder with no staged encoding (a foreign
        counter range) raises WindowPlaceholderError with its index."""
        committer = WindowCommitter(Storages(), EMPTY_TRIE_HASH)
        trie = committer.account_trie
        for i in range(4):
            trie = trie.put(address_key(i.to_bytes(20, "big")),
                            Account(nonce=i, balance=1).encode())
        committer.account_trie = trie
        job = committer.seal()
        ghost = deferred._make_placeholder(10**9)
        job.live[ghost] = 1
        with pytest.raises(WindowPlaceholderError) as e:
            committer.collect(job)
        assert e.value.index == 10**9
        assert str(10**9) in str(e.value)

    def test_dead_stage_thread_degrades_to_synchronous_commits(
            self, chain, monkeypatch):
        """A stage thread that dies mid-job (exits without recording a
        failure) is caught by the liveness checks; the driver re-runs
        the torn job and commits the rest synchronously — the same
        chain as the reference's."""
        wire, _ = chain
        orig = replay_mod._WindowCollector._run

        def run(self, i):
            if i == 2:  # the persist stage dies at its first job
                with self._cv:
                    while not self._qs[i]:
                        self._cv.wait(timeout=0.05)
                    self._current[i] = self._qs[i].popleft()
                    self._active[i] = True
                return
            return orig(self, i)

        monkeypatch.setattr(replay_mod._WindowCollector, "_run", run)
        deaths = PIPELINE_GAUGES["collector_deaths"]
        bc, _, stats = _pt_replay(wire, _pt_cfg(2))
        assert PIPELINE_GAUGES["collector_deaths"] == deaths + 1
        assert stats.blocks == 5
        _assert_same_chain(bc, _jx_replay(wire, _jx_cfg(2)), 5)
        assert bc.storages.window_journal.pending() == []


class TestDeviceMirrorCommit:
    def test_collect_fetches_roots_only_and_persist_collects(
            self, chain, monkeypatch):
        """The mirror is the commit target: the collect stage reads only
        the per-block root digests (``fetch_rows``, 32 B a block) and the
        full digest copy (``FusedJob.collect``) runs only on the persist
        stage; the persisted chain is the reference's and the mirror's
        rows are claim-consistent."""
        import threading

        wire, caddr = chain
        calls = []
        FJ = fused.FusedJob
        orig_fetch, orig_collect = FJ.fetch_rows, FJ.collect

        def fetch_rows(self, refs):
            out = orig_fetch(self, refs)
            calls.append(("fetch_rows", threading.current_thread().name,
                          32 * len(out), len(refs)))
            return out

        def collect(self):
            calls.append(("collect", threading.current_thread().name))
            return orig_collect(self)

        monkeypatch.setattr(FJ, "fetch_rows", fetch_rows)
        monkeypatch.setattr(FJ, "collect", collect)
        bc, drv, stats = _pt_replay(wire, _pt_cfg(2))
        assert stats.blocks == 5
        fetches = [c for c in calls if c[0] == "fetch_rows"]
        collects = [c for c in calls if c[0] == "collect"]
        # 3 windows of 2, 2 and 1 blocks: one fetch each, 32 B a block
        assert [c[1:] for c in fetches] == [
            ("window-collect", 64, 2), ("window-collect", 64, 2),
            ("window-collect", 32, 1)]
        assert [c[1] for c in collects] == ["window-persist"] * 3
        _assert_same_chain(bc, _jx_replay(wire, _jx_cfg(2)), 5)
        world = bc.get_world_state(bc.get_header_by_number(5).state_root)
        assert world.get_storage(caddr, 0) == 42
        mirror = drv._mirror
        assert mirror is not None and mirror.resident_count > 0
        assert mirror.unspilled_count == 0
        assert mirror.verify() == 0

    def test_retired_jobs_release_device_buffers(self, chain, monkeypatch):
        """Every fused job frees its encodings at the mirror admit and
        its digests once the window retires — device memory stays
        O(in-flight windows)."""
        released, encs_released = [], []
        FJ = fused.FusedJob
        orig_release, orig_encs = FJ.release, FJ.release_encs

        def spy_release(self):
            released.append(self)
            return orig_release(self)

        def spy_encs(self):
            encs_released.append(self)
            return orig_encs(self)

        monkeypatch.setattr(FJ, "release", spy_release)
        monkeypatch.setattr(FJ, "release_encs", spy_encs)
        wire, _ = chain
        _, _, stats = _pt_replay(wire, _pt_cfg(2))
        assert stats.blocks == 5
        assert len(encs_released) == 3 and len(released) == 3
        for job in released:
            assert job.digests is None and job.encs is None

    def test_slow_admit_path_equals_fast_path(self, chain, monkeypatch):
        """admit_mirror's slow path (the live rows gathered from the
        final encodings by ``index_select``) lands the same rows as the
        fast path the launch gathers (``admit_tiles``)."""
        wire, _ = chain
        fast_bc, fast_drv, _ = _pt_replay(wire, _pt_cfg(2))
        orig = fused.fused_submit

        def no_admit(*a, **kw):
            kw["admit_live"] = None
            return orig(*a, **kw)

        monkeypatch.setattr(fused, "fused_submit", no_admit)
        slow_bc, slow_drv, _ = _pt_replay(wire, _pt_cfg(2))
        root = fast_bc.get_header_by_number(5).state_root
        assert (_reachable(slow_bc.storages, root)
                == _reachable(fast_bc.storages, root))
        assert (slow_drv._mirror.resident_count
                == fast_drv._mirror.resident_count > 0)
        assert slow_drv._mirror.verify() == 0


class TestJournal:
    def _pair(self):
        return (JxWindowJournal(JxKVSource()),
                journal_mod.WindowJournal(MemoryKeyValueDataSource()))

    def test_records_byte_equal_to_reference(self):
        """log_intent / log_commit / prune / pending over the same calls
        leave byte-equal key-value sources and read the same records."""
        ref, port = self._pair()
        roots = [bytes([i]) * 32 for i in range(6)]
        for lo, hi in ((1, 2), (3, 4), (5, 5)):
            assert (port.log_intent(lo, hi, roots[lo - 1], roots[lo:hi + 1])
                    == ref.log_intent(lo, hi, roots[lo - 1],
                                      roots[lo:hi + 1]))
        port.log_commit(0)
        ref.log_commit(0)
        port.log_commit(2)
        ref.log_commit(2)
        assert port.source._map == ref.source._map
        assert ([vars(r) for r in port.pending()]
                == [vars(r) for r in ref.pending()])
        assert [r.seq for r in port.pending()] == [1]
        assert port.prune() == ref.prune() == 1  # stops at pending 1
        assert port.source._map == ref.source._map
        port.log_commit(1)
        ref.log_commit(1)
        assert port.prune() == ref.prune() == 2
        assert port.source._map == ref.source._map
        assert port.depth == ref.depth == 0
        with pytest.raises(ValueError, match="one expected root"):
            port.log_intent(1, 3, roots[0], roots[:2])

    def test_reads_reference_reorg_records(self):
        """A reorg intent written by the reference reads back through the
        port's ``pending`` and its staged branch goes with ``prune``."""
        from khipu_tpu.domain.block import Block as RefBlock
        from khipu_tpu.domain.block import BlockBody as RefBody
        from khipu_tpu.domain.block_header import BlockHeader as RefHeader

        src = JxKVSource()
        ref = JxWindowJournal(src)
        header = RefHeader(
            parent_hash=b"\x01" * 32, ommers_hash=b"\x02" * 32,
            beneficiary=MINER, state_root=b"\x03" * 32,
            transactions_root=b"\x04" * 32, receipts_root=b"\x05" * 32,
            logs_bloom=bytes(256), difficulty=1, number=8, gas_limit=1,
            gas_used=0, unix_timestamp=1, extra_data=b"",
            mix_hash=b"\x00" * 32, nonce=b"\x00" * 8,
        )
        seq = ref.log_reorg_intent(7, b"\x07" * 32, [b"\x08" * 32],
                                   [RefBlock(header, RefBody())])
        port = journal_mod.WindowJournal(src)
        (rec,) = port.pending()
        assert isinstance(rec, journal_mod.ReorgRecord)
        assert vars(rec) == vars(ref.pending()[0])
        port.log_commit(seq)
        assert len(src._map) == 4  # intent, staged block, mark, head
        assert port.prune() == 1
        assert set(src._map) == {b"head", b"tail"}


def test_device_errors_propagate(chain, monkeypatch):
    """A failed build or launch of the fused dispatch is not caught: the
    replay stops with the device's error, whatever its type, and no
    window is hashed on the host in its place."""
    wire, _ = chain
    host_windows = window_mod.WINDOW_GAUGES["host_windows"]
    for err in (RuntimeError("CUDA error: an illegal memory access"),
                ValueError("depth 1 < the DAG's 2 levels")):

        def broken(*a, _err=err, **kw):
            raise _err

        monkeypatch.setattr(fused, "fused_submit", broken)
        with pytest.raises(type(err), match=str(err)[:10]):
            _pt_replay(wire, _pt_cfg(2))
    assert window_mod.WINDOW_GAUGES["host_windows"] == host_windows


def test_ext_rows_fills_the_tile_during_the_scan():
    """An ``ExtRows`` tile filled by ``pack``'s scan, its refs half host
    digests and half rows of two earlier "launches" (digest tensors,
    rows shuffled), resolves the same digests and final encodings as
    the explicit ``(tile, pos)`` the JAX package's fused_submit takes;
    the tile holds only the rows referenced, in first-seen order, and a
    lookup that answers None leaves a ref alone."""
    from khipu_tpu.trie import bulk as ref_bulk
    from khipu_tpu.trie import deferred as ref_deferred
    from tests.test_torch_trie import _ref_session, _rows_by_key

    session = _ref_session(4)
    to_resolve, deps, _ = ref_deferred.resolution_inputs(session)
    _, truth = ref_deferred.finalize(
        session, ref_bulk.host_hasher, return_mapping=True
    )
    rng = random.Random(5)
    moved = rng.sample(fused.topo_levels(deps)[0], 40)
    tensors = []
    sources = {}
    for part in (moved[10:25], moved[25:]):
        keys = part + [None] * 3
        rng.shuffle(keys)
        t = torch.from_numpy(np.stack([
            np.frombuffer(truth[k] if k else bytes(32), np.uint8)
            for k in keys
        ]))
        tensors.append(t)
        sources.update({k: (t, r) for r, k in enumerate(keys) if k})
    sources.update({k: truth[k] for k in moved[:10]})
    asked = []

    def lookup(ref):
        asked.append(ref)
        return sources.get(ref)

    moved_set = set(moved)
    tr = {ph: e for ph, e in to_resolve.items() if ph not in moved_set}
    prefix = ref_deferred._PLACEHOLDER_PREFIX
    ext = fused.ExtRows(lookup)
    job = fused.fused_submit(tr, None, prefix, device="cpu", ext=ext)
    assert job.collect() == {ph: truth[ph] for ph in tr}
    assert set(ext.pos) == moved_set and len(set(asked)) == len(asked)
    tile = ext.tile("cpu")
    assert sorted(ext.pos.values()) == list(range(len(moved)))
    for ph, row in ext.pos.items():
        assert bytes(tile[row].numpy()) == truth[ph]

    explicit = fused.fused_submit(
        tr, None, prefix, device="cpu", ext=(tile, dict(ext.pos)))
    assert _rows_by_key(job) == _rows_by_key(explicit)
    hidden = fused.ExtRows(lambda ref: None)
    missing = fused.fused_submit(tr, None, prefix, device="cpu", ext=hidden)
    assert not hidden.pos and missing.collect() != job.collect()
