"""The port's execution closure against the JAX package's: codecs,
secp256k1, the host Keccak, block execution, the VM backend switch and
the counters the sender-prefetch thread shares with the driver. Inputs
are seeded; every comparison is byte-exact."""

import dataclasses
import functools
import os
import sys
import threading

import numpy as np
import pytest

from khipu_tpu.base.crypto import keccak as jx_keccak
from khipu_tpu.base.crypto import secp256k1 as jx_secp
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain import block as jx_block
from khipu_tpu.domain import block_header as jx_header
from khipu_tpu.domain import receipt as jx_receipt
from khipu_tpu.domain import transaction as jx_tx
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder

from khipu_tpu_torch import observability
from khipu_tpu_torch.base import keccak as pt_keccak
from khipu_tpu_torch.base import secp256k1 as pt_secp
from khipu_tpu_torch.config import SyncConfig, fixture_config
from khipu_tpu_torch.domain import block as pt_block
from khipu_tpu_torch.domain import block_header as pt_header
from khipu_tpu_torch.domain import receipt as pt_receipt
from khipu_tpu_torch.domain import transaction as pt_tx
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.evm import dispatch
from khipu_tpu_torch.ledger.bloom import bloom_union
from khipu_tpu_torch.ledger.ledger import execute_block
from khipu_tpu_torch.native import build as native_build
from khipu_tpu_torch.native import keccak as native_keccak
from khipu_tpu_torch.ops import keccak_cuda
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.trie.bulk import device_hasher

RNG_SEED = 20261017
COINBASE = b"\xaa" * 20
GWEI = 10**9
# LOG1(topic = calldata word 0, data = caller) then STOP
LOGGER_RUNTIME = bytes([0x33, 0x60, 0x00, 0x52, 0x60, 0x00, 0x35, 0x60, 0x20,
                        0x60, 0x00, 0xA1, 0x00])
LOGGER_INIT = bytes([0x60, len(LOGGER_RUNTIME), 0x60, 0x0C, 0x60, 0x00, 0x39,
                     0x60, len(LOGGER_RUNTIME), 0x60, 0x00, 0xF3]) + LOGGER_RUNTIME


def _keys(n, base):
    keys = [(base + i).to_bytes(32, "big") for i in range(n)]
    return keys, [jx_secp.pubkey_to_address(jx_secp.privkey_to_pubkey(k))
                  for k in keys]


# ------------------------------------------------------------- codecs


def _tx_fields(rng, i):
    to = None if i % 5 == 0 else rng.bytes(20)
    return dict(nonce=int(rng.integers(0, 2**40)),
                gas_price=int(rng.integers(1, 2**50)),
                gas_limit=int(rng.integers(21000, 2**30)), to=to,
                value=int(rng.integers(0, 2**62)) * 2**100,
                payload=rng.bytes(int(rng.integers(0, 300))))


@pytest.mark.parametrize("chain_id", [None, 1, 61])
def test_transaction_codec_matches_reference(chain_id):
    rng = np.random.default_rng(RNG_SEED)
    for i in range(12):
        fields = _tx_fields(rng, i)
        key = rng.bytes(32)
        jx = jx_tx.sign_transaction(jx_tx.Transaction(**fields), key,
                                    chain_id=chain_id)
        pt = pt_tx.sign_transaction(pt_tx.Transaction(**fields), key,
                                    chain_id=chain_id)
        assert pt.encode() == jx.encode()
        assert pt.hash == jx.hash
        assert pt_tx.SignedTransaction.decode(jx.encode()).encode() == jx.encode()
        assert jx_tx.SignedTransaction.decode(pt.encode()).encode() == pt.encode()
        assert pt.sender == jx.sender == jx_secp.pubkey_to_address(
            jx_secp.privkey_to_pubkey(key))


def _receipts(mod, rng, pre_byzantium):
    out = []
    for i in range(6):
        logs = tuple(
            mod.TxLogEntry(rng.bytes(20),
                           tuple(rng.bytes(32) for _ in range(j % 4)),
                           rng.bytes(int(rng.integers(0, 90))))
            for j in range(i % 3)
        )
        post = rng.bytes(32) if pre_byzantium else i % 2
        out.append(mod.Receipt(post, 21000 * (i + 1), rng.bytes(256), logs))
    return out


@pytest.mark.parametrize("pre_byzantium", [False, True])
def test_receipt_codec_matches_reference(pre_byzantium):
    jx = _receipts(jx_receipt, np.random.default_rng(RNG_SEED), pre_byzantium)
    pt = _receipts(pt_receipt, np.random.default_rng(RNG_SEED), pre_byzantium)
    for a, b in zip(jx, pt):
        assert a.encode() == b.encode()
        assert pt_receipt.Receipt.decode(a.encode()).encode() == a.encode()
    assert pt_receipt.encode_receipts(pt) == jx_receipt.encode_receipts(jx)
    assert [r.encode() for r in pt_receipt.decode_receipts(
        jx_receipt.encode_receipts(jx))] == [r.encode() for r in jx]


def _header_fields(rng, number):
    return dict(
        parent_hash=rng.bytes(32), ommers_hash=rng.bytes(32),
        beneficiary=rng.bytes(20), state_root=rng.bytes(32),
        transactions_root=rng.bytes(32), receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256), difficulty=int(rng.integers(1, 2**60)),
        number=number, gas_limit=int(rng.integers(5000, 2**40)),
        gas_used=int(rng.integers(0, 5000)),
        unix_timestamp=int(rng.integers(0, 2**40)),
        extra_data=rng.bytes(int(rng.integers(0, 33))),
        mix_hash=rng.bytes(32), nonce=rng.bytes(8),
    )


def test_header_and_block_codec_match_reference():
    rng = np.random.default_rng(RNG_SEED)
    for number in (0, 1, 46147, 15_500_000):
        fields = _header_fields(rng, number)
        jh = jx_header.BlockHeader(**fields)
        ph = pt_header.BlockHeader(**fields)
        assert ph.encode() == jh.encode() and ph.hash == jh.hash
        assert ph.encode_without_nonce() == jh.encode_without_nonce()
        assert pt_header.BlockHeader.decode(jh.encode()) == ph
        key = rng.bytes(32)
        txs = [_tx_fields(rng, i) for i in range(3)]
        jb = jx_block.Block(jh, jx_block.BlockBody(
            tuple(jx_tx.sign_transaction(jx_tx.Transaction(**f), key, 1)
                  for f in txs),
            (jx_header.BlockHeader(**_header_fields(rng, number + 1)),)))
        pb = pt_block.Block.decode(jb.encode())
        assert pb.encode() == jb.encode() and pb.hash == jb.hash
        assert pb.body.encode() == jb.body.encode()


# ----------------------------------------------------- crypto natives


def test_native_keccak_matches_oracles():
    rng = np.random.default_rng(RNG_SEED)
    msgs = [rng.bytes(n) for n in (0, 1, 31, 32, 135, 136, 137, 271, 272,
                                   1000, 4096)]
    want = [pt_keccak.keccak256_py(m) for m in msgs]
    assert [pt_keccak.keccak256(m) for m in msgs] == want
    assert [native_keccak.keccak256(m) for m in msgs] == want
    assert [jx_keccak.keccak256(m) for m in msgs] == want


def test_secp256k1_matches_reference_and_oracle():
    rng = np.random.default_rng(RNG_SEED)
    items = []
    for _ in range(8):
        key, msg = rng.bytes(32), rng.bytes(32)
        pub = pt_secp.privkey_to_pubkey(key)
        assert pub == jx_secp.privkey_to_pubkey(key)
        sig = pt_secp.ecdsa_sign(msg, key)
        assert sig == jx_secp.ecdsa_sign(msg, key)
        recid, r, s = sig
        assert pt_secp.ecdsa_recover(msg, recid, r, s) == pub
        assert pt_secp.ecdsa_recover(msg, recid, r, s, native=False) == pub
        assert pt_secp.pubkey_to_address(pub) == jx_secp.pubkey_to_address(pub)
        items.append((msg, recid, r, s))
    # invalid entries: r = 0, a short hash, recid out of range
    items += [(items[0][0], 0, 0, 5), (b"\x01" * 31, 0, 5, 5),
              (items[0][0], 7, items[0][2], items[0][3])]
    got = pt_secp.ecdsa_recover_batch(items)
    assert got == pt_secp.ecdsa_recover_batch_py(items)
    assert got == jx_secp.ecdsa_recover_batch(items)
    assert got[-3:] == [None, None, None]


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """A g++ failure raises: nothing falls back to the pure-Python
    paths."""
    (tmp_path / "broken.cc").write_text("int khipu_broken( {\n")
    monkeypatch.setattr(native_build, "CSRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.load_library()
    assert not list((tmp_path / "_build").glob("*.so"))


# ------------------------------------------------------ block execution


def _execute_fixture(fork_block):
    """One block built by the JAX package's ChainBuilder on the host: a
    logger contract deployed in block 1; block 2 holds transfers (one to
    a new account), a call that logs, a call that runs out of gas and a
    second deploy, several from one sender."""
    cfg = jx_fixture_config(chain_id=1, fork_block=fork_block)
    cfg = dataclasses.replace(cfg, sync=JxSyncConfig(parallel_tx=False))
    chain_id = 1 if fork_block == 0 else None
    keys, addrs = _keys(3, 40)
    alloc = {a: 10**22 for a in addrs}
    builder = JxChainBuilder(JxBlockchain(JxStorages(), cfg), cfg,
                             JxGenesisSpec(alloc=alloc))

    def sign(i, nonce, to, value=0, payload=b"", gas=200_000):
        return jx_tx.sign_transaction(
            jx_tx.Transaction(nonce, GWEI, gas, to, value, payload=payload),
            keys[i], chain_id=chain_id)

    b1 = builder.add_block([sign(0, 0, None, payload=LOGGER_INIT)],
                           coinbase=COINBASE)
    logger = jx_tx.contract_address(addrs[0], 0)
    # calldata gas: 16 a nonzero byte from Istanbul, 68 before
    oog = 21000 + 32 * (16 if fork_block == 0 else 68) + 100
    b2 = builder.add_block([
        sign(1, 0, addrs[2], 10**18, gas=21000),
        sign(1, 1, b"\x5e" * 20, 12345, gas=21000),
        sign(2, 0, logger, payload=b"\x07" * 32),
        sign(0, 1, logger, payload=b"\x09" * 32, gas=oog),  # out of gas
        sign(2, 1, logger, payload=b"\x0b" * 32),
        sign(0, 2, None, payload=LOGGER_INIT),
    ], coinbase=COINBASE)
    return alloc, [b1, b2], builder


@pytest.mark.parametrize("fork_block", [0, 100],
                         ids=["all_forks", "frontier"])
def test_execute_block_matches_reference(fork_block):
    """The port's execute_block (device_hasher on the CPU for the
    root check) gives the JAX-built block's receipts, gas, bloom and
    post root; at Frontier the receipts carry intermediate roots."""
    alloc, blocks, builder = _execute_fixture(fork_block)
    cfg = dataclasses.replace(fixture_config(chain_id=1, fork_block=fork_block),
                              sync=SyncConfig(parallel_tx=False))
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc=alloc))
    hasher = functools.partial(device_hasher, device="cpu")
    root = bc.get_header_by_number(0).state_root
    for jb in blocks:
        block = pt_block.Block.decode(jb.encode())
        result = execute_block(block, root, bc.get_world_state, cfg,
                               hasher=hasher)
        want = builder.blockchain.get_receipts(block.number)
        assert [r.encode() for r in result.receipts] == [r.encode() for r in want]
        assert result.gas_used == block.header.gas_used
        assert bloom_union(r.logs_bloom for r in result.receipts) == \
            block.header.logs_bloom
        assert result.world.account_trie.root_hash == block.header.state_root
        bc.save_block(block, result.receipts, 0, result.world, hasher=hasher)
        root = block.header.state_root
    assert any(r.logs for r in result.receipts)
    assert result.receipts[3].logs == ()  # the out-of-gas call
    assert any(isinstance(r.post_tx_state, bytes) for r in result.receipts) == \
        (fork_block > 0)


def test_parallel_tx_raises_for_more_than_one_tx():
    """The name is older than the port's parallel executors: at the
    default ``parallel_tx`` a block of several transactions no longer
    raises but runs the scheduled executor (its residue, for the logger
    calls and the creations) and gives the JAX-built block's receipts."""
    alloc, blocks, builder = _execute_fixture(0)
    cfg = fixture_config(chain_id=1)  # parallel_tx defaults to True
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc=alloc))
    root = bc.get_header_by_number(0).state_root
    # one tx a block runs serially, as in the reference
    b1 = pt_block.Block.decode(blocks[0].encode())
    result = execute_block(b1, root, bc.get_world_state, cfg)
    assert result.stats.residue_txs == result.stats.parallel_count == 0
    bc.save_block(b1, result.receipts, 0, result.world)
    b2 = pt_block.Block.decode(blocks[1].encode())
    result = execute_block(b2, b1.header.state_root, bc.get_world_state, cfg)
    want = builder.blockchain.get_receipts(b2.number)
    assert [r.encode() for r in result.receipts] == [r.encode() for r in want]
    assert result.world.account_trie.root_hash == b2.header.state_root
    assert result.stats.residue_txs + result.stats.fast_path_txs == 6


def _execute_block1(how, backend, monkeypatch):
    """Block 1 of the execute fixture (the logger deploy), with the VM
    backend forced by ``set_backend`` or by the environment; returns the
    receipts' encodings and the frames each backend ran."""
    alloc, blocks, _ = _execute_fixture(0)
    cfg = dataclasses.replace(fixture_config(chain_id=1),
                              sync=SyncConfig(parallel_tx=False))
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc=alloc))
    if how == "env":
        monkeypatch.setenv("KHIPU_VM_BACKEND", backend)
    else:
        dispatch.set_backend(backend)
    before = dict(dispatch.VM_GAUGES)
    try:
        result = execute_block(pt_block.Block.decode(blocks[0].encode()),
                               bc.get_header_by_number(0).state_root,
                               bc.get_world_state, cfg)
    finally:
        dispatch.set_backend(None)
    frames = {k: dispatch.VM_GAUGES[k] - before[k] for k in before}
    return [r.encode() for r in result.receipts], frames, blocks[0]


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("how", ["set_backend", "env"])
def test_forced_backend_runs_it(how, backend, monkeypatch):
    """A forced backend runs every frame (the frame counters say which);
    both give the JAX-built block's receipts and the default backend's."""
    receipts, frames, jx_block1 = _execute_block1(how, backend, monkeypatch)
    other = "python" if backend == "native" else "native"
    assert frames == {f"{backend}_frames": 1, f"{other}_frames": 0}
    monkeypatch.delenv("KHIPU_VM_BACKEND", raising=False)
    default, frames, _ = _execute_block1("set_backend", None, monkeypatch)
    assert frames == {"native_frames": 1, "python_frames": 0}
    assert receipts == default
    assert default[0] == _execute_fixture(0)[2].blockchain.get_receipts(
        1)[0].encode()


def test_failed_native_build_raises_from_dispatch(tmp_path, monkeypatch):
    """A g++ failure of the EVM core's build raises from the VM dispatch:
    no frame runs on the Python VM in its place. The hashes and
    signatures keep the library they loaded; the core's first load
    rebuilds from a broken source."""
    from khipu_tpu_torch.evm import native_vm

    (tmp_path / "broken.cc").write_text("int khipu_broken( {\n")

    def broken_build():
        with monkeypatch.context() as m:
            m.setattr(native_build, "CSRC", tmp_path)
            m.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
            m.setattr(native_build, "_LIB", None)
            return native_build.load_library()

    monkeypatch.setattr(native_vm, "load_library", broken_build)
    monkeypatch.setattr(native_vm, "_lib", None)
    before = dict(dispatch.VM_GAUGES)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        _execute_block1("set_backend", None, monkeypatch)
    assert any(e.name in ("run_message_call", "run_create")
               for e in info.traceback)
    assert dispatch.VM_GAUGES["python_frames"] == before["python_frames"]


def test_explicit_hasher_commits_without_card(monkeypatch):
    """A level-loop commit with an explicit hasher needs no card: the
    world's flush passes its hasher alone, and the device is resolved
    only for the default hasher and the fused fixpoint."""
    import torch

    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.trie import bulk, deferred
    from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(5)
    pairs = [(rng.bytes(32), rng.bytes(40)) for _ in range(24)]
    trie = MerklePatriciaTrie(load_reference_nodes({}))
    fold = trie
    for k, v in pairs:
        fold = fold.put(k, v)
    for hasher in (bulk.host_hasher,
                   functools.partial(device_hasher, device="cpu")):
        got = deferred.batch_commit(trie, pairs, (), hasher)
        assert got.root_hash == fold.root_hash
        assert bulk.bulk_build(pairs, hasher)[0] == fold.root_hash
    with pytest.raises(RuntimeError, match="is_available"):
        bulk.bulk_build(pairs, bulk.host_hasher, fused=True)
    with pytest.raises(RuntimeError, match="is_available"):
        deferred.batch_commit(trie, pairs, (), device_hasher)


# ------------------------------------------------ counters, two threads


def _hammer(fn, n, threads=2):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [fn() for _ in range(n)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)


def test_ragged_launch_count_survives_two_threads():
    before = keccak_cuda.RAGGED_LAUNCHES
    _hammer(lambda: keccak_cuda._count("RAGGED_LAUNCHES"), 20_000)
    assert keccak_cuda.RAGGED_LAUNCHES - before == 40_000


def test_span_totals_survive_two_threads():
    """The driver and the prefetch thread time ``keccak.*`` spans at
    once (here: both hashing batches on the CPU path): every span of
    both threads lands in the process tracer's ring."""
    from khipu_tpu_torch.observability.trace import tracer
    from khipu_tpu_torch.ops.keccak import keccak256_batch

    def count(name):
        return sum(1 for s in tracer.snapshot() if s.name == name)

    was_on, capacity = tracer._on, tracer.capacity
    tracer.enable(capacity=1 << 17)
    try:
        tracer.reset()

        def one():
            with observability.span("test.two_threads"):
                pass

        _hammer(one, 20_000)
        assert count("test.two_threads") == 40_000
        msgs = [os.urandom(40) for _ in range(4)]
        _hammer(lambda: keccak256_batch(msgs, "cpu"), 50)
        assert count("keccak.pack") == 100
        assert tracer.dropped == 0
    finally:
        tracer.reset()
        tracer.enable(capacity=capacity)
        if not was_on:
            tracer.disable()
