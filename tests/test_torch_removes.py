"""Deferred sessions with many removes, the port against the JAX package,
on the CPU: the windowed commit removes accounts (EIP-161 deletion,
``WindowCommitter.commit_block``) and storage sessions drop zeroed
slots, across several blocks of one window. Both packages' deferred
commits are compared with each other (deferred against deferred: with
removes both persist a node the eager MPT does not). Also the persist
stage's vectorized substitute, ``_substitute_many``, against the
reference's on the same encodings and lookup. Every comparison is
byte-exact."""

import random

import numpy as np
import pytest

from khipu_tpu.base.crypto import secp256k1 as jx_secp
from khipu_tpu.domain import transaction as jx_tx
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.ledger.window import WindowCommitter as JxWindowCommitter
from khipu_tpu.storage.compactor import compact as jx_compact
from khipu_tpu.storage.datasource import MemoryNodeDataSource as RefSource
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder
from khipu_tpu.trie import bulk as ref_bulk
from khipu_tpu.trie import deferred as ref_deferred
from khipu_tpu.trie.mpt import EMPTY_TRIE_HASH as JX_EMPTY

from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.ledger.window import WindowCommitter
from khipu_tpu_torch.state import load_reference_nodes
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.trie import deferred
from khipu_tpu_torch.trie.bulk import host_hasher
from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH

from tests.test_torch_window import (
    _assert_same_chain,
    _jx_cfg,
    _pt_cfg,
    _reachable,
)


def _slot(k: int) -> bytes:
    return k.to_bytes(32, "big")


def _session_ops(seed: int, keys, blocks: int = 5):
    """Per block: ~40 puts (new keys and rewrites) and ~40 removes (of
    base keys and of keys an earlier block of the window put)."""
    rng = random.Random(seed)
    live = list(keys)
    added = []
    ops = []
    for b in range(blocks):
        block = []
        for j in range(40):
            if rng.random() < 0.5 and added:
                k = rng.choice(added)
            else:
                k = address_key(bytes([seed, b, j]) + bytes(17))
                added.append(k)
            block.append(("put", k, Account(b, 10**18 + j).encode()))
        for _ in range(40):
            pool = added if (added and rng.random() < 0.4) else live
            k = pool.pop(rng.randrange(len(pool)))
            block.append(("remove", k, None))
        rng.shuffle(block)
        ops.append(block)
    return ops


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_removes_heavy_session_matches_reference(seed):
    """A 600-account state, then 5 blocks of puts and removes in one
    deferred session per package: the per-block roots and the persisted
    node sets of the port's fused fixpoint (plain K5) and level loop
    equal the JAX package's deferred commit."""
    base = [(address_key(i.to_bytes(20, "big")), Account(0, i).encode())
            for i in range(600)]
    root, nodes = ref_bulk.bulk_build(base, hasher=ref_bulk.host_hasher)
    ref_src = RefSource()
    ref_src.update([], nodes)
    src = load_reference_nodes(nodes)
    ops = _session_ops(seed, [k for k, _ in base])

    ref_d = ref_deferred.DeferredMPT(ref_src, root_hash=root)
    sessions = [deferred.DeferredMPT(src, root_hash=root) for _ in range(2)]
    ref_refs, refs = [], [[], []]
    removed = 0
    for block in ops:
        for op, k, v in block:
            if op == "put":
                ref_d = ref_d.put(k, v)
                sessions = [s.put(k, v) for s in sessions]
            else:
                removed += 1
                ref_d = ref_d.remove(k)
                sessions = [s.remove(k) for s in sessions]
        ref_refs.append(ref_d.force_hashed_root())
        for s, r in zip(sessions, refs):
            r.append(s.force_hashed_root())
    assert removed == 200
    ref_trie, ref_map = ref_deferred.finalize(
        ref_d, ref_bulk.host_hasher, return_mapping=True)
    fused_trie, fused_map = deferred.finalize(
        sessions[0], return_mapping=True, fused=True, device="cpu")
    loop_trie, loop_map = deferred.finalize(
        sessions[1], return_mapping=True, device="cpu")
    want = [ref_map[r] for r in ref_refs]
    assert len(set(want)) == 5
    assert [fused_map[r] for r in refs[0]] == want
    assert [loop_map[r] for r in refs[1]] == want
    assert fused_trie.root_hash == loop_trie.root_hash == ref_trie.root_hash
    assert fused_trie.changes() == loop_trie.changes() == ref_trie.changes()


def _fold(committer, storage_root, block, removes_storage):
    """One block into a window committer of either package: storage
    slots written and zeroed in a storage session of the window, then
    the account trie: the contract's new storage root, funded accounts
    put, others removed (EIP-161). Returns (account root ref, storage
    root ref)."""
    contract, slots, puts, removes = block
    session = committer.storage_session(storage_root)
    for k, v in slots:
        session = session.put(_slot(k), v)
    for k in removes_storage:
        session = session.remove(_slot(k))
    storage_root = session.force_hashed_root()
    trie = committer.account_trie
    trie = trie.put(address_key(contract), Account(
        1, 0, storage_root).encode())
    for addr, bal in puts:
        trie = trie.put(address_key(addr), Account(0, bal).encode())
    for addr in removes:
        trie = trie.remove(address_key(addr))
    committer.account_trie = trie
    return trie.force_hashed_root(), storage_root


@pytest.mark.parametrize("fused_window", [True, False],
                         ids=["plain_k5", "level_loop"])
def test_window_committer_removes_match_reference(fused_window):
    """Four blocks into ONE window of each package's WindowCommitter:
    accounts created and removed across blocks, storage slots written
    in one block and zeroed in a later one. The per-block roots and the
    nodes reachable from the last root equal the reference's, and both
    stores hold exactly those nodes' persisted live set."""
    rng = np.random.default_rng(11)
    contract = b"\xc0" * 20
    addrs = [(0x7000 + i).to_bytes(20, "big") for i in range(120)]
    blocks, zeroed = [], []
    for b in range(4):
        slots = [(int(k), rng.integers(1, 2**31).item().to_bytes(4, "big"))
                 for k in rng.choice(64, 24, replace=False)]
        puts = [(addrs[int(i)], int(rng.integers(1, 10**6)))
                for i in rng.choice(120, 30, replace=False)]
        removes = [addrs[int(i)] for i in rng.choice(120, 20, replace=False)]
        zero = [k for k, _ in blocks[-1][1][:12]] if blocks else []
        blocks.append((contract, slots, puts, removes))
        zeroed.append(zero)

    ports = WindowCommitter(Storages(), EMPTY_TRIE_HASH, hasher=host_hasher,
                            fused=fused_window, device="cpu")
    ref = JxWindowCommitter(JxStorages(), JX_EMPTY)
    roots = [[], []]
    for cm, out in ((ports, roots[0]), (ref, roots[1])):
        storage_root = b""
        for block, zero in zip(blocks, zeroed):
            ref_, storage_root = _fold(cm, storage_root, block, zero)
            out.append(ref_)
    pj, rj = ports.seal(), ref.seal()
    ports.pack_and_dispatch(pj)
    ref.pack_and_dispatch(rj)
    for cm, job in ((ports, pj), (ref, rj)):
        cm.admit_mirror(job)
        cm.persist(job)
    port_roots = [ports._resolved_global[r] for r in roots[0]]
    ref_roots = [ref._resolved_global[r] for r in roots[1]]
    assert port_roots == ref_roots and len(set(port_roots)) == 4
    head = port_roots[-1]
    assert (_reachable(ports.storages, head)
            == _reachable(ref.storages, head, jx_compact))
    for store in ("account_node_storage", "storage_node_storage"):
        assert (getattr(ports.storages, store).source._map
                == getattr(ref.storages, store).source._map)


# contract: SSTORE(calldata word 0, calldata word 1); deployed by INIT
STORE_RUNTIME = bytes([0x60, 0x20, 0x35, 0x60, 0x00, 0x35, 0x55, 0x00])
STORE_INIT = bytes([0x60, len(STORE_RUNTIME), 0x60, 12, 0x60, 0, 0x39,
                    0x60, len(STORE_RUNTIME), 0x60, 0, 0xF3]) + STORE_RUNTIME


def test_eip161_and_zeroed_slots_windowed_replay_matches_reference():
    """A chain whose blocks delete empty accounts by touching them
    (EIP-161: a 0-wei transfer to a genesis account with no balance)
    and zero storage slots set in earlier blocks, replayed windowed
    (3 blocks a window) by both drivers: the same headers, receipts
    and reachable nodes."""
    keys = [(0x51 + i).to_bytes(32, "big") for i in range(3)]
    senders = [jx_secp.pubkey_to_address(jx_secp.privkey_to_pubkey(k))
               for k in keys]
    empties = [(0xE0E0 + i).to_bytes(20, "big") for i in range(12)]
    alloc = {a: 10**21 for a in senders}
    alloc.update({a: 0 for a in empties})
    cfg = _jx_cfg(1)
    builder = JxChainBuilder(JxBlockchain(JxStorages(), cfg), cfg,
                             JxGenesisSpec(alloc=alloc))
    nonce = [0, 0, 0]

    def tx(i, to, value=0, payload=b"", gas=21000):
        stx = jx_tx.sign_transaction(
            jx_tx.Transaction(nonce[i], 10**9, gas, to, value, payload),
            keys[i], chain_id=1)
        nonce[i] += 1
        return stx

    store = jx_tx.contract_address(senders[0], 0)
    blocks = [builder.add_block([tx(0, None, payload=STORE_INIT,
                                    gas=200_000)], coinbase=b"\xaa" * 20)]

    def sstore(k, v):
        return tx(1, store, payload=_slot(k) + _slot(v), gas=60_000)

    for b in range(6):
        txs = [sstore(8 * b + j, 1000 + j) for j in range(4)]
        if b:  # zero the previous block's slots
            txs += [sstore(8 * (b - 1) + j, 0) for j in range(3)]
        txs += [tx(2, empties[2 * b + j]) for j in range(2)]  # EIP-161
        blocks.append(builder.add_block(txs, coinbase=b"\xaa" * 20))
    wire = [blk.encode() for blk in blocks]

    jx_cfg = _jx_cfg(3)
    from khipu_tpu.domain.block import Block as JxBlock
    from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

    jx_bc = JxBlockchain(JxStorages(), jx_cfg)
    jx_bc.load_genesis(JxGenesisSpec(alloc=alloc))
    JxReplayDriver(jx_bc, jx_cfg).replay([JxBlock.decode(w) for w in wire])

    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
    from khipu_tpu_torch.sync.replay import ReplayDriver

    pt_cfg = _pt_cfg(3)
    bc = Blockchain(Storages(), pt_cfg)
    bc.load_genesis(GenesisSpec(alloc=alloc))
    ReplayDriver(bc, pt_cfg, device_commit=True, device="cpu").replay(
        [Block.decode(w) for w in wire])
    _assert_same_chain(bc, jx_bc, len(blocks))
    head = blocks[-1].header.state_root
    for a in empties[:12]:
        assert bc.get_account(a, head) is None  # deleted or never touched
    genesis_root = bc.get_header_by_number(0).state_root
    assert all(bc.get_account(a, genesis_root) is not None for a in empties)
    slots = {k for k in range(48) if k % 8 < 4}
    zeroed = {8 * b + j for b in range(5) for j in range(3)}
    storage = bc.get_world_state(head)
    for k in slots:
        assert storage.get_storage(store, k) == (
            0 if k in zeroed else 1000 + k % 8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_substitute_many_matches_reference(monkeypatch, seed):
    """The same encodings and lookup through both packages'
    ``_substitute_many`` (the reference's prefix set to the port's for
    the call) and the scalar ``_substitute_bytes``: known placeholders
    substituted, unknown ones and prefix matches that straddle two
    encodings or run off the end left alone."""
    prefix = deferred._PLACEHOLDER_PREFIX
    monkeypatch.setattr(ref_deferred, "_PLACEHOLDER_PREFIX", prefix)
    rng = random.Random(seed)
    known = {deferred._make_placeholder(i): rng.randbytes(32)
             for i in range(40)}
    unknown = [deferred._make_placeholder(1000 + i) for i in range(5)]
    encs = []
    for _ in range(60):
        parts = [rng.randbytes(rng.randrange(0, 40))]
        for _ in range(rng.randrange(0, 4)):
            parts.append(rng.choice(list(known) + unknown))
            parts.append(rng.randbytes(rng.randrange(0, 20)))
        encs.append(b"".join(parts))
    # a prefix split across two neighbours, and one cut at the very end
    encs.append(rng.randbytes(5) + prefix[:10])
    encs.append(prefix[10:] + bytes(14) + rng.randbytes(3))
    encs.append(rng.randbytes(7) + prefix + bytes(6))
    got = deferred._substitute_many(encs, known.get)
    assert got == ref_deferred._substitute_many(encs, known.get)
    assert got == [deferred._substitute_bytes(e, known) for e in encs]
    assert sum(g != e for g, e in zip(got, encs)) > 20
    short = [b"ab", b"cd"]
    assert deferred._substitute_many(short, known.get) == short
