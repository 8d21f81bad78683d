"""The port's fast sync (khipu_tpu_torch.sync.fast_sync) and compactor
(khipu_tpu_torch.storage.compactor) against the JAX package's, on the
CPU.

The snapshot is built from account, storage and code dicts with no EVM:
300 accounts, every 100th a contract with its own 16-slot storage trie
and a code blob of several rate blocks, so the sync crosses all three
stores. Both packages' syncers download it from one fetch callback that
corrupts one node on its first delivery, with small batches and a
checkpoint after every batch. Every checkpoint's ``SyncState.encode()``,
the final state, ``downloaded_nodes`` and the three target stores must
be byte-equal. The JAX syncer checks content addresses with its host
hash and runs without a mirror (each jnp mirror class costs seconds to
compile on the CPU); the port's syncer uses its default batched sponge (plain
version on the CPU) and a ``DeviceNodeMirror``, whose resident rows must
equal the JAX target's nodes. The mirror itself is held against the JAX
mirror in tests/test_torch_mirror.py. Tolerance: exact bytes."""

import functools
import random

import pytest

from khipu_tpu.base.crypto.keccak import keccak256
from khipu_tpu.base.rlp import rlp_encode_int
from khipu_tpu.domain.account import Account
from khipu_tpu.storage import compactor as ref_compactor
from khipu_tpu.storage.datasource import (
    MemoryKeyValueDataSource as RefKV,
    MemoryNodeDataSource as RefNodes,
)
from khipu_tpu.storage.storages import Storages as RefStorages
from khipu_tpu.sync import fast_sync as ref_sync
from khipu_tpu.trie.bulk import bulk_build, host_hasher
from khipu_tpu_torch.storage import compactor
from khipu_tpu_torch.storage.datasource import (
    MemoryKeyValueDataSource,
    MemoryNodeDataSource,
)
from khipu_tpu_torch.storage.device_mirror import DeviceNodeMirror
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync import fast_sync

ACCOUNTS, CONTRACT_EVERY, SLOTS = 300, 100, 16


@functools.lru_cache(maxsize=None)
def _snapshot():
    """(root, {kind: {hash: bytes}}) of a seeded state with contracts."""
    rng = random.Random(17)
    storage_nodes, codes, pairs = {}, {}, []
    for i in range(ACCOUNTS):
        key = keccak256(i.to_bytes(20, "big"))
        if i % CONTRACT_EVERY:
            pairs.append((key, Account(0, 10**18 + i).encode()))
            continue
        slots = [(keccak256(s.to_bytes(32, "big")), rlp_encode_int(i * 1000 + s + 1))
                 for s in range(SLOTS)]
        s_root, s_nodes = bulk_build(slots, hasher=host_hasher)
        storage_nodes.update(s_nodes)
        code = rng.randbytes(300 + 7 * i)
        codes[keccak256(code)] = code
        pairs.append((key, Account(1, i, s_root, keccak256(code)).encode()))
    root, state_nodes = bulk_build(pairs, hasher=host_hasher)
    return root, {
        fast_sync.STATE_NODE: state_nodes,
        fast_sync.STORAGE_NODE: storage_nodes,
        fast_sync.EVMCODE: codes,
    }


def _fetcher(crash_at=None):
    """A fetch callback over the snapshot that flips one byte of one node
    on its first delivery (call 3) and, with ``crash_at``, raises on that
    call."""
    calls = {"n": 0}
    _, snapshot = _snapshot()

    def fetch(want):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise ConnectionError("peer died")
        out = {}
        for h in want:
            for store in snapshot.values():
                if h in store:
                    out[h] = store[h]
                    break
        if calls["n"] == 3:
            victim = want[-1]
            out[victim] = out[victim][:-1] + bytes([out[victim][-1] ^ 1])
        return out

    return fetch


def _recording(kv_cls):
    class Recording(kv_cls):
        """Records every checkpoint the syncer writes."""

        def __init__(self):
            super().__init__()
            self.puts = []

        def update(self, to_remove, to_upsert):
            self.puts.extend(to_upsert.values())
            super().update(to_remove, to_upsert)

    return Recording()


def _sync(which, crash_at=None):
    """Run one package's syncer (resuming once after a crash); returns
    (final state, checkpoints, storages, mirror)."""
    if which == "jax":
        storages, kv = RefStorages(), _recording(RefKV)
        state_store = ref_sync.FastSyncStateStorage(kv)

        def syncer(fetch):
            return ref_sync.StateSyncer(storages, state_store, fetch,
                                        batch_size=20, checkpoint_every=1)
        mirror = None
    else:
        storages, kv = Storages(), _recording(MemoryKeyValueDataSource)
        state_store = fast_sync.FastSyncStateStorage(kv)
        mirror = DeviceNodeMirror(capacity_rows_per_class=1024, device="cpu")

        def syncer(fetch):
            return fast_sync.StateSyncer(storages, state_store, fetch,
                                         batch_size=20, checkpoint_every=1,
                                         mirror=mirror, device="cpu")
    root, _ = _snapshot()
    if crash_at is not None:
        with pytest.raises(ConnectionError):
            syncer(_fetcher(crash_at)).start(root)
    state = syncer(_fetcher()).start(root)
    return state, kv.puts, storages, mirror


@pytest.fixture(scope="module")
def synced():
    return {(which, crash): _sync(which, crash)
            for which in ("jax", "port") for crash in (None, 5)}


def _stores(storages):
    return [dict(s.source._map) for s in (
        storages.account_node_storage, storages.storage_node_storage,
        storages.evmcode_storage)]


@pytest.mark.parametrize("crash", [None, 5], ids=["straight", "resumed"])
def test_sync_matches_reference(synced, crash):
    ref_state, ref_puts, ref_storages, _ = synced[("jax", crash)]
    state, puts, storages, _ = synced[("port", crash)]
    assert state.encode() == ref_state.encode()
    assert puts == ref_puts  # every checkpoint, then the purge
    assert len(puts) > 10
    _, snapshot = _snapshot()
    total = sum(len(v) for v in snapshot.values())
    assert state.downloaded_nodes == ref_state.downloaded_nodes == total
    assert _stores(storages) == _stores(ref_storages) == list(snapshot.values())
    assert storages.app_state.fast_sync_done
    assert ref_storages.app_state.fast_sync_done


def test_mirror_holds_the_synced_nodes(synced):
    _, _, ref_storages, _ = synced[("jax", None)]
    _, _, _, mirror = synced[("port", None)]
    trie_nodes = {**_stores(ref_storages)[0], **_stores(ref_storages)[1]}
    assert mirror.resident_count == len(trie_nodes)
    assert mirror.verify() == 0
    assert all(mirror.get(h) == v for h, v in trie_nodes.items())
    assert mirror.spill_rows(list(trie_nodes)) == trie_nodes


def test_children_of_matches_reference():
    for kind, nodes in _snapshot()[1].items():
        for enc in nodes.values():
            assert fast_sync._children_of(kind, enc) == (
                ref_sync._children_of(kind, enc)
            )


def test_sync_state_codec_matches_reference():
    pending = [(0, b"\xaa" * 32), (2, b"\xbb" * 32), (1, b"\xcc" * 32)]
    port = fast_sync.SyncState(b"\x11" * 32, pending, 7)
    ref = ref_sync.SyncState(b"\x11" * 32, pending, 7)
    assert port.encode() == ref.encode()
    assert fast_sync.SyncState.decode(ref.encode()) == port


def test_no_progress_raises_like_reference():
    def corrupt_all(want):
        return {h: b"junk" for h in want}

    for mod, storages, kv, extra in (
        (ref_sync, RefStorages(), RefKV(), {}),
        (fast_sync, Storages(), MemoryKeyValueDataSource(), {"device": "cpu"}),
    ):
        syncer = mod.StateSyncer(storages, mod.FastSyncStateStorage(kv),
                                 corrupt_all, **extra)
        with pytest.raises(RuntimeError, match="no progress"):
            syncer.start(_snapshot()[0])


def _copy_stores(node_cls):
    return [_fill(node_cls(), _snapshot()[1][k]) for k in (
        fast_sync.STATE_NODE, fast_sync.STORAGE_NODE, fast_sync.EVMCODE)]


def _fill(store, items):
    store.update([], items)
    return store


def _report(r):
    return (r.state_nodes, r.storage_nodes, r.code_blobs, r.missing,
            r.corrupt)


@pytest.mark.parametrize("damage", ["none", "lost", "bitflip"])
def test_compactor_matches_reference(damage):
    """compact copies exactly the reachable nodes, and verify_reachable
    counts what is lost or (with verify_hashes) corrupt, as in the JAX
    package."""
    root, snapshot = _snapshot()
    results = []
    for mod, node_cls in ((ref_compactor, RefNodes),
                          (compactor, MemoryNodeDataSource)):
        srcs = _copy_stores(node_cls)
        victim = sorted(snapshot[fast_sync.STORAGE_NODE])[3]
        if damage == "lost":
            del srcs[1]._map[victim]
        elif damage == "bitflip":
            srcs[1]._map[victim] = srcs[1]._map[victim][:-1] + b"\x00"
        dsts = [node_cls() for _ in range(3)]
        copied = mod.compact(*srcs, root, *dsts, batch=50)
        walk = mod.verify_reachable(*srcs, root, verify_hashes=True)
        results.append((_report(copied), _report(walk),
                        [dict(d._map) for d in dsts]))
    assert results[0] == results[1]
    copied, walk, _ = results[1]
    total = sum(len(v) for v in snapshot.values())
    if damage == "none":
        assert sum(copied[:3]) == total and walk[3:] == (0, 0)
    elif damage == "lost":
        assert walk[3] >= 1
    else:
        assert walk[4] == 1
