"""The port's state-root pipeline (khipu_tpu_torch.trie) against the JAX
package, on the CPU: bulk build, the fused fixpoint (plain versions of
K1 and K2), and a windowed deferred-commit session over a state the JAX
package built. Placeholder prefixes are random per process and per
package, so sessions are compared by real digests, roots and node
dicts; only the fixpoint tests feed one package's placeholders to both.
Tolerance: exact bytes."""

import functools
import gzip
import os
import random

import numpy as np
import pytest
import torch

from khipu_tpu.base.crypto.keccak import keccak256
from khipu_tpu.storage.datasource import MemoryNodeDataSource as RefSource
from khipu_tpu.trie import bulk as ref_bulk
from khipu_tpu.trie import deferred as ref_deferred
from khipu_tpu.trie import fused as ref_fused
from khipu_tpu.trie.mpt import MerklePatriciaTrie as RefMPT
from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.ops.keccak import keccak256_fixed
from khipu_tpu_torch.state import load_reference_nodes
from khipu_tpu_torch.trie import bulk, deferred, fused
from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
MAINNET_GENESIS_STATE_ROOT = bytes.fromhex(
    "d7f8974fb5ac78d9ac099b9ad5018bedc2ce0a72dad1827a1709da30580f0544"
)


@functools.lru_cache(maxsize=None)
def _random_pairs(seed=2, n=1500):
    rng = random.Random(seed)
    return tuple({
        rng.randbytes(rng.randint(1, 40)): rng.randbytes(rng.randint(1, 90))
        for _ in range(n)
    }.items())


def test_bulk_build_matches_reference():
    """1,500 random pairs (the shape of test_trie's fused bulk test):
    the port's level loop and fused fixpoint against the JAX package's
    host build and its jnp fixpoint."""
    pairs = _random_pairs()
    ref_root, ref_nodes = ref_bulk.bulk_build(pairs, hasher=ref_bulk.host_hasher)
    assert ref_bulk.bulk_build(pairs, fused=True) == (ref_root, ref_nodes)
    stats = {}
    got = bulk.bulk_build(pairs, fused=True, device="cpu", stats_out=stats)
    assert got == (ref_root, ref_nodes)
    assert set(stats) == {"pack_s", "device_s"}
    assert bulk.bulk_build(pairs, device="cpu") == (ref_root, ref_nodes)


@pytest.mark.parametrize("k", [1, 2, 3, 9])
def test_tiny_tries_match_reference(k):
    sub = _random_pairs()[:k]
    want = ref_bulk.bulk_build(sub, hasher=ref_bulk.host_hasher)
    assert bulk.bulk_build(sub, fused=True, device="cpu") == want
    assert bulk.bulk_build(sub, hasher=bulk.host_hasher, device="cpu") == want


@pytest.mark.parametrize("pairs", [
    ((b"\x01", b"\x02"),),
    ((b"\x01", b"a"), (b"\x02", b"b")),
    (),
])
def test_inline_and_empty_roots(pairs):
    want = ref_bulk.bulk_build(pairs, hasher=ref_bulk.host_hasher)
    assert bulk.bulk_build(pairs, fused=True, device="cpu") == want
    assert bulk.bulk_build(pairs, device="cpu") == want


def test_mainnet_genesis_root():
    """The 8,893-account mainnet alloc: keys hashed by the port's batched
    keccak, root equal to geth's."""
    with gzip.open(
        os.path.join(FIXTURES, "mainnet_genesis_alloc.txt.gz"), "rt"
    ) as f:
        alloc = [line.split() for line in f]
    addrs = np.frombuffer(
        b"".join(bytes.fromhex(a) for a, _ in alloc), np.uint8
    ).reshape(-1, 20)
    keys = keccak256_fixed(addrs, device="cpu").numpy()
    pairs = [
        (keys[i].tobytes(), Account(0, int(bal)).encode())
        for i, (_, bal) in enumerate(alloc)
    ]
    assert len(pairs) == 8893
    root, _ = bulk.bulk_build(pairs, device="cpu")
    assert root == MAINNET_GENESIS_STATE_ROOT


def test_fused_resolve_matches_reference():
    """One placeholder DAG (the 1,500-pair trie) fed to both fixpoints."""
    root, levels = bulk.build_levels(_random_pairs())
    to_resolve, _ = bulk.placeholder_dag(levels)
    prefix = deferred._PLACEHOLDER_PREFIX
    deps = {
        ph: [enc[p : p + 32] for p in range(len(enc))
             if enc.startswith(prefix, p)]
        for ph, enc in to_resolve.items()
    }
    depth = len(levels)
    assert len(fused.topo_levels(deps)) <= depth
    want = ref_fused.fused_resolve(to_resolve, deps, prefix, use_jnp=True,
                                   depth=depth)
    got = fused.fused_resolve(to_resolve, deps, prefix, device="cpu")
    assert got == want
    assert len(got) == len(to_resolve)


def _ref_session(seed, n_base=300, n_up=200, n_rm=40):
    rng = random.Random(seed)
    src = RefSource()
    base = RefMPT(src)
    keys = [keccak256(rng.randbytes(8)) for _ in range(n_base)]
    for k in keys:
        base = base.put(k, rng.randbytes(rng.randrange(1, 80)))
    base = base.persist()
    d = ref_deferred.DeferredMPT(src, _root_ref=base._root_ref)
    for k in rng.sample(keys, n_rm):
        d = d.remove(k)
    for _ in range(n_up):
        d = d.put(keccak256(rng.randbytes(8)),
                  rng.randbytes(rng.randrange(1, 80)))
    return d


def _rows_by_key(job):
    out = {}
    for c, (phs, _) in enumerate(job.class_rows):
        enc = np.asarray(job.encs[c])
        for r, ph in enumerate(phs):
            out[ph] = enc[r].tobytes()
    return out


def _admit_by_key(job):
    out = {}
    for nb, keys, enc, claim, lens in job.admit_tiles:
        enc, claim = np.asarray(enc), np.asarray(claim)
        assert len(keys) == enc.shape[0] == claim.shape[0] == len(lens)
        assert len(keys) % 1024 == 0
        for i, k in enumerate(keys):
            if k is not None:
                out[k] = (nb, enc[i].tobytes(), claim[i].tobytes(), lens[i])
    return out


def test_fused_submit_ext_and_admit_matches_reference():
    """A deferred session's DAG with its leaf level moved into a
    resolved-input (ext) tile and a live subset admitted: real-row
    digests, final encodings, admit tiles and fetch_rows agree."""
    import jax.numpy as jnp

    session = _ref_session(1)
    to_resolve, deps, _ = ref_deferred.resolution_inputs(session)
    _, truth = ref_deferred.finalize(
        session, ref_bulk.host_hasher, return_mapping=True
    )
    leaves = fused.topo_levels(deps)[0]
    rng = random.Random(3)
    moved = rng.sample(leaves, len(leaves) // 2)
    # ext rows in shuffled order, with two rows nobody references
    ext_keys = moved + [None, None]
    rng.shuffle(ext_keys)
    ext_np = np.stack([
        np.frombuffer(truth[k] if k else bytes(32), np.uint8) for k in ext_keys
    ])
    ext_pos = {k: i for i, k in enumerate(ext_keys) if k is not None}
    moved_set = set(moved)
    tr = {ph: e for ph, e in to_resolve.items() if ph not in moved_set}
    dp = {ph: [c for c in deps[ph] if c not in moved_set] for ph in tr}
    live = set(rng.sample(sorted(tr), len(tr) // 3))
    prefix = ref_deferred._PLACEHOLDER_PREFIX

    ref_job = ref_fused.fused_submit(
        tr, dp, prefix, use_jnp=True, ext=(jnp.asarray(ext_np), ext_pos),
        admit_live=live,
    )
    job = fused.fused_submit(
        tr, dp, prefix, device="cpu", ext=(torch.from_numpy(ext_np), ext_pos),
        admit_live=live,
    )
    probe = rng.sample(sorted(tr), 5)
    assert job.fetch_rows(probe) == ref_job.fetch_rows(probe)
    got = job.collect()
    assert got == ref_job.collect() == {ph: truth[ph] for ph in tr}
    assert job.fetch_rows(probe) == {ph: truth[ph] for ph in probe}
    assert _rows_by_key(job) == _rows_by_key(ref_job)
    assert _admit_by_key(job) == _admit_by_key(ref_job)
    assert set(_admit_by_key(job)) == live
    job.release_encs()
    assert job.encs is None and job.admit_tiles is not None
    job.release()
    assert job.digests is None and job.collect() == got


def test_substitute_plain_reads_ext_past_total_rows():
    enc = torch.zeros((3, 136), dtype=torch.uint8)
    digests = torch.arange(2 * 32, dtype=torch.uint8).reshape(2, 32)
    ext = torch.full((1, 32), 0xEE, dtype=torch.uint8)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    fused.substitute(enc, i32([0, 2]), i32([5, 100]), i32([1, 2]),
                     digests, ext, 2)
    assert enc[0, 5:37].tolist() == list(range(32, 64))
    assert enc[2, 100:132].tolist() == [0xEE] * 32
    assert int(enc.sum()) == sum(range(32, 64)) + 0xEE * 32


def _block_writes(rng, keys, balances, n_new, block):
    """One block's account writes: ~transfers (sender nonce+1 and a
    balance change on both sides) over existing accounts, then new
    accounts."""
    writes = {}
    n_existing = 50 - n_new
    picks = rng.choice(len(keys), size=n_existing, replace=False)
    for j, i in enumerate(picks):
        nonce, bal = balances[keys[i]]
        nonce += 1 if j % 2 == 0 else 0
        bal += int(rng.integers(1, 10**6))
        balances[keys[i]] = (nonce, bal)
        writes[keys[i]] = Account(nonce, bal).encode()
    for j in range(n_new):
        k = address_key(b"new" + bytes([block, j]) + bytes(15))
        keys.append(k)
        balances[k] = (0, 10**18 + j)
        writes[k] = Account(0, 10**18 + j).encode()
    return writes


def test_window_session_matches_reference():
    """A 2,000-account state built by the JAX package, carried into the
    port with load_reference_nodes, then 4 blocks x 50 writes in one
    deferred session per package: per-block roots and persisted node
    sets equal each other and the JAX package's eager host MPT."""
    base_pairs = [
        (address_key(i.to_bytes(20, "big")), Account(0, 10**18 + i).encode())
        for i in range(2000)
    ]
    root, nodes = ref_bulk.bulk_build(base_pairs, hasher=ref_bulk.host_hasher)
    ref_src = RefSource()
    ref_src.update([], nodes)
    src = load_reference_nodes(nodes)
    assert src.count == len(nodes)

    rng = np.random.default_rng(7)
    keys = [k for k, _ in base_pairs]
    balances = {k: (0, 10**18 + i) for i, k in enumerate(keys)}
    blocks = [_block_writes(rng, keys, balances, 5, b) for b in range(4)]

    eager = RefMPT(ref_src, root_hash=root)
    ref_d = ref_deferred.DeferredMPT(ref_src, root_hash=root)
    sessions = [deferred.DeferredMPT(src, root_hash=root) for _ in range(2)]
    eager_roots, ref_refs, refs = [], [], [[], []]
    for writes in blocks:
        for k, v in writes.items():
            eager = eager.put(k, v)
            ref_d = ref_d.put(k, v)
            sessions = [s.put(k, v) for s in sessions]
        eager_roots.append(eager.root_hash)
        ref_refs.append(ref_d.force_hashed_root())
        for s, r in zip(sessions, refs):
            r.append(s.force_hashed_root())

    ref_trie, ref_map = ref_deferred.finalize(
        ref_d, ref_bulk.host_hasher, return_mapping=True
    )
    fused_trie, fused_map = deferred.finalize(
        sessions[0], return_mapping=True, fused=True, device="cpu"
    )
    loop_trie, loop_map = deferred.finalize(
        sessions[1], return_mapping=True, device="cpu"
    )
    assert [ref_map[r] for r in ref_refs] == eager_roots
    assert [fused_map[r] for r in refs[0]] == eager_roots
    assert [loop_map[r] for r in refs[1]] == eager_roots
    assert fused_trie.root_hash == loop_trie.root_hash == eager_roots[-1]
    _, eager_up = eager.changes()
    assert fused_trie.changes()[1] == ref_trie.changes()[1] == eager_up
    assert loop_trie.changes()[1] == eager_up
    fused_trie.persist()
    reopened = MerklePatriciaTrie(src, root_hash=eager_roots[-1])
    for k, v in blocks[-1].items():
        assert reopened.get(k) == v


def test_deep_dag_falls_back_to_level_loop(monkeypatch):
    """Past MAX_DEPTH, finalize(fused=True) runs the level loop with the
    default hasher on the same device and counts the fallback."""
    src = load_reference_nodes({})
    d = deferred.DeferredMPT(src)
    for i in range(40):
        d = d.put(address_key(bytes([i])), b"v" * 40)
    d.force_hashed_root()
    monkeypatch.setattr(fused, "MAX_DEPTH", 1)
    before = fused.FUSED_GAUGES["unsupported_fallbacks"]
    trie, mapping = deferred.finalize(
        d, return_mapping=True, fused=True, device="cpu"
    )
    assert fused.FUSED_GAUGES["unsupported_fallbacks"] == before + 1
    want, _ = ref_bulk.bulk_build(
        [(address_key(bytes([i])), b"v" * 40) for i in range(40)],
        hasher=ref_bulk.host_hasher,
    )
    assert trie.root_hash == want


def test_eager_mpt_and_batch_commit_match_reference():
    rng = random.Random(5)
    ops = [(keccak256(rng.randbytes(4)), rng.randbytes(rng.randrange(1, 60)))
           for _ in range(60)]
    t, r = MerklePatriciaTrie(load_reference_nodes({})), RefMPT(RefSource())
    for k, v in ops:
        t, r = t.put(k, v), r.put(k, v)
    for k, _ in ops[::7]:
        t, r = t.remove(k), r.remove(k)
    assert t.root_hash == r.root_hash
    assert t.changes() == r.changes()
    ups = [(k, b"x" + v) for k, v in ops[::3]]
    got = deferred.batch_commit(t, ups, [ops[1][0]], device="cpu")
    want = ref_deferred.batch_commit(r, ups, [ops[1][0]])
    assert got.root_hash == want.root_hash
