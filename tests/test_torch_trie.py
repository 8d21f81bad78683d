"""The port's state-root pipeline (khipu_tpu_torch.trie) against the JAX
package, on the CPU: bulk build, the fused fixpoint (the plain version
of K5), and a windowed deferred-commit session over a state the JAX
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
from khipu_tpu_torch.ops import keccak_torch
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
    """resolve_levels_plain: a child at or past total_rows reads the
    resolved-input tile, one below it reads this window's digest, and
    each row is hashed after its substitution."""
    rng = np.random.default_rng(11)
    raw = torch.from_numpy(rng.integers(0, 256, (3, 136), dtype=np.uint8))
    c = fused.PackedClass()
    c.nb, c.keys, c.base, c.enc = 1, [], 0, raw.clone()
    ext = torch.full((2, 32), 0xEE, dtype=torch.uint8)
    ext[1] = 0xAB
    # row 0 <- row 1's digest at byte 5; row 2 <- ext row 1 at byte 100
    plan = fused.level_plan(np.array([0, 2]), np.array([5, 100]),
                            np.array([1, 3 + 1]), 3, "cpu")
    assert plan.level.tolist() == [1, 0, 0]
    digests = fused.resolve_levels_plain([c], 3, ext, plan)
    want = raw.clone()
    want[2, 100:132] = 0xAB
    want[0, 5:37] = keccak_torch.absorb_padded(want[1:2])[0]
    assert torch.equal(c.enc, want)
    assert torch.equal(digests, keccak_torch.absorb_padded(want))


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


def test_deep_dag_fused_matches_reference():
    """Keys that share ever longer nibble prefixes give a DAG of more
    than 12 levels; finalize(fused=True) resolves it in one pass of
    levels, with root and changes() equal to the JAX package's
    bulk_build and finalize."""
    keys = [bytes(i) + b"\x11" + bytes(31 - i) for i in range(12)]
    pairs = [(k, b"v" * 40 + bytes([i]))
             for i, k in enumerate(keys + [bytes(32)])]
    d = deferred.DeferredMPT(load_reference_nodes({}))
    ref_d = ref_deferred.DeferredMPT(RefSource())
    for k, v in pairs:
        d, ref_d = d.put(k, v), ref_d.put(k, v)
    d.force_hashed_root()
    ref_d.force_hashed_root()
    trie = deferred.finalize(d, fused=True, device="cpu")
    assert fused.FUSED_GAUGES["last_levels"] >= 12
    ref_trie = ref_deferred.finalize(ref_d, ref_bulk.host_hasher)
    want, _ = ref_bulk.bulk_build(pairs, hasher=ref_bulk.host_hasher)
    assert trie.root_hash == ref_trie.root_hash == want
    assert trie.changes() == ref_trie.changes()


@functools.lru_cache(maxsize=None)
def _ref_window(blocks=16):
    """A JAX-package session of ``blocks`` blocks x 50 account writes
    over a 300-account state, each block's root forced: the per-block
    roots share subtrees, so children have several parents."""
    base_pairs = [
        (address_key(i.to_bytes(20, "big")), Account(0, 10**18 + i).encode())
        for i in range(300)
    ]
    root, nodes = ref_bulk.bulk_build(base_pairs, hasher=ref_bulk.host_hasher)
    src = RefSource()
    src.update([], nodes)
    rng = np.random.default_rng(13)
    keys = [k for k, _ in base_pairs]
    balances = {k: (0, 10**18 + i) for i, k in enumerate(keys)}
    d = ref_deferred.DeferredMPT(src, root_hash=root)
    roots = []
    for b in range(blocks):
        for k, v in _block_writes(rng, keys, balances, 5, b).items():
            d = d.put(k, v)
        roots.append(d.force_hashed_root())
    return d, roots


def test_pack_levels_match_topo_levels():
    """pack's vectorised levels equal topo_levels(deps) row for row on a
    16-block window DAG; spare filler rows are level 0; the order is
    sorted by (level, class); a depth below the levels raises."""
    session, _ = _ref_window()
    to_resolve, deps, _ = ref_deferred.resolution_inputs(session)
    prefix = ref_deferred._PLACEHOLDER_PREFIX
    classes, dpos, total, plan = fused.pack(to_resolve, prefix, "cpu")
    topo = fused.topo_levels(deps)
    assert plan.nlevels == len(topo) >= 4
    fillers = {c.base + len(c.keys) for c in classes}
    for lvl, phs in enumerate(topo):
        rows = set(np.flatnonzero(plan.level == lvl).tolist()) - fillers
        assert rows == {dpos[ph] for ph in phs}
    assert all(plan.level[r] == 0 for r in fillers)
    by_level = plan.level[plan.order]
    assert np.all(np.diff(by_level) >= 0)
    for lvl in range(plan.nlevels):
        rows = plan.order[plan.level_ptr[lvl] : plan.level_ptr[lvl + 1]]
        assert np.all(np.diff(rows) > 0)  # rows ascend, so classes do
    with pytest.raises(ValueError, match="levels"):
        fused.fused_submit(to_resolve, deps, prefix, device="cpu",
                           depth=plan.nlevels - 1)


def test_multi_parent_children_match_reference():
    """The per-block roots of a 16-block window share subtrees (children
    with several parents): final encodings and digests byte-equal to
    the JAX package's fused_submit and to its level-loop finalize."""
    session, roots = _ref_window()
    to_resolve, deps, _ = ref_deferred.resolution_inputs(session)
    parents = {}
    for ph, cs in deps.items():
        for ch in cs:
            parents[ch] = parents.get(ch, 0) + 1
    assert max(parents.values()) > 1
    prefix = ref_deferred._PLACEHOLDER_PREFIX
    ref_job = ref_fused.fused_submit(to_resolve, deps, prefix, use_jnp=True)
    job = fused.fused_submit(to_resolve, deps, prefix, device="cpu")
    _, truth = ref_deferred.finalize(
        session, ref_bulk.host_hasher, return_mapping=True
    )
    got = job.collect()
    assert got == ref_job.collect() == {ph: truth[ph] for ph in to_resolve}
    assert [got[r] for r in roots] == [truth[r] for r in roots]
    assert _rows_by_key(job) == _rows_by_key(ref_job)


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
