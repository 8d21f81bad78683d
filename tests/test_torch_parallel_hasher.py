"""The port's sharded ragged hashing (``keccak256_batch_sharded``,
``sharded_hasher``) on gloo CPU ranks at worlds 2 and 3, held byte for
byte against the JAX package's: ``keccak256_batch_sharded`` on its
8-device virtual mesh over a mixed batch of 1-16 rate blocks, and
``bulk_build`` / ``batch_commit`` with the sharded hasher on the inputs
of tests/test_deferred.py's ``TestShardedBulkBuild``. There the JAX side
runs its host hasher: that test holds the JAX sharded hasher equal to it
on these very inputs, and the JAX sharded build compiles one program a
padded batch shape (about a minute on the CPU). Ranks are spawned as in
test_torch_parallel.py.
"""

import sys

import numpy as np
import pytest

from test_torch_parallel import WORLDS, finish_rank, init_rank, \
    spawn_and_reference

# rate classes of the mixed batch: 1-4 (leaves and branches) and 16
# (a 2,048 B code blob)
BATCH_CLASSES = (1, 2, 3, 4, 16)


def _hasher_rank(rank, world, store, payload, out_dir):
    assert "jax" not in sys.modules
    mesh = init_rank(rank, world, store)
    from khipu_tpu_torch.parallel import keccak256_batch_sharded, \
        sharded_hasher
    from khipu_tpu_torch.storage.datasource import MemoryNodeDataSource
    from khipu_tpu_torch.trie.bulk import bulk_build
    from khipu_tpu_torch.trie.deferred import batch_commit
    from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

    out = {"batch": keccak256_batch_sharded(payload["batch"], mesh),
           "empty_batch": keccak256_batch_sharded([], mesh)}
    gathers0 = mesh.collectives.get("all_gather", 0)
    calls = []
    hasher = sharded_hasher(mesh)

    def counting(msgs):
        calls.append(len(msgs))
        return hasher(msgs)

    out["bulk"] = bulk_build(payload["bulk_pairs"], hasher=counting)
    base = MerklePatriciaTrie(MemoryNodeDataSource())
    for k, v in payload["commit_base"]:
        base = base.put(k, v)
    base = base.persist()
    out["commit_root"] = batch_commit(
        base, payload["commit_ups"], hasher=counting).root_hash
    out["hasher_calls"] = len(calls)
    out["hasher_gathers"] = mesh.collectives["all_gather"] - gathers0
    finish_rank(rank, out_dir, out)


def _payload():
    from khipu_tpu_torch.base.keccak import keccak256

    rng = np.random.default_rng(77)
    lens = [0, 135, 136, 271, 272, 407, 408, 543, 2040, 2175]
    for nb in BATCH_CLASSES:
        lens += [int(n) for n in rng.integers(136 * (nb - 1), 136 * nb, 4)]
    return {
        "batch": [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in rng.permutation(lens)],
        # tests/test_deferred.py::TestShardedBulkBuild's inputs
        "bulk_pairs": [(keccak256(b"acct%d" % i), b"\x01" * 8 + b"%d" % i)
                       for i in range(10_000)],
        "commit_base": [(keccak256(b"b%d" % i), b"v%d" % i)
                        for i in range(300)],
        "commit_ups": [(keccak256(b"b%d" % i), b"upd%d" % i)
                       for i in range(0, 600, 3)],
    }


def _reference(payload):
    from khipu_tpu.parallel import device_mesh
    from khipu_tpu.parallel.keccak_sharded import keccak256_batch_sharded
    from khipu_tpu.storage.datasource import MemoryNodeDataSource
    from khipu_tpu.trie.bulk import bulk_build, host_hasher
    from khipu_tpu.trie.deferred import batch_commit
    from khipu_tpu.trie.mpt import MerklePatriciaTrie

    base = MerklePatriciaTrie(MemoryNodeDataSource())
    for k, v in payload["commit_base"]:
        base = base.put(k, v)
    base = base.persist()
    return {
        "batch": keccak256_batch_sharded(payload["batch"], device_mesh(8)),
        "bulk": bulk_build(payload["bulk_pairs"], hasher=host_hasher),
        "commit_root": batch_commit(base, payload["commit_ups"],
                                    hasher=host_hasher).root_hash,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_and_reference(_hasher_rank, _payload(),
                               tmp_path_factory.mktemp("ranks"), _reference)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_sharded_matches_reference(runs, world):
    from khipu_tpu_torch.base.keccak import keccak256

    ranks, ref = runs
    batch = _payload()["batch"]
    assert {len(m) // 136 + 1 for m in batch} == set(BATCH_CLASSES)
    assert ref["batch"] == [keccak256(m) for m in batch]
    for res in ranks[world]:
        assert res["batch"] == ref["batch"]
        assert res["empty_batch"] == []
        assert res["jax_loaded"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_bulk_build_with_sharded_hasher_matches_reference(runs, world):
    ranks, ref = runs
    want_root, want_nodes = ref["bulk"]
    for res in ranks[world]:
        root, nodes = res["bulk"]
        assert root == want_root
        assert nodes == want_nodes


@pytest.mark.parametrize("world", WORLDS)
def test_batch_commit_with_sharded_hasher_matches_reference(runs, world):
    ranks, ref = runs
    for res in ranks[world]:
        assert res["commit_root"] == ref["commit_root"]


@pytest.mark.parametrize("world", WORLDS)
def test_one_all_gather_a_hasher_call(runs, world):
    """Each call of the sharded hasher is one K1r share and one
    all_gather, on every rank."""
    ranks, _ = runs
    for res in ranks[world]:
        assert res["hasher_calls"] > 2
        assert res["hasher_gathers"] == res["hasher_calls"]
