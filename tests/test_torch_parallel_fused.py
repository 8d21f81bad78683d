"""The port's sharded window finalize (``fused_resolve_sharded``) on gloo
CPU ranks at worlds 2 and 3, held byte for byte against the JAX
package's on its 8-device virtual mesh (the dry run's 48-put session and
a 16-block window, both made by the JAX package's deferred trie, so both
packages resolve the same placeholders), past the JAX package's depth
limit, and the multi-card dry run (``python -m khipu_tpu_torch.parallel``)
in the same ranks. Ranks are spawned as in test_torch_parallel.py.
"""

import sys

import pytest

from test_torch_parallel import WORLDS, finish_rank, init_rank, \
    spawn_and_reference

DEEP = 70  # levels of the chain DAG: past the JAX package's MAX_DEPTH (64)


def _fused_rank(rank, world, store, payload, out_dir):
    assert "jax" not in sys.modules
    mesh = init_rank(rank, world, store)
    from khipu_tpu_torch.parallel import fused_resolve_sharded
    from khipu_tpu_torch.parallel import __main__ as dry_run
    from khipu_tpu_torch.trie.fused import fused_resolve

    out = {}
    for name, (to_resolve, deps) in payload["dags"].items():
        stats = {}
        gathers0 = mesh.collectives.get("all_gather", 0)
        out[name] = fused_resolve_sharded(to_resolve, deps,
                                          payload["prefix"], mesh,
                                          stats_out=stats)
        out[name + "/one_card"] = fused_resolve(
            to_resolve, deps, payload["prefix"], device="cpu")
        stats["gathers"] = mesh.collectives["all_gather"] - gathers0
        out[name + "/stats"] = stats
    out["empty"] = fused_resolve_sharded({}, {}, payload["prefix"], mesh)
    args = dry_run.parse_args(
        ["--device", "cpu", "--rows", "96", "--accounts", "300",
         "--window-accounts", "400", "--blocks", "3", "--writes", "24"])
    per_rank = dry_run.run(mesh, args)
    out["dry_run"] = [[(r["step"], r.get("equal_one_card"),
                        r.get("mapping_sha"), r.get("table_sha"))
                       for r in recs] for recs in per_rank]
    finish_rank(rank, out_dir, out)


def _chain(prefix, depth):
    """A chain DAG ``depth`` levels deep: node i's encoding embeds node
    i - 1's placeholder. Returns (to_resolve, deps, scalar digests)."""
    from khipu_tpu_torch.base.keccak import keccak256

    phs = [prefix + i.to_bytes(14, "big") for i in range(depth)]
    to_resolve, deps, digests = {}, {}, {}
    for i, ph in enumerate(phs):
        head = b"\xf8\x44" + bytes([i % 251]) * 3
        child = phs[i - 1] if i else b"\x00" * 32
        to_resolve[ph] = head + child + b"tail" * (i % 5)
        deps[ph] = [phs[i - 1]] if i else []
        real = head + (digests[phs[i - 1]] if i else child) + b"tail" * (i % 5)
        digests[ph] = keccak256(real)
    return to_resolve, deps, digests


def _payload():
    """The DAGs, made by the JAX package's deferred trie."""
    from khipu_tpu.base.crypto.keccak import keccak256
    from khipu_tpu.storage.datasource import MemoryNodeDataSource
    from khipu_tpu.trie.deferred import (
        _PLACEHOLDER_PREFIX,
        DeferredMPT,
        resolution_inputs,
    )
    from khipu_tpu.trie.mpt import MerklePatriciaTrie

    session = DeferredMPT(MemoryNodeDataSource())
    for i in range(48):  # __graft_entry__.dryrun_multichip's session
        session = session.put(keccak256(i.to_bytes(4, "big")),
                              b"v" * (20 + i % 37))
    base = MerklePatriciaTrie(MemoryNodeDataSource())
    for i in range(40):
        base = base.put(keccak256(b"acct%d" % i), b"\x01" * 8 + b"%d" % i)
    base = base.persist()
    window = DeferredMPT(base.source, root_hash=base.root_hash)
    for blk in range(16):
        for j in range(2):
            window = window.put(keccak256(b"acct%d" % ((blk * 5 + j) % 60)),
                                b"b%d-%d" % (blk, j))
        window.force_hashed_root()
    chain = _chain(_PLACEHOLDER_PREFIX, DEEP)
    return {
        "prefix": _PLACEHOLDER_PREFIX,
        "dags": {
            "session48": resolution_inputs(session)[:2],
            "window16": resolution_inputs(window)[:2],
            "deep": chain[:2],
        },
        "deep_digests": chain[2],
    }


def _reference(payload):
    from khipu_tpu.parallel import device_mesh
    from khipu_tpu.parallel.fused_sharded import fused_resolve_sharded
    from khipu_tpu.trie.fused import FusedUnsupported

    mesh = device_mesh(8)
    out = {name: fused_resolve_sharded(*payload["dags"][name],
                                       payload["prefix"], mesh)
           for name in ("session48", "window16")}
    with pytest.raises(FusedUnsupported, match=f"depth {DEEP} > 64"):
        fused_resolve_sharded(*payload["dags"]["deep"], payload["prefix"],
                              mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload = _payload()
    ranks, ref = spawn_and_reference(_fused_rank, payload,
                                     tmp_path_factory.mktemp("ranks"),
                                     _reference)
    return payload, ranks, ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dag", ["session48", "window16"])
def test_fused_resolve_sharded_matches_reference(runs, world, dag):
    payload, ranks, ref = runs
    want = ref[dag]
    assert set(want) == set(payload["dags"][dag][0])
    for res in ranks[world]:
        assert res[dag] == want
        assert res[dag + "/one_card"] == want
        assert res["jax_loaded"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_past_the_reference_depth_limit(runs, world):
    """The JAX package raises FusedUnsupported past 64 levels; the port
    has no depth limit: the chain resolves level by level, equal to its
    one-card fixpoint and to the scalar chain."""
    payload, ranks, _ = runs
    for res in ranks[world]:
        assert res["deep"] == payload["deep_digests"]
        assert res["deep/one_card"] == payload["deep_digests"]
        assert res["deep/stats"]["levels"] == DEEP


@pytest.mark.parametrize("world", WORLDS)
def test_one_all_gather_a_level(runs, world):
    """A rank issues one all_gather a level and runs the rows of each
    level its share reaches (a level narrower than the world leaves the
    last ranks out)."""
    payload, ranks, _ = runs
    for rank, res in enumerate(ranks[world]):
        for name in payload["dags"]:
            stats = res[name + "/stats"]
            assert stats["gathers"] == stats["levels"]
            assert 0 <= stats["k5_levels"] <= stats["levels"]
        assert res["window16/stats"]["k5_levels"] > 0
        # the chain's levels above 0 are one row each, so only rank 0
        # runs them; level 0 also holds each rate class's filler row
        assert res["deep/stats"]["k5_levels"] == DEEP if rank == 0 \
            else res["deep/stats"]["k5_levels"] <= 1
        assert res["empty"] == {}


@pytest.mark.parametrize("world", WORLDS)
def test_dry_run_every_step_equal_on_every_rank(runs, world):
    """``python -m khipu_tpu_torch.parallel``'s steps at a small size:
    the run checks itself on every rank (a disagreement raises); every
    rank gathered the same records, each equal to the one-card path."""
    _, ranks, _ = runs
    dry = [res["dry_run"] for res in ranks[world]]
    assert all(d == dry[0] for d in dry)
    steps = [s[0] for s in dry[0][0]]
    assert steps == ["commit", "fixed_sharded", "level_all_gather",
                     "snapshot_verify", "bulk_build", "fused_session48",
                     "fused_bulk_dag_300", "fused_window_3x24"]
    assert all(s[1] is not False for recs in dry[0] for s in recs)
