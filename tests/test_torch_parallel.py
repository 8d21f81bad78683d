"""The port's multi-card fixed-length hashing and snapshot verify
(khipu_tpu_torch/parallel/) on gloo CPU ranks, held byte for byte
against the JAX package's sharded functions on the conftest's 8-device
virtual mesh; and the mesh's errors.

Ranks are spawned processes over a ``FileStore``: one spawn at world 2
and one at world 3 (uneven shares), each running every case in one
worker, while the reference runs in the test process. A spawned rank
imports its test module to find its target, so JAX and the reference
package are imported inside functions only, and every rank checks that
no ``jax`` module is loaded. ``test_torch_parallel_hasher.py`` and
``test_torch_parallel_fused.py`` spawn their ranks the same way.
"""

import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

LENGTHS = (0, 136, 140, 576)
FIXED_ROWS = 13  # uneven at worlds 2 and 3
WORLDS = (2, 3)
RANK_TIMEOUT_S = 120.0


class Ranks:
    """``world`` spawned gloo ranks of ``target(rank, world, store,
    payload, out_dir)``, started at once; ``results()`` waits for them
    and returns each rank's pickled result, in rank order. A rank that
    fails or outlives ``RANK_TIMEOUT_S`` fails the test."""

    def __init__(self, target, world, tmp_path, payload):
        import torch.multiprocessing as mp

        self.world = world
        self.out_dir = tmp_path / f"world{world}"
        self.out_dir.mkdir()
        store = str(self.out_dir / "store")
        self.ctx = mp.spawn(target, args=(world, store, payload,
                                          str(self.out_dir)),
                            nprocs=world, join=False)
        self.deadline = time.monotonic() + RANK_TIMEOUT_S

    def results(self):
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise AssertionError(f"world {self.world}: ranks hung")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [pickle.loads((self.out_dir / f"rank{r}.pkl").read_bytes())
                for r in range(self.world)]


def spawn_and_reference(target, payload, tmp_path, reference):
    """Start the ranks of every world, compute ``reference(payload)`` (the
    JAX package's results) while they run, then wait for them. Returns
    ``({world: [rank results]}, reference results)``."""
    started = [Ranks(target, w, tmp_path, payload) for w in WORLDS]
    try:
        ref = reference(payload)
    finally:
        ranks = {r.world: r.results() for r in started}
    return ranks, ref


def init_rank(rank, world, store):
    """The rank's gloo group over the FileStore, and its CPU mesh. One
    intra-op thread a rank: the ranks and the reference share the CPU."""
    import torch.distributed as dist

    torch.set_num_threads(1)

    from khipu_tpu_torch.parallel import device_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    return device_mesh(device="cpu")


def finish_rank(rank, out_dir, result):
    import torch.distributed as dist

    result["jax_loaded"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "khipu_tpu" or m.startswith("khipu_tpu."))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _hash_rank(rank, world, store, payload, out_dir):
    """Every fixed-length case on one rank."""
    assert "jax" not in sys.modules
    mesh = init_rank(rank, world, store)
    from khipu_tpu_torch.parallel import (
        hash_level_all_gather,
        keccak256_fixed_sharded,
        snapshot_verify_sharded,
    )

    out = {"share": mesh.share(FIXED_ROWS), "size": mesh.size}
    for length, rows in payload["fixed"].items():
        out[("fixed", length)] = keccak256_fixed_sharded(rows, mesh)
        out[("level", length)] = hash_level_all_gather(rows, mesh)
        # the same rows as a tensor, and as 32-bit words
        out[("fixed_tensor", length)] = keccak256_fixed_sharded(
            torch.from_numpy(rows), mesh)
        if length % 4 == 0:
            out[("fixed_words", length)] = keccak256_fixed_sharded(
                rows.view("<u4"), mesh)
    vals = payload["verify_values"]
    out["verify"] = [snapshot_verify_sharded(vals, keys, mesh)
                     for keys in payload["verify_keys"]]
    out["collectives"] = dict(mesh.collectives)
    finish_rank(rank, out_dir, out)


def _payload():
    from khipu_tpu_torch.base.keccak import keccak256

    rng = np.random.default_rng(2024)
    fixed = {L: rng.integers(0, 256, (FIXED_ROWS, L), dtype=np.uint8)
             for L in LENGTHS}
    vals = rng.integers(0, 256, (FIXED_ROWS, 140), dtype=np.uint8)
    keys = np.stack([np.frombuffer(keccak256(r.tobytes()), np.uint8)
                     for r in vals])
    bent = []
    for rows in ([], [4], [4, 12]):
        k = keys.copy()
        for r in rows:
            k[r, r % 32] ^= 0x5A
        bent.append(k)
    return {"fixed": fixed, "verify_values": vals, "verify_keys": bent}


def _reference(payload):
    """The JAX package's sharded functions on its 8-device mesh, on the
    same inputs."""
    from khipu_tpu.parallel import (
        device_mesh,
        hash_level_all_gather,
        keccak256_fixed_sharded,
        snapshot_verify_sharded,
    )

    mesh = device_mesh(8)
    out = {}
    for length, rows in payload["fixed"].items():
        out[("fixed", length)] = keccak256_fixed_sharded(rows, mesh)
        out[("level", length)] = hash_level_all_gather(rows, mesh)
    vals = payload["verify_values"]
    out["verify"] = [snapshot_verify_sharded(vals, keys, mesh)
                     for keys in payload["verify_keys"]]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: [rank results]}, the reference's results)."""
    return spawn_and_reference(_hash_rank, _payload(),
                               tmp_path_factory.mktemp("ranks"), _reference)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_fixed_sharded_matches_reference(runs, world, length):
    ranks, ref = runs
    want = ref[("fixed", length)]
    assert want.shape == (FIXED_ROWS, 32)
    for res in ranks[world]:
        got = res[("fixed", length)]
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert res[("fixed_tensor", length)].tobytes() == want.tobytes()
        if length % 4 == 0:
            assert res[("fixed_words", length)].tobytes() == want.tobytes()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("length", LENGTHS)
def test_level_all_gather_matches_reference(runs, world, length):
    ranks, ref = runs
    want = ref[("level", length)]
    for res in ranks[world]:
        assert res[("level", length)].tobytes() == want.tobytes()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bent", [0, 1, 2])
def test_snapshot_verify_matches_reference(runs, world, bent):
    ranks, ref = runs
    assert ref["verify"][bent] == bent
    for res in ranks[world]:
        assert res["verify"][bent] == bent


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_share_rows_and_load_no_jax(runs, world):
    """Contiguous shares of ceil(n / world) rows, the last shorter; no
    rank loaded JAX or the reference package; every rank issued the same
    collectives: an all_gather a sharded hash, an all_reduce a verify."""
    ranks, _ = runs
    per = -(-FIXED_ROWS // world)
    results = ranks[world]
    assert [r["share"] for r in results] == [
        (min(r * per, FIXED_ROWS), min((r + 1) * per, FIXED_ROWS))
        for r in range(world)]
    assert all(r["size"] == world for r in results)
    assert all(r["jax_loaded"] == [] for r in results)
    words = sum(1 for L in LENGTHS if L % 4 == 0)
    assert all(r["collectives"] == {"all_gather": 3 * len(LENGTHS) + words,
                                    "all_reduce": 3} for r in results)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_mesh_raises_without_a_card(no_card):
    from khipu_tpu_torch.parallel import device_mesh

    with pytest.raises(RuntimeError, match="is_available"):
        device_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        device_mesh(devices=["cuda:0", "cuda:0"], backend="gloo")


def test_device_mesh_raises_for_more_ranks_than_cards(monkeypatch):
    import torch.distributed as dist

    from khipu_tpu_torch.parallel import device_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="requested 2 devices, only 1"):
        device_mesh()
    with pytest.raises(ValueError, match="3 devices named for 2 ranks"):
        device_mesh(devices=["cuda:0", "cuda:0", "cuda:0"],
                    backend="gloo")
    with pytest.raises(ValueError, match="requested 4 devices"):
        device_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="the CPU mesh is gloo"):
        device_mesh(device="cpu", backend="nccl")
    assert not dist.is_initialized()


def test_device_mesh_world_of_one_on_the_cpu(monkeypatch):
    """Without torchrun's environment, one process is a world of one; the
    mesh it started ends its group on close, and its collectives are the
    identity."""
    import torch.distributed as dist

    from khipu_tpu_torch.base.keccak import keccak256
    from khipu_tpu_torch.parallel import device_mesh, keccak256_fixed_sharded
    from khipu_tpu_torch.parallel.mesh import pad_to_shards

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = device_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert mesh.device == torch.device("cpu") and mesh.owns_group
        rows = np.arange(3 * 40, dtype=np.uint8).reshape(3, 40)
        got = keccak256_fixed_sharded(rows, mesh)
        assert [g.tobytes() for g in got] == [keccak256(r.tobytes())
                                              for r in rows]
        assert mesh.collectives == {"all_gather": 1}
    finally:
        mesh.close()
    assert not dist.is_initialized()
    assert pad_to_shards(13, 8) == 16 and pad_to_shards(0, 3, floor=3) == 3
