"""The port's device node mirror (khipu_tpu_torch.storage.device_mirror)
against the JAX package's, both on the CPU: the port through the plain
versions of kernels K3 and K4, the JAX mirror through its own jnp route.

One module-scoped scenario drives one mirror per package (1,024 rows a
class, one generic 1-block class and one exact 64-byte class, so the JAX
side compiles two classes) through every case of
tests/test_device_mirror.py, plus ``admit_device`` of a port
``FusedJob``'s admit tiles. After each step it records what each mirror
shows: counts, ``verify``, ``get`` and ``spill_rows`` results, and each
class's whole resident and claimed buffers in the port's word-major
layout (the JAX tiles ``[tiles, nwords, 8, 128]`` flattened). Tolerance:
exact bytes and counts."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khipu_tpu.base.crypto.keccak import keccak256
from khipu_tpu.storage import device_mirror as ref_mirror
from khipu_tpu.storage.storages import Storages as RefStorages
from khipu_tpu_torch.storage import device_mirror
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.trie import deferred, fused
from khipu_tpu_torch.state import load_reference_nodes

TILE = device_mirror.TILE
ZERO = b"\x00" * 32


class _Port:
    """The port's mirror behind the scenario's surface."""

    name = "port"

    def __init__(self):
        self.m = device_mirror.DeviceNodeMirror(
            capacity_rows_per_class=TILE, device="cpu"
        )
        self.storages = Storages

    def device_tile(self, enc_u8: np.ndarray, claim_u8: np.ndarray):
        return torch.from_numpy(enc_u8.copy()), torch.from_numpy(claim_u8.copy())

    def buffers(self):
        return {
            key: (cm.resident.numpy().tobytes(), cm.claimed.numpy().tobytes())
            for key, cm in sorted(self.m._classes.items(), key=str)
        }


class _Ref(_Port):
    name = "jax"

    def __init__(self):
        self.m = ref_mirror.DeviceNodeMirror(capacity_rows_per_class=TILE)
        self.storages = RefStorages

    def device_tile(self, enc_u8, claim_u8):
        return jnp.asarray(enc_u8), jnp.asarray(claim_u8)

    def buffers(self):
        out = {}
        for key, cm in sorted(self.m._classes.items(), key=str):
            res = np.asarray(cm.resident).astype("<u4")  # [t, nwords, 8, 128]
            cl = np.asarray(cm.claimed).astype("<u4")  # [t, 8, 8, 128]
            out[key] = tuple(
                np.ascontiguousarray(
                    a.transpose(1, 0, 2, 3).reshape(a.shape[1], -1)
                ).tobytes()
                for a in (res, cl)
            )
        return out


def _padded_tile(encs):
    """One TILE of padded 1-block rows and their claims; rows past
    ``encs`` repeat the first (claim-consistent filler)."""
    width = 136
    padded = np.zeros((TILE, width), np.uint8)
    claims = np.zeros((TILE, 32), np.uint8)
    for r in range(TILE):
        enc = encs[r] if r < len(encs) else encs[0]
        padded[r, :len(enc)] = np.frombuffer(enc, np.uint8)
        padded[r, len(enc)] ^= 0x01
        padded[r, width - 1] ^= 0x80
        claims[r] = np.frombuffer(keccak256(enc), np.uint8)
    return padded, claims


def _fused_tiles():
    """A port window's admit tiles: three accounts under one 1-block
    branch, resolved on the CPU with ``admit_live`` set to the live
    placeholders."""
    session = deferred.DeferredMPT(load_reference_nodes({}))
    rng = random.Random(21)
    for _ in range(3):
        session = session.put(rng.randbytes(32), rng.randbytes(40))
    session.force_hashed_root()
    to_resolve, deps, _ = deferred.resolution_inputs(session)
    live = {ph for ph, rec in session._logs.items()
            if deferred._is_placeholder(ph) and rec[0] > 0}
    job = fused.fused_submit(to_resolve, deps, deferred._PLACEHOLDER_PREFIX,
                             device="cpu", admit_live=live)
    mapping = job.collect()
    assert [t[0] for t in job.admit_tiles] == [1]
    return job.admit_tiles, mapping


def _scenario(pkg, fused_tiles, mapping):
    m = pkg.m
    rng = random.Random(5)
    obs = {}

    items = {}
    for _ in range(40):
        enc = rng.randbytes(rng.choice([40, 70, 100, 130]))
        items[keccak256(enc)] = enc
    m.admit(items)
    m.flush()
    keys = list(items)
    obs["clean"] = dict(
        count=m.resident_count, verify=m.verify(),
        got=[m.get(h) for h in keys[:5]], want=[items[h] for h in keys[:5]],
        contains=m.contains(keys[0]), missing=m.get(ZERO),
        buffers=pkg.buffers(),
    )
    obs["spill"] = dict(
        rows=m.spill_rows(keys[:7] + [ZERO]),
        want={h: items[h] for h in keys[:7]},
    )

    raw = np.frombuffer(rng.randbytes(64 * TILE), np.uint8).reshape(TILE, 64)
    hs = [keccak256(raw[i].tobytes()) for i in range(TILE)]
    m.admit_packed(hs, raw, [64] * TILE, exact=True)
    obs["exact"] = dict(
        verify=m.verify(), first=m.get(hs[0]), last=m.get(hs[-1]),
        want=(raw[0].tobytes(), raw[-1].tobytes()), count=m.resident_count,
        buffers=pkg.buffers(),
    )

    enc = b"\x77" * 64
    h = keccak256(enc)
    m.admit({h: enc})
    m.flush()
    once = m.resident_count
    m.admit({h: enc})  # a fresh staging round: new tile, same hash
    m.flush()
    twice = m.resident_count
    # one class's ring holds one tile here, so a duplicate that outlives
    # its first row's tile sits inside one tile: row 1 repeats row 0
    dup = raw.copy()
    dup[1] = dup[0]
    m.admit_packed([hs[0]] + hs[:1] + hs[2:], dup, [64] * TILE, exact=True)
    obs["duplicate"] = dict(
        once=once, twice=twice, in_tile=m.resident_count, got=m.get(h),
        want=enc, dup_got=m.get(hs[0]), dup_want=raw[0].tobytes(),
        verify=m.verify(), buffers=pkg.buffers(),
    )

    enc = b"\xab" * 64
    m.admit({keccak256(enc): enc, b"\x99" * 32: b"\xcd" * 64})
    m.flush()
    obs["corrupt"] = dict(verify=m.verify(), buffers=pkg.buffers())

    ring = {}
    for i in range(1500):
        enc = i.to_bytes(8, "big") * 9
        ring[keccak256(enc)] = enc
    m.admit(ring)
    m.flush()
    ring_keys = list(ring)
    obs["ring"] = dict(
        count=m.resident_count, verify=m.verify(),
        evicted=m.get(ring_keys[0]), survivor=m.get(ring_keys[-1]),
        want=ring[ring_keys[-1]], buffers=pkg.buffers(),
    )

    encs = [bytes([i + 1]) * (40 + 7 * i) for i in range(3)]
    enc_dev, claim_dev = pkg.device_tile(*_padded_tile(encs))
    aliases = [b"\xaa" + i.to_bytes(31, "big") for i in range(3)]
    m.admit_device(1, aliases + [None] * (TILE - 3), enc_dev, claim_dev,
                   [len(e) for e in encs] + [0] * (TILE - 3))
    hidden = [m.get(keccak256(e)) for e in encs]
    verify_aliased = m.verify()
    unspilled = m.unspilled_count
    remap = {a: keccak256(e) for a, e in zip(aliases, encs)}
    remap[b"\xbb" * 32] = b"\xcc" * 32  # unrelated entries are inert
    obs["alias"] = dict(
        hidden=hidden, verify_aliased=verify_aliased, unspilled=unspilled,
        moved=m.rekey(remap), got=[m.get(keccak256(e)) for e in encs],
        want=encs, verify=m.verify(), buffers=pkg.buffers(),
    )

    encs = [b"\x5a" * 44]
    enc_dev, claim_dev = pkg.device_tile(*_padded_tile(encs))
    m.admit_device(1, [b"\xaa" * 32] + [None] * (TILE - 1), enc_dev,
                   claim_dev, [44] + [0] * (TILE - 1))
    m.drop_aliases([b"\xaa" * 32])
    obs["drop_aliases"] = dict(
        moved=m.rekey({b"\xaa" * 32: keccak256(encs[0])}),
        got=m.get(keccak256(encs[0])), unspilled=m.unspilled_count,
    )

    (nb, keys, enc_g, claim_g, lens), = fused_tiles
    enc_dev, claim_dev = pkg.device_tile(enc_g.numpy(), claim_g.numpy())
    m.admit_device(nb, keys, enc_dev, claim_dev, lens)
    real = sorted(mapping[k] for k in keys if k is not None)
    obs["fused_admit"] = dict(
        moved=m.rekey(mapping), verify=m.verify(),
        rows=m.spill_rows(real), unspilled=m.unspilled_count,
        buffers=pkg.buffers(),
    )

    storages = pkg.storages()
    enc = b"\x42" * 80
    h = keccak256(enc)
    m.admit({h: enc})
    m.flush()
    storages.attach_mirror(m)
    attached = (storages.account_node_storage.get(h),
                storages.storage_node_storage.get(h),
                storages.get_node_any(h))
    storages.detach_mirror()
    obs["read_through"] = dict(
        attached=attached, want=enc,
        detached=(storages.account_node_storage.get(h),
                  storages.get_node_any(h)),
    )
    return obs


@pytest.fixture(scope="module")
def runs():
    tiles, mapping = _fused_tiles()
    return {pkg.name: _scenario(pkg, tiles, mapping)
            for pkg in (_Port(), _Ref())}


STEPS = ["clean", "spill", "exact", "duplicate", "corrupt", "ring", "alias",
         "drop_aliases", "fused_admit", "read_through"]


@pytest.mark.parametrize("step", STEPS)
def test_port_mirror_matches_reference(runs, step):
    """Everything the two mirrors show after each step is byte-equal,
    resident and claimed buffers included."""
    assert runs["port"][step] == runs["jax"][step]


def _expect_clean(o):
    assert o["count"] == 40 and o["verify"] == 0
    assert o["got"] == o["want"] and o["contains"] and o["missing"] is None


def _expect_spill(o):
    assert o["rows"] == o["want"]


def _expect_exact(o):
    assert o["verify"] == 0 and o["count"] == 40 + TILE
    assert (o["first"], o["last"]) == o["want"]


def _expect_duplicate(o):
    assert o["once"] == o["twice"] == TILE + 1
    assert o["in_tile"] == TILE  # the repeated hash counts once
    assert o["got"] == o["want"] and o["dup_got"] == o["dup_want"]
    assert o["verify"] == 0


def _expect_corrupt(o):
    assert o["verify"] == 1  # exactly the forged claim fails


def _expect_ring(o):
    assert o["count"] <= 2 * TILE and o["verify"] == 0
    assert o["evicted"] is None and o["survivor"] == o["want"]


def _expect_alias(o):
    assert o["hidden"] == [None] * 3, "unpublished row served"
    assert o["verify_aliased"] == 0 and o["unspilled"] == 3
    assert o["moved"] == 3 and o["got"] == o["want"] and o["verify"] == 0


def _expect_drop(o):
    assert o["moved"] == 0 and o["got"] is None


def _expect_fused(o):
    assert o["moved"] == len(o["rows"]) > 0 and o["verify"] == 0
    assert all(keccak256(v) == k for k, v in o["rows"].items())


def _expect_read_through(o):
    assert o["attached"] == (o["want"],) * 3
    assert o["detached"] == (None, None)


EXPECT = dict(zip(STEPS, (
    _expect_clean, _expect_spill, _expect_exact, _expect_duplicate,
    _expect_corrupt, _expect_ring, _expect_alias, _expect_drop,
    _expect_fused, _expect_read_through,
)))


@pytest.mark.parametrize("step", STEPS)
def test_port_mirror_semantics(runs, step):
    """The port's observations meet what tests/test_device_mirror.py
    asserts of the JAX mirror."""
    EXPECT[step](runs["port"][step])


@pytest.mark.parametrize("exact_len", [None, 64])
def test_plain_k3_matches_reference_run(runs, exact_len):
    """The plain version of K3 against the JAX class's own hash runner on
    the same resident rows."""
    nblocks = 1
    width = exact_len or 136
    rng = np.random.default_rng(7 if exact_len else 8)
    rows = rng.integers(0, 256, (TILE, width), dtype=np.uint8)
    planes = torch.from_numpy(rows.copy()).view(torch.int32).t()
    got = device_mirror.hash_planes_plain(planes, nblocks, exact_len)
    run = ref_mirror._class_kernels(nblocks, exact_len, False)[0]
    ref = np.asarray(run(ref_mirror._pack_word_major(rows))).astype("<u4")
    assert got.numpy().astype("<u4").tobytes() == (
        ref.transpose(1, 0, 2, 3).reshape(8, TILE).tobytes()
    )
    claims = got.clone()
    claims[5, 100] ^= 1
    assert device_mirror.verify_planes_plain(planes, claims, nblocks,
                                             exact_len) == 1


def test_port_mirror_needs_whole_tiles():
    m = device_mirror.DeviceNodeMirror(capacity_rows_per_class=TILE,
                                       device="cpu")
    with pytest.raises(ValueError):
        m.admit_packed([], np.zeros((10, 136), np.uint8))
    with pytest.raises(ValueError):
        device_mirror.DeviceNodeMirror(capacity_rows_per_class=1000,
                                       device="cpu")._class(1)
