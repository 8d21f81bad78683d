"""The port's native host closure beside the JAX package's: the C RLP codec
(native/csrc_ext/rlp_ext.c) against both pure-Python codecs, the native
append-log store (native/csrc/store.cc) and the sqlite engine, their
file formats read across the two packages, and a chain replayed by both
drivers into each persistent engine and reopened. Inputs are seeded with
numpy; every comparison is byte-exact."""

import dataclasses
import os
import struct
import sys

import numpy as np
import pytest

from khipu_tpu.base import rlp as jx_rlp
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain import block as jx_block
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.native import store as jx_store
from khipu_tpu.native.build import load_rlp_ext as jx_load_rlp_ext
from khipu_tpu.storage import sqlite_engine as jx_sqlite
from khipu_tpu.storage.compactor import compact as jx_compact
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder
from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

from khipu_tpu_torch import workloads
from khipu_tpu_torch.base import rlp
from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.native import build as native_build
from khipu_tpu_torch.native import store
from khipu_tpu_torch.storage import sqlite_engine
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync.replay import ReplayDriver

from tests.test_torch_replay import _configs, _erc20, _keys
from tests.test_torch_window import _assert_same_chain, _reachable

RNG_SEED = 20261017


# ------------------------------------------------------------- the codec


def _item(rng, depth=0):
    """A seeded RLP item: byte strings at every header's edges, or a
    list (nested a few levels) of items."""
    if depth < 4 and rng.random() < 0.35:
        return [_item(rng, depth + 1) for _ in range(int(rng.integers(0, 7)))]
    n = int(rng.choice([0, 1, 1, 2, 31, 32, 55, 56, 57, 200, 255, 256, 1100]))
    data = rng.bytes(n)
    if n == 1 and rng.random() < 0.5:
        data = bytes([int(rng.integers(0x80))])  # a byte that is itself
    return bytearray(data) if rng.random() < 0.1 else data


def _plain(item):
    return bytes(item) if isinstance(item, (bytes, bytearray)) else [
        _plain(x) for x in item]


def test_codec_reaches_the_extension_everywhere():
    """After the first call, base.rlp's names and those of every port
    module that imported the forwarders by value are the extension's."""
    from khipu_tpu_torch.domain import account
    from khipu_tpu_torch.trie import deferred, mpt

    assert rlp.rlp_decode(rlp.rlp_encode([b"\x01", b"ab"])) == [b"\x01", b"ab"]
    ext = native_build.load_rlp_ext()
    for mod in (rlp, account, deferred, mpt):
        assert mod.rlp_encode is ext.encode and mod.rlp_decode is ext.decode
    assert rlp._impl == [ext.encode, ext.decode]
    # the forwarders a late by-value import could still hold, one hop
    assert rlp._forward_encode([b"ab"]) == ext.encode([b"ab"])
    assert rlp._forward_decode(b"\x82ab") == b"ab"


def test_extension_is_keyed_by_ext_suffix():
    import sysconfig

    ext = native_build.load_rlp_ext()
    assert ext.__file__.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert os.path.dirname(ext.__file__) == str(native_build.BUILD_DIR)


@pytest.mark.parametrize("chunk", range(4))
def test_codec_matches_both_oracles(chunk):
    rng = np.random.default_rng([RNG_SEED, chunk])
    for _ in range(500):
        item = _item(rng)
        enc = rlp.rlp_encode(item)
        assert enc == rlp._py_rlp_encode(item) == jx_rlp._py_rlp_encode(item)
        assert enc == jx_rlp.rlp_encode(item)
        want = _plain(item)
        assert rlp.rlp_decode(enc) == rlp._py_rlp_decode(enc) == want
        assert jx_rlp._py_rlp_decode(enc) == want


BAD_INPUTS = [
    b"", b"\x81\x01", b"\x81", b"\xb8\x01a", b"\xb8", b"\xb9\x00\x40" + b"a" * 64,
    b"\xc1", b"\xc2\x83ab", b"\xf8\x01\x01", b"\xf8", b"\x01\x02",
    b"\xc0\x00", b"\xbf" + b"\xff" * 8, b"\xff" + b"\x00" * 8,
]


@pytest.mark.parametrize("data", BAD_INPUTS, ids=lambda d: d[:6].hex() or "empty")
def test_decode_errors_match(data):
    """Every malformed input raises RLPError from the C codec and both
    Python codecs alike."""
    for decode, err in ((rlp.rlp_decode, rlp.RLPError),
                        (rlp._py_rlp_decode, rlp.RLPError),
                        (jx_rlp._py_rlp_decode, jx_rlp.RLPError)):
        with pytest.raises(err):
            decode(data)


def test_encode_errors_and_depth_cap_match():
    """MAX_DEPTH nested lists encode and decode alike in both codecs;
    one more level, or an item that is not bytes or a list, raises
    RLPError from both."""
    deep = b"x"
    for _ in range(rlp.MAX_DEPTH):
        deep = [deep]
    enc = rlp.rlp_encode(deep)
    assert enc == rlp._py_rlp_encode(deep) == jx_rlp._py_rlp_encode(deep)
    assert rlp.rlp_decode(enc) == rlp._py_rlp_decode(enc) == deep
    for bad in ([deep], 7, "text", None, [b"a", 1]):
        for encode in (rlp.rlp_encode, rlp._py_rlp_encode):
            with pytest.raises(rlp.RLPError):
                encode(bad)
    nested = b"\x80"  # MAX_DEPTH + 1 lists around an empty string
    for _ in range(rlp.MAX_DEPTH + 1):
        nested = rlp._encode_length(len(nested), 0xC0) + nested
    for decode in (rlp.rlp_decode, rlp._py_rlp_decode):
        with pytest.raises(rlp.RLPError, match="MAX_DEPTH"):
            decode(nested)


def _port_ext():
    ext = native_build.load_rlp_ext()
    ext._set_error(rlp.RLPError)
    return ext


@pytest.mark.parametrize("resize", ["grow", "shrink", "nested_grow", "none"])
def test_encode_resize_guard(resize):
    """The C encoder's two passes: a bytearray resized between the size
    pass and the write pass raises RLPError instead of writing past the
    buffer; a hook that resizes nothing changes nothing."""
    ext = _port_ext()
    ba = bytearray(b"x" * (100 if resize == "shrink" else 10))
    item = [[ba], [b"x", [ba]]] if resize == "nested_grow" else [ba, b"tail"]
    hooks = {"grow": lambda: ba.extend(b"y" * 90),
             "shrink": lambda: ba.__init__(b"x" * 3),
             "nested_grow": lambda: ba.extend(b"c" * 60),
             "none": lambda: None}
    ext._set_encode_hook(hooks[resize])
    try:
        if resize == "none":
            out = ext.encode(item)
        else:
            with pytest.raises(rlp.RLPError):
                ext.encode(item)
    finally:
        ext._set_encode_hook(None)
    if resize == "none":
        assert out == ext.encode(item) == rlp._py_rlp_encode(item)


def test_each_package_raises_its_own_error():
    """Both extensions loaded in one process: each raises the RLPError
    its own package installed."""
    port, ref = _port_ext(), jx_load_rlp_ext()
    assert ref is not None and ref is not port
    ref._set_error(jx_rlp.RLPError)
    assert port.__file__ != ref.__file__
    with pytest.raises(rlp.RLPError) as got:
        port.decode(b"\x81\x01")
    assert not isinstance(got.value, jx_rlp.RLPError)
    with pytest.raises(jx_rlp.RLPError) as got:
        ref.decode(b"\x81\x01")
    assert not isinstance(got.value, rlp.RLPError)
    with pytest.raises(rlp.RLPError):
        rlp.rlp_decode(b"\xc1")


def test_failed_extension_build_raises(tmp_path, monkeypatch):
    (tmp_path / "rlp_ext.c").write_text("int broken( {\n")
    monkeypatch.setattr(native_build, "CSRC_EXT", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_build, "_EXT", None)
    with pytest.raises(RuntimeError, match="gcc failed"):
        native_build.load_rlp_ext()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_parallel_builders_compile_once(tmp_path):
    """Processes that build one library at once wait on the build lock:
    one compiles, the others find its output."""
    import subprocess

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from khipu_tpu_torch.native import build as b\n"
        "from khipu_tpu_torch.observability.recorder import compile_log\n"
        "b.BUILD_DIR = Path(%r)\n"
        "b._compile('g++', b.GXX_FLAGS, [b.CSRC / 'keccak.cc'],\n"
        "           b.BUILD_DIR / 'libkeccak.so')\n"
        "print(compile_log.snapshot()['events'][-1]['kind'])\n") % (
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    kinds = sorted(p.communicate(timeout=120)[0].strip() for p in procs)
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert kinds == ["hit", "hit", "miss"]
    assert [p.name for p in tmp_path.glob("*.so")] == ["libkeccak.so"]
    assert not list(tmp_path.glob("*.tmp"))


# ------------------------------------------------------ the native store


def test_node_source_roundtrip_and_dedup(tmp_path):
    src = store.NativeNodeDataSource(str(tmp_path), "account")
    values = [b"node-%d" % i * (i + 1) for i in range(50)]
    upserts = {keccak256(v): v for v in values}
    src.update([], upserts)
    for k, v in upserts.items():
        assert src.get(k) == v
    assert src.get(b"\x00" * 32) is None
    before = os.path.getsize(tmp_path / "account.log")
    src.update([], upserts)  # content-addressed: a re-put appends nothing
    assert os.path.getsize(tmp_path / "account.log") == before
    assert src.count == 50
    src.stop()


def test_content_address_collision_guard(tmp_path):
    """Two keys sharing the 8-byte short key do not cross-read: a get
    recomputes keccak256(value)."""
    src = store.NativeNodeDataSource(str(tmp_path), "n")
    v = b"some node"
    k = keccak256(v)
    src.put(k, v)
    assert src.get(b"\xde\xad" * 12 + k[-8:]) is None
    assert src.get(k) == v
    src.stop()


def test_kv_update_and_tombstone(tmp_path):
    src = store.NativeKeyValueDataSource(str(tmp_path), "kv")
    src.put(b"alpha", b"1")
    src.put(b"alpha", b"2")  # the newest record wins
    assert src.get(b"alpha") == b"2"
    src.remove(b"alpha")
    assert src.get(b"alpha") is None
    src.put(b"alpha", b"3")  # resurrected after the tombstone
    assert src.get(b"alpha") == b"3"
    src.stop()


def test_block_source_best_number_survives_reopen(tmp_path):
    src = store.NativeBlockDataSource(str(tmp_path), "header")
    assert src.best_block_number == -1
    src.update([], {0: b"h0", 1: b"h1", 2: b"h2"})
    assert src.best_block_number == 2
    src.update([2], {})  # a reorg's orphaning walks best down
    assert src.best_block_number == 1
    src.stop()
    again = store.NativeBlockDataSource(str(tmp_path), "header")
    assert again.get(1) == b"h1" and again.get(2) is None
    assert again.best_block_number == 1
    again.stop()


def test_restart_survival(tmp_path):
    src = store.NativeNodeDataSource(str(tmp_path), "account")
    upserts = {keccak256(b"x%d" % i): b"x%d" % i for i in range(100)}
    src.update([], upserts)
    src.stop()
    again = store.NativeNodeDataSource(str(tmp_path), "account")
    assert again.count == 100
    assert all(again.get(k) == v for k, v in upserts.items())
    again.stop()


def test_torn_tail_recovery(tmp_path):
    """A crash mid-append leaves a torn record: reopening truncates it
    and keeps every record before it."""
    src = store.NativeNodeDataSource(str(tmp_path), "account")
    good = {keccak256(b"keep%d" % i): b"keep%d" % i for i in range(10)}
    src.update([], good)
    src.stop()
    with open(tmp_path / "account.log", "ab") as f:
        f.write(struct.pack("<I", 1000) + b"only-a-fragment")
    again = store.NativeNodeDataSource(str(tmp_path), "account")
    assert again.count == 10
    assert all(again.get(k) == v for k, v in good.items())
    again.stop()


def test_stale_index_rebuilt_from_log(tmp_path):
    """Without its index sidecar a store rebuilds the index from the log,
    the source of truth."""
    src = store.NativeNodeDataSource(str(tmp_path), "account")
    upserts = {keccak256(b"v%d" % i): b"v%d" % i for i in range(20)}
    src.update([], upserts)
    src.stop()
    os.unlink(tmp_path / "account.idx")
    again = store.NativeNodeDataSource(str(tmp_path), "account")
    assert all(again.get(k) == v for k, v in upserts.items())
    again.stop()


# ------------------------------------------------ formats across packages

ENGINES = {
    "native": ((store.NativeNodeDataSource, store.NativeKeyValueDataSource,
                store.NativeBlockDataSource),
               (jx_store.NativeNodeDataSource,
                jx_store.NativeKeyValueDataSource,
                jx_store.NativeBlockDataSource)),
    "sqlite": ((sqlite_engine.SqliteNodeDataSource,
                sqlite_engine.SqliteKeyValueDataSource,
                sqlite_engine.SqliteBlockDataSource),
               (jx_sqlite.SqliteNodeDataSource,
                jx_sqlite.SqliteKeyValueDataSource,
                jx_sqlite.SqliteBlockDataSource)),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_files_read_back_through_the_other_package(engine, writer, tmp_path):
    """Node, key-value and block files written by one package's engine
    read back, byte for byte, through the other package's."""
    port, ref = ENGINES[engine]
    write, read = (port, ref) if writer == "port" else (ref, port)
    rng = np.random.default_rng(RNG_SEED)
    nodes = {keccak256(v): v for v in (rng.bytes(int(rng.integers(1, 600)))
                                       for _ in range(200))}
    kv = {rng.bytes(int(rng.integers(1, 40))): rng.bytes(50)
          for _ in range(50)}
    gone = sorted(kv)[:5]
    blocks = {n: rng.bytes(120) for n in range(30)}
    srcs = [cls(str(tmp_path), topic) for cls, topic in
            zip(write, ("account", "tx", "header"))]
    srcs[0].update([], nodes)
    srcs[1].update([], kv)
    srcs[1].update(gone, {})
    srcs[2].update([], blocks)
    srcs[2].update([29], {})
    for s in srcs:
        s.stop()
    got = [cls(str(tmp_path), topic) for cls, topic in
           zip(read, ("account", "tx", "header"))]
    assert all(got[0].get(k) == v for k, v in nodes.items())
    assert all(got[1].get(k) == (None if k in gone else v)
               for k, v in kv.items())
    assert all(got[2].get(n) == (None if n == 29 else v)
               for n, v in blocks.items())
    assert got[2].best_block_number == 28
    for s in got:
        s.stop()


# ------------------------------------------------------ a full chain


@pytest.mark.parametrize("window", [1, 4], ids=["serial", "window4"])
@pytest.mark.parametrize("engine", ["native", "sqlite"])
def test_chain_replays_into_persistent_engines(engine, window, tmp_path):
    """A chain built by the JAX package's ChainBuilder (an ERC-20 deploy
    and 3 blocks of 8 token transfers) replayed by both drivers into
    ``engine``, the port's with ``device_commit`` on the CPU: headers,
    receipts and reachable nodes equal, then equal again after both
    stores are stopped and reopened, each by its own package and by the
    other's."""
    jx_cfg, _ = _configs()
    keys, addrs = _keys(8, 70)
    alloc = {a: 10**22 for a in addrs}
    builder = JxChainBuilder(JxBlockchain(JxStorages(), jx_cfg), jx_cfg,
                             JxGenesisSpec(alloc=alloc))
    blocks = _erc20(builder, keys, addrs)
    wire = [b.encode() for b in blocks]
    n = len(blocks)
    jx_cfg = dataclasses.replace(
        jx_cfg, sync=JxSyncConfig(parallel_tx=False,
                                  commit_window_blocks=window))
    pt_cfg = workloads.replay_config(commit_window_blocks=window)
    jx_dir, pt_dir = str(tmp_path / "jax"), str(tmp_path / "port")

    jx_chain = JxBlockchain(JxStorages(engine, jx_dir), jx_cfg)
    jx_chain.load_genesis(JxGenesisSpec(alloc=alloc))
    JxReplayDriver(jx_chain, jx_cfg).replay(
        [jx_block.Block.decode(w) for w in wire])
    pt_chain = Blockchain(Storages(engine, pt_dir), pt_cfg)
    pt_chain.load_genesis(GenesisSpec(alloc=alloc), on_device=True,
                          device="cpu")
    stats = ReplayDriver(pt_chain, pt_cfg, device_commit=True,
                         device="cpu").replay([Block.decode(w) for w in wire])
    assert stats.blocks == n
    _assert_same_chain(pt_chain, jx_chain, n)
    root = blocks[-1].header.state_root
    want = _reachable(pt_chain.storages, root)
    assert pt_chain.storages.window_journal.pending() == []
    pt_chain.storages.stop()
    jx_chain.storages.stop()

    for d in (pt_dir, jx_dir):
        again = Blockchain(Storages(engine, d), pt_cfg)
        assert again.best_block_number == n
        assert again.get_header_by_number(n).state_root == root
        assert _reachable(again.storages, root) == want
        assert all(again.storages.receipts_storage.get(i)
                   == builder.blockchain.storages.receipts_storage.get(i)
                   for i in range(1, n + 1))
        jx_again = JxBlockchain(JxStorages(engine, d), jx_cfg)
        _assert_same_chain(again, jx_again, n)
        assert _reachable(jx_again.storages, root, jx_compact) == want
        again.storages.stop()
        jx_again.storages.stop()


def test_storages_engine_arguments():
    for engine in ("native", "sqlite", "kesque"):
        with pytest.raises(ValueError, match="requires data_dir"):
            Storages(engine=engine)
    with pytest.raises(ValueError, match="unknown db.engine"):
        Storages(engine="rocksdb", data_dir="/nonexistent")
    st = Storages(unconfirmed_depth=3, cache_size=16)
    st.switch_to_unconfirmed()
    st.clear_unconfirmed()
    st.stop()
