"""Ethash, keccak512, the pending pool and the miner: the port against the
JAX package on the same seeded inputs.

Everything here is host code in both packages (numpy and the native
sponge), so every comparison is exact: digests, cache bytes, dataset
items, (nonce, mix) pairs, pool contents and mined block hashes.
Ethash runs at reduced sizes (the algorithm is size-generic, as the
JAX package's own tests use it); the light hashimoto costs ~0.4 s, so
seals are searched on the full (DAG) path and held on the light one.
"""

import dataclasses

import numpy as np
import pytest

from khipu_tpu.base.crypto import keccak as jx_keccak
from khipu_tpu.consensus import ethash as jx
from khipu_tpu_torch.base import keccak as pt_keccak
from khipu_tpu_torch.consensus import ethash as pt

CACHE_BYTES = 64 * 1024  # 1,024 cache rows
SMALL_CACHE = 1024  # 16 rows, for the DAG paths
FULL = 64 * 128  # 128 dataset items (a multiple of MIX_BYTES)


@pytest.fixture(scope="module")
def caches():
    return pt.EthashCache(0, cache_bytes=SMALL_CACHE), jx.EthashCache(
        0, cache_bytes=SMALL_CACHE)


@pytest.fixture(scope="module")
def datasets(caches, tmp_path_factory):
    d = tmp_path_factory.mktemp("dag")
    return (pt.EthashDataset(caches[0], FULL, cache_dir=str(d / "port")),
            jx.EthashDataset(caches[1], FULL, cache_dir=str(d / "jax")))


def _seeded(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 400, n)]


# ----------------------------------------------------------- keccak512


@pytest.mark.parametrize("n", [0, 71, 72, 73, 144])
def test_keccak512_rate_edges(n):
    msg = bytes((i * 7 + 3) % 256 for i in range(n))
    want = jx_keccak.keccak512(msg)
    assert pt_keccak.keccak512(msg) == want
    assert pt_keccak.keccak512_py(msg) == want == jx_keccak.keccak512_py(msg)


def test_keccak512_seeded():
    for msg in _seeded(64):
        assert pt_keccak.keccak512(msg) == jx_keccak.keccak512(msg)
    for msg in _seeded(8, seed=10):
        assert pt_keccak.keccak512_py(msg) == jx_keccak.keccak512(msg)


# --------------------------------------------------------------- sizes


@pytest.mark.parametrize("epoch", [0, 1, 100, 2047])
def test_epoch_parameters(epoch):
    assert pt.seed_hash(epoch) == jx.seed_hash(epoch)
    assert pt.cache_size(epoch) == jx.cache_size(epoch)
    assert pt.dataset_size(epoch) == jx.dataset_size(epoch)


def test_spec_sizes():
    assert pt.cache_size(0) == 16_776_896
    assert pt.dataset_size(0) == 1_073_739_904


# --------------------------------------------------------- cache, items


@pytest.mark.parametrize("epoch", [0, 1])
def test_cache_bytes_equal(epoch):
    a = pt.EthashCache(epoch, cache_bytes=CACHE_BYTES)
    b = jx.EthashCache(epoch, cache_bytes=CACHE_BYTES)
    assert a.n_rows == b.n_rows == CACHE_BYTES // 64
    assert a.cache.tobytes() == b.cache.tobytes()


def test_dataset_items(caches):
    pc, jc = caches
    idxs = np.array([0, 1, 7, 63, 64, 127, 1000], dtype=np.uint64)
    batch = pc.calc_dataset_batch(idxs)
    assert batch.tobytes() == jc.calc_dataset_batch(idxs).tobytes()
    for k, i in enumerate(idxs):
        item = pc.calc_dataset_item(int(i))
        assert item.tobytes() == batch[k].tobytes()
        assert item.tobytes() == jc.calc_dataset_item(int(i)).tobytes()


# ----------------------------------------------------------- hashimoto


def test_hashimoto_light_and_full(caches, datasets):
    pc, jc = caches
    pd, jd = datasets
    assert np.asarray(pd.data).tobytes() == np.asarray(jd.data).tobytes()
    h = b"\x5a" * 32
    for nonce in (0, 1, 77, 2**63 + 5):
        full = pt.hashimoto_full(pd, h, nonce)
        assert full == jx.hashimoto_full(jd, h, nonce)
    light = pt.hashimoto_light(pc, h, 77, FULL)
    assert light == jx.hashimoto_light(jc, h, 77, FULL)
    assert light == pt.hashimoto_full(pd, h, 77)


def _quick_seal(dataset, difficulty):
    """A header hash whose first winning nonce is 0 or 1, searched on the
    DAG, so the light search in each package costs at most two
    hashimotos."""
    for i in range(400):
        h = pt_keccak.keccak256(b"seal-%d" % i)
        nonce, mix = pt.mine_full(dataset, h, difficulty)
        if nonce <= 1:
            return h, nonce, mix
    raise AssertionError("no quick seal in 400 headers")


def test_mine_equal_and_tampered_rejected(caches, datasets):
    pc, jc = caches
    pd, jd = datasets
    h, nonce, mix = _quick_seal(pd, 16)
    assert jx.mine_full(jd, h, 16) == (nonce, mix)
    assert pt.mine(pc, h, 16, full_size=FULL) == (nonce, mix)
    assert jx.mine(jc, h, 16, full_size=FULL) == (nonce, mix)
    # each light check costs ~0.4 s: the tampered seals in the port, the
    # JAX package's verdicts on the mined one and on nonce + 1
    assert jx.check_pow(jc, h, mix, nonce, 16, FULL)
    assert not jx.check_pow(jc, h, mix, nonce + 1, 16, FULL)
    assert pt.check_pow(pc, h, mix, nonce, 16, FULL)
    assert not pt.check_pow(pc, h, mix, nonce + 1, 16, FULL)
    bad_mix = bytes([mix[0] ^ 1]) + mix[1:]
    assert not pt.check_pow(pc, h, bad_mix, nonce, 16, FULL)
    assert not pt.check_pow(pc, h, mix, nonce, 1 << 255, FULL)
    assert not pt.check_pow(pc, h, mix, nonce, 0, FULL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dag_file_read_across_packages(tmp_path, writer):
    """A DAG file one package generated is memory-mapped by the other
    (same name, same bytes; its spot-check passes, so nothing is
    regenerated), and a corrupt one is regenerated by the reader."""
    make = {"port": pt, "jax": jx}
    w, r = make[writer], make["jax" if writer == "port" else "port"]
    first = w.EthashDataset(w.EthashCache(0, cache_bytes=SMALL_CACHE), FULL,
                            cache_dir=str(tmp_path))
    mtime = (tmp_path / first.path.split("/")[-1]).stat().st_mtime_ns
    second = r.EthashDataset(r.EthashCache(0, cache_bytes=SMALL_CACHE), FULL,
                             cache_dir=str(tmp_path))
    assert second.path.split("/")[-1] == first.path.split("/")[-1]
    assert (tmp_path / first.path.split("/")[-1]).stat().st_mtime_ns == mtime
    clean = np.asarray(first.data).tobytes()
    assert np.asarray(second.data).tobytes() == clean
    arr = np.memmap(first.path, dtype="<u4", mode="r+")
    arr[(FULL // 64 // 2) * 16] ^= 1
    arr.flush()
    del arr
    third = r.EthashDataset(r.EthashCache(0, cache_bytes=SMALL_CACHE), FULL,
                            cache_dir=str(tmp_path))
    assert np.asarray(third.data).tobytes() == clean


# ----------------------------------------------------- header seal hook


def _header(mod, number, difficulty, ts, parent_hash=b"\x00" * 32):
    return mod.BlockHeader(
        parent_hash=parent_hash, ommers_hash=mod.EMPTY_OMMERS_HASH,
        beneficiary=b"\x00" * 20, state_root=b"\x00" * 32,
        transactions_root=b"\x00" * 32, receipts_root=b"\x00" * 32,
        logs_bloom=b"\x00" * 256, difficulty=difficulty, number=number,
        gas_limit=8_000_000, gas_used=0, unix_timestamp=ts,
    )


def test_header_seal_hook(caches, datasets):
    """BlockHeaderValidator's seal_check wired to check_pow: a header
    sealed on the DAG passes both packages' validators, a nonce + 1 or
    a flipped mix byte raises HeaderValidationError in both."""
    from khipu_tpu.config import fixture_config as jx_fixture
    from khipu_tpu.domain import block_header as jx_bh
    from khipu_tpu.validators import validators as jx_val
    from khipu_tpu_torch.config import fixture_config as pt_fixture
    from khipu_tpu_torch.domain import block_header as pt_bh
    from khipu_tpu_torch.validators import validators as pt_val

    pd, _ = datasets
    sealed = {}
    for name, bh in (("port", pt_bh), ("jax", jx_bh)):
        parent = _header(bh, 0, 8, 0)
        base = _header(bh, 1, 8, 13, parent.hash)
        pow_hash = (pt_keccak.keccak256 if name == "port"
                    else jx_keccak.keccak256)(base.encode_without_nonce())
        nonce, mix = pt.mine_full(pd, pow_hash, 8)
        sealed[name] = (parent, dataclasses.replace(
            base, mix_hash=mix, nonce=nonce.to_bytes(8, "big")))
    assert sealed["port"][1].hash == sealed["jax"][1].hash
    for name, mod, cache, val, fixture, kec in (
        ("port", pt, caches[0], pt_val, pt_fixture, pt_keccak.keccak256),
        ("jax", jx, caches[1], jx_val, jx_fixture, jx_keccak.keccak256),
    ):
        def seal_ok(h, mod=mod, cache=cache, kec=kec):
            return mod.check_pow(cache, kec(h.encode_without_nonce()),
                                 h.mix_hash, int.from_bytes(h.nonce, "big"),
                                 h.difficulty, FULL)

        parent, good = sealed[name]
        v = val.BlockHeaderValidator(fixture().blockchain,
                                     seal_check=seal_ok)
        v.validate(good, parent)
        nonce = int.from_bytes(good.nonce, "big")
        bads = [dataclasses.replace(good,
                                    nonce=(nonce + 1).to_bytes(8, "big"))]
        if name == "port":
            bads.append(dataclasses.replace(
                good, mix_hash=bytes([good.mix_hash[0] ^ 1])
                + good.mix_hash[1:]))
        for bad in bads:
            with pytest.raises(val.HeaderValidationError):
                v.validate(bad, parent)


# -------------------------------------------------------------- tx pool


def _pool_txs(pkg):
    """The same signed transactions in either package: 3 senders, two
    slots each, plus same-slot bids (one outbidding, one not)."""
    if pkg == "port":
        from khipu_tpu_torch.domain.transaction import (
            Transaction,
            sign_transaction,
        )
    else:
        from khipu_tpu.domain.transaction import Transaction, sign_transaction
    keys = [(i + 41).to_bytes(32, "big") for i in range(3)]
    out = []
    for k, key in enumerate(keys):
        for nonce in range(2):
            out.append(sign_transaction(
                Transaction(nonce, 10**9 + k, 21_000, b"\x77" * 20,
                            1 + nonce), key, chain_id=1))
    outbid = sign_transaction(Transaction(0, 3 * 10**9, 21_000, b"\x78" * 20,
                                          5), keys[2], chain_id=1)
    underbid = sign_transaction(Transaction(1, 1, 21_000, b"\x78" * 20, 5),
                                keys[1], chain_id=1)
    return out, outbid, underbid


def _drive_pool(pkg):
    if pkg == "port":
        from khipu_tpu_torch.txpool import PendingTransactionsPool
    else:
        from khipu_tpu.txpool import PendingTransactionsPool
    txs, outbid, underbid = _pool_txs(pkg)
    pool = PendingTransactionsPool(capacity=5)
    log = [pool.add(t) for t in txs]  # the sixth evicts the oldest
    log += [pool.add(txs[3]), pool.add(outbid), pool.add(underbid)]
    snaps = [[t.hash for t in pool.pending()]]
    log.append(pool.remove_mined([txs[2], txs[0], outbid, txs[4]]))
    snaps.append([t.hash for t in pool.pending()])
    cursor = pool.cursor()
    log.append(pool.add(txs[0]))
    new, cur = pool.arrivals_since(cursor)
    snaps.append([t.hash for t in pool.pending()])
    return (log, snaps, new, cur, pool.evictions, pool.replacements,
            pool.rejected_underpriced, len(pool))


def test_txpool_sequences_equal():
    got, want = _drive_pool("port"), _drive_pool("jax")
    assert got == want
    assert got[4] >= 1 and got[5] == 1 and got[6] == 1  # each rule fired


def test_ommers_pool_equal():
    from khipu_tpu.txpool import OmmersPool as JxOmmers
    from khipu_tpu_torch.domain import block_header as pt_bh
    from khipu_tpu.domain import block_header as jx_bh
    from khipu_tpu_torch.txpool import OmmersPool as PtOmmers

    out = []
    for pool_cls, bh in ((PtOmmers, pt_bh), (JxOmmers, jx_bh)):
        pool = pool_cls(capacity=4)
        for n in range(1, 9):
            pool.add(_header(bh, n, 8, 13 * n))
        out.append([h.hash for h in pool.candidates(10)])
    assert out[0] == out[1] and len(out[0]) == 4  # 5..8 kept, within 6


# ---------------------------------------------------------------- miner


def _mine_three(pkg, tmp_path, monkeypatch):
    if pkg == "port":
        from khipu_tpu_torch.base.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu_torch.config import fixture_config
        from khipu_tpu_torch.domain import difficulty as diff_mod
        from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu_torch.domain.transaction import (
            Transaction,
            sign_transaction,
        )
        from khipu_tpu_torch.mining import Miner
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.chain_builder import ChainBuilder
        from khipu_tpu_torch.txpool import PendingTransactionsPool
        mod = pt
    else:
        from khipu_tpu.base.crypto.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu.config import fixture_config
        from khipu_tpu.domain import difficulty as diff_mod
        from khipu_tpu.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu.domain.transaction import Transaction, sign_transaction
        from khipu_tpu.mining import Miner
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.chain_builder import ChainBuilder
        from khipu_tpu.txpool import PendingTransactionsPool
        mod = jx
    # dev-grade difficulty: the floor dropped so the seal search is
    # short (the algorithm and the check are the same at any difficulty)
    monkeypatch.setattr(diff_mod, "MIN_DIFFICULTY", 4)
    cfg = fixture_config(chain_id=1)
    keys = [(i + 1).to_bytes(32, "big") for i in range(3)]
    addrs = [pubkey_to_address(privkey_to_pubkey(k)) for k in keys]
    bc = Blockchain(Storages(), cfg)
    ChainBuilder(bc, cfg, GenesisSpec(alloc={a: 10**21 for a in addrs},
                                      difficulty=4))
    pool = PendingTransactionsPool()
    for k, key in enumerate(keys):
        for nonce in range(3):
            pool.add(sign_transaction(
                Transaction(nonce, 10**9, 21_000, addrs[(k + 1) % 3],
                            7 + nonce), key, chain_id=1))
    # a stale nonce the miner must drop
    pool.add(sign_transaction(Transaction(9, 10**9, 21_000, addrs[0], 1),
                              keys[2], chain_id=1))
    cache = mod.EthashCache(0, cache_bytes=SMALL_CACHE)
    miner = Miner(bc, cfg, pool, coinbase=b"\xaa" * 20, ethash_cache=cache,
                  full_size=FULL, use_dataset=True,
                  dag_dir=str(tmp_path / pkg))
    blocks = [miner.mine_next() for _ in range(3)]
    heads = [bc.get_header_by_number(n).hash for n in (1, 2, 3)]
    return [b.hash for b in blocks], heads, len(pool)


def test_miner_three_sealed_blocks_equal(tmp_path, monkeypatch):
    got = _mine_three("port", tmp_path, monkeypatch)
    want = _mine_three("jax", tmp_path, monkeypatch)
    assert got == want
    assert got[0] == got[1]  # the sealed blocks are the stored heads
    assert got[2] == 0  # every pooled tx mined or dropped


def test_miner_refuses_a_peer_manager():
    """The network layer is ported: a Miner no longer refuses a peer
    manager, and pushes each sealed block through ``propagate_block``
    (NewBlock to ceil(sqrt(peers)) live peers, the hash announce to the
    rest). The full loopback case is ``test_torch_live_sync.py``."""
    from khipu_tpu_torch.config import fixture_config
    from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
    from khipu_tpu_torch.mining import Miner
    from khipu_tpu_torch.network.messages import (
        ETH_OFFSET,
        NEW_BLOCK,
        NEW_BLOCK_HASHES,
        decode_new_block,
    )
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.chain_builder import ChainBuilder
    from khipu_tpu_torch.txpool import PendingTransactionsPool

    class _Peer:
        alive = True

        def __init__(self):
            self.sent = []

        def send(self, code, body):
            self.sent.append((code, body))

    class _Manager:
        peers = [_Peer() for _ in range(4)]

    cfg = fixture_config(chain_id=1)
    bc = Blockchain(Storages(), cfg)
    ChainBuilder(bc, cfg, GenesisSpec(alloc={b"\x01" * 20: 10**21}))
    manager = _Manager()
    block = Miner(bc, cfg, PendingTransactionsPool(), b"\xaa" * 20,
                  peer_manager=manager).mine_next()
    codes = [p.sent[0][0] for p in manager.peers]
    assert codes == [ETH_OFFSET + NEW_BLOCK] * 2 + [
        ETH_OFFSET + NEW_BLOCK_HASHES] * 2
    pushed, td = decode_new_block(manager.peers[0].sent[0][1])
    assert pushed.hash == block.hash == bc.get_hash_by_number(1)
    assert td == bc.get_total_difficulty(1)
