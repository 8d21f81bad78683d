"""Ethash proof-of-work: epoch cache, light dataset items, hashimoto.

Parity: consensus/pow/EthashAlgo.scala:49 (makeCache :76 — seed chain +
3 rounds of FNV randmemohash; calcDatasetItem :97; hashimoto :143) and
Ethash.scala:52 (epoch cache management, validate :301). Light
verification only — full-dataset mining tables are a miner concern; the
validator computes the handful of dataset items each hashimoto needs
directly from the cache, which is what validate() does in the reference
too.

The port's copy of ``khipu_tpu.consensus.ethash``: it stays on the
host. Numpy does the word mixing (the cache is a [n, 16] uint32 array;
FNV and the 128-byte mix are vectorized); keccak256/512 come from the
native C++ sponge. Sizes are the spec's by default; tests may pass a
reduced cache_bytes to keep epoch generation in CI budget (the
algorithm is size-generic, exactly like the reference's EthashParams).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from khipu_tpu_torch.base.keccak import keccak256, keccak512

WORD_BYTES = 4
DATASET_BYTES_INIT = 1 << 30
DATASET_BYTES_GROWTH = 1 << 23
CACHE_BYTES_INIT = 1 << 24
CACHE_BYTES_GROWTH = 1 << 17
EPOCH_LENGTH = 30_000
MIX_BYTES = 128
HASH_BYTES = 64
DATASET_PARENTS = 256
CACHE_ROUNDS = 3
ACCESSES = 64
FNV_PRIME = 0x01000193
_U32 = 0xFFFFFFFF


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def cache_size(epoch: int) -> int:
    sz = CACHE_BYTES_INIT + CACHE_BYTES_GROWTH * epoch - HASH_BYTES
    while not _is_prime(sz // HASH_BYTES):
        sz -= 2 * HASH_BYTES
    return sz


def dataset_size(epoch: int) -> int:
    sz = DATASET_BYTES_INIT + DATASET_BYTES_GROWTH * epoch - MIX_BYTES
    while not _is_prime(sz // MIX_BYTES):
        sz -= 2 * MIX_BYTES
    return sz


def seed_hash(epoch: int) -> bytes:
    seed = b"\x00" * 32
    for _ in range(epoch):
        seed = keccak256(seed)
    return seed


def _fnv(a, b):
    # widen to u64 for the multiply: u32 * u32 wraps (intentionally) but
    # numpy warns on scalar overflow; the mask keeps the math identical
    a64 = np.asarray(a, dtype=np.uint64)
    return (((a64 * FNV_PRIME) & _U32) ^ np.asarray(b, dtype=np.uint64)).astype(
        np.uint32
    )


class EthashCache:
    """One epoch's cache (makeCache :76): seed chain + CACHE_ROUNDS of
    the RandMemoHash strengthening pass."""

    def __init__(self, epoch: int, cache_bytes: Optional[int] = None):
        self.epoch = epoch
        self.seed = seed_hash(epoch)
        n_bytes = cache_bytes if cache_bytes is not None else cache_size(epoch)
        n = n_bytes // HASH_BYTES
        rows = [keccak512(self.seed)]
        for _ in range(n - 1):
            rows.append(keccak512(rows[-1]))
        buf = bytearray(b"".join(rows))
        view = memoryview(buf)
        for _ in range(CACHE_ROUNDS):
            for i in range(n):
                v = int.from_bytes(view[i * 64 : i * 64 + 4], "little") % n
                j = (i - 1 + n) % n
                mixed = bytes(
                    x ^ y
                    for x, y in zip(
                        view[j * 64 : j * 64 + 64], view[v * 64 : v * 64 + 64]
                    )
                )
                view[i * 64 : i * 64 + 64] = keccak512(mixed)
        self.cache = np.frombuffer(bytes(buf), dtype="<u4").reshape(n, 16)
        self.n_rows = n

    def calc_dataset_item(self, i: int) -> np.ndarray:
        """calcDatasetItem :97 — one 64-byte full-dataset item from the
        cache (DATASET_PARENTS FNV-mixed cache rows)."""
        n = self.n_rows
        r = HASH_BYTES // WORD_BYTES  # 16
        mix = self.cache[i % n].copy()
        mix[0] ^= i
        mix = np.frombuffer(keccak512(mix.tobytes()), dtype="<u4").copy()
        for j in range(DATASET_PARENTS):
            parent = int(_fnv(np.uint32(i ^ j), mix[j % r])) % n
            mix = _fnv(mix, self.cache[parent])
        return np.frombuffer(keccak512(mix.tobytes()), dtype="<u4")

    def calc_dataset_batch(self, idxs: np.ndarray) -> np.ndarray:
        """Vectorized calc_dataset_item over a whole index batch: the
        256-parent FNV mix runs as numpy gathers across the batch
        (bit-identical to the scalar path — the generation test diffs
        them), leaving only the two keccak512 passes per item as host
        loops. This is what makes full-DAG generation minutes instead
        of days at spec size."""
        n = self.n_rows
        r = HASH_BYTES // WORD_BYTES  # 16
        idxs = np.asarray(idxs, dtype=np.uint64)
        mix = self.cache[(idxs % n).astype(np.int64)].copy()  # [B, 16]
        mix[:, 0] ^= idxs.astype(np.uint32)
        for b in range(len(idxs)):
            mix[b] = np.frombuffer(
                keccak512(mix[b].tobytes()), dtype="<u4"
            )
        i32 = idxs.astype(np.uint32)
        for j in range(DATASET_PARENTS):
            parent = (
                _fnv(i32 ^ np.uint32(j), mix[:, j % r]).astype(np.int64)
                % n
            )
            mix = _fnv(mix, self.cache[parent])
        out = np.empty_like(mix)
        for b in range(len(idxs)):
            out[b] = np.frombuffer(
                keccak512(mix[b].tobytes()), dtype="<u4"
            )
        return out


class EthashDataset:
    """Full dataset, file-cached (calcDataset + the DAG file cache,
    Ethash.scala:65-164,196): every 64-byte item precomputed from the
    epoch cache, memory-mapped from disk on reuse so miner restarts
    skip the multi-minute regeneration. ``full_size`` defaults to the
    spec size (1 GiB+, the production path); tests pass a reduced size
    (multiple of MIX_BYTES) — the algorithm is size-parametric, so the
    reduced epoch exercises the identical code path."""

    def __init__(self, cache: EthashCache,
                 full_size: Optional[int] = None,
                 cache_dir: Optional[str] = None):
        import os
        import tempfile

        self.cache = cache
        self.full_size = (
            full_size if full_size is not None
            else dataset_size(cache.epoch)
        )
        if self.full_size % MIX_BYTES:
            raise ValueError("full_size must be a multiple of MIX_BYTES")
        n_items = self.full_size // HASH_BYTES
        cache_dir = cache_dir or os.path.join(
            tempfile.gettempdir(), "khipu-ethash"
        )
        os.makedirs(cache_dir, exist_ok=True)
        seed = seed_hash(cache.epoch)
        self.path = os.path.join(
            cache_dir,
            f"full-{seed[:8].hex()}-{self.full_size}.bin",
        )
        if (
            os.path.exists(self.path)
            and os.path.getsize(self.path) == self.full_size
        ):
            self.data = np.memmap(
                self.path, dtype="<u4", mode="r"
            ).reshape(n_items, 16)
            # spot-check SEVERAL rows against the cache derivation: a
            # stale or corrupt DAG file must not validate blocks, and a
            # single fixed probe misses mid-file corruption. Rows are
            # pseudo-random but seeded from the epoch seed, so every
            # reuse of the same file checks the same rows (cheap, and a
            # regression stays reproducible); first/middle/last anchor
            # the extremes.
            rng = np.random.default_rng(
                int.from_bytes(seed[:8], "big") ^ n_items
            )
            probes = {0, n_items // 2, n_items - 1} | {
                int(i) for i in rng.integers(0, n_items, size=8)
            }
            for probe in sorted(probes):
                if not np.array_equal(
                    self.data[probe], cache.calc_dataset_item(probe)
                ):
                    self.data = None  # regenerate below
                    break
        else:
            self.data = None
        if self.data is None:
            # batched generation (calc_dataset_batch): the parent-mix
            # loop vectorizes across each batch; spec-size DAGs take
            # minutes (keccak512-bound), not the days a per-item Python
            # loop would. Written to a temp path + rename so a
            # concurrent generator never serves a half-written DAG.
            arr = np.empty((n_items, 16), dtype="<u4")
            step = 1 << 14
            for start in range(0, n_items, step):
                idxs = np.arange(
                    start, min(start + step, n_items), dtype=np.uint64
                )
                arr[start : start + len(idxs)] = (
                    cache.calc_dataset_batch(idxs)
                )
            tmp = f"{self.path}.{os.getpid()}.tmp"
            arr.tofile(tmp)
            os.replace(tmp, self.path)
            self.data = np.memmap(
                self.path, dtype="<u4", mode="r"
            ).reshape(n_items, 16)

    def item(self, i: int) -> np.ndarray:
        return self.data[i]


def _hashimoto(lookup, n: int, header_hash: bytes,
               nonce: int) -> Tuple[bytes, bytes]:
    """hashimoto :143 core, parametric over the dataset-item source
    (light: derive from cache; full: read the DAG). Returns
    (mix_digest, result)."""
    w = MIX_BYTES // WORD_BYTES  # 32
    mixhashes = MIX_BYTES // HASH_BYTES  # 2

    s_bytes = keccak512(header_hash + nonce.to_bytes(8, "little"))
    s = np.frombuffer(s_bytes, dtype="<u4")
    mix = np.tile(s, mixhashes).copy()  # 32 words

    for i in range(ACCESSES):
        p = (
            int(_fnv(np.uint32(i ^ s[0]), mix[i % w])) % (n // mixhashes)
        ) * mixhashes
        newdata = np.concatenate(
            [lookup(p + j) for j in range(mixhashes)]
        )
        mix = _fnv(mix, newdata)

    cmix = np.zeros(w // 4, dtype=np.uint32)
    for i in range(0, w, 4):
        cmix[i // 4] = int(
            _fnv(_fnv(_fnv(mix[i], mix[i + 1]), mix[i + 2]), mix[i + 3])
        )
    mix_digest = cmix.tobytes()
    result = keccak256(s_bytes + mix_digest)
    return mix_digest, result


def hashimoto_light(
    cache: EthashCache,
    header_hash: bytes,
    nonce: int,
    full_size: Optional[int] = None,
) -> Tuple[bytes, bytes]:
    """Validator-grade path: dataset items derived on the fly from the
    epoch cache. full_size defaults to the epoch's dataset size;
    reduced-cache tests pass a matching reduced size (multiple of
    MIX_BYTES)."""
    if full_size is None:
        full_size = dataset_size(cache.epoch)
    return _hashimoto(
        cache.calc_dataset_item, full_size // HASH_BYTES,
        header_hash, nonce,
    )


def hashimoto_full(
    dataset: EthashDataset, header_hash: bytes, nonce: int
) -> Tuple[bytes, bytes]:
    """Miner-grade path: dataset items read from the precomputed DAG
    (O(1) per access instead of DATASET_PARENTS cache mixes)."""
    return _hashimoto(
        dataset.item, dataset.full_size // HASH_BYTES,
        header_hash, nonce,
    )


def check_pow(
    cache: EthashCache,
    header_hash: bytes,
    mix_digest: bytes,
    nonce: int,
    difficulty: int,
    full_size: Optional[int] = None,
) -> bool:
    """validate :301: recompute the mix, check digest equality and the
    2^256/difficulty bound."""
    if difficulty <= 0:
        return False  # cheap reject before the 64-access hashimoto
    mix, result = hashimoto_light(cache, header_hash, nonce, full_size)
    if mix != mix_digest:
        return False
    return int.from_bytes(result, "big") <= (1 << 256) // difficulty


def _mine(hashimoto_fn, header_hash: bytes, difficulty: int,
          start_nonce: int, max_tries: int) -> Tuple[int, bytes]:
    """One nonce-scan core (Miner.scala:40 role), parametric over the
    hashimoto path — light and full share the bound semantics."""
    if difficulty <= 0:
        raise ValueError("difficulty must be positive")
    bound = (1 << 256) // difficulty
    for nonce in range(start_nonce, start_nonce + max_tries):
        mix, result = hashimoto_fn(header_hash, nonce)
        if int.from_bytes(result, "big") <= bound:
            return nonce, mix
    raise RuntimeError("nonce space exhausted")


def mine(
    cache: EthashCache,
    header_hash: bytes,
    difficulty: int,
    start_nonce: int = 0,
    full_size: Optional[int] = None,
    max_tries: int = 1 << 20,
) -> Tuple[int, bytes]:
    """Validator-grade scan: items derived from the epoch cache."""
    return _mine(
        lambda h, n: hashimoto_light(cache, h, n, full_size),
        header_hash, difficulty, start_nonce, max_tries,
    )


def mine_full(
    dataset: EthashDataset,
    header_hash: bytes,
    difficulty: int,
    start_nonce: int = 0,
    max_tries: int = 1 << 20,
) -> Tuple[int, bytes]:
    """Miner-grade scan over the precomputed DAG (Ethash.scala:65-164
    path): each attempt costs ACCESSES dataset reads instead of
    ACCESSES x DATASET_PARENTS cache mixes."""
    return _mine(
        lambda h, n: hashimoto_full(dataset, h, n),
        header_hash, difficulty, start_nonce, max_tries,
    )
