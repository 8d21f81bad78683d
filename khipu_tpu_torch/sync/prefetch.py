"""Pipelined sender recovery: prefetch thread + process-wide cache.

The port's counterpart of ``khipu_tpu.sync.prefetch``.
``recover_senders`` is a pure function of tx bytes (signing preimage +
v/r/s), so nothing forces it onto the block's critical path:

* **SenderPrefetcher** — a daemon thread that pulls blocks off the
  source iterator ahead of the driver, recovers their senders (native
  ECDSA recovery, a ctypes call that releases the interpreter lock),
  and hands them over a bounded queue. With batch hashing on the card,
  each block's cache misses are hashed in one K1r launch from this
  thread while the driver launches K1r for its trie commits.
* **Process-wide sender cache** — an LRU keyed by
  ``(signing_preimage, v, r, s)``. The sender is a pure function of
  exactly that tuple, so the key is sound without computing the tx
  hash; re-imports and the re-decode after a wire round-trip never pay
  recovery twice.

``khipu_sender_prefetch`` gauges expose the cache's behavior and the
card batches; flush_sender_cache() exists for tests and for runs that
want a deliberately cold first pass.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Iterable, Iterator, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    ecdsa_recover_batch,
    pubkey_to_address,
)
from khipu_tpu_torch.base.rlp import rlp_encode
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.evm.dataword import to_minimal_bytes
from khipu_tpu_torch.observability.registry import REGISTRY

PREFETCH_GAUGES = REGISTRY.gauge_group("khipu_sender_prefetch", {
    "hits": 0,  # senders served from the process-wide cache
    "misses": 0,  # senders that paid native ECDSA recovery
    "blocks": 0,  # blocks processed by recover_block_senders
    "evictions": 0,  # LRU entries dropped at capacity
    "device_batches": 0,  # signing-hash batches hashed on the card (K1r)
}, help="pipelined sender recovery (sync/prefetch.py)")
_GAUGE_LOCK = threading.Lock()


# (signing_preimage, v, r, s) -> sender | None. The preimage rlp is
# needed for the signing hash anyway, so a hit costs one encode + one
# dict probe — no keccak, no curve math.
_CACHE: "OrderedDict[tuple, Optional[bytes]]" = OrderedDict()
_CACHE_LOCK = threading.Lock()
_ABSENT = object()


def flush_sender_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def sender_cache_len() -> int:
    with _CACHE_LOCK:
        return len(_CACHE)


def _signing_preimage(stx, chain_id: Optional[int]) -> bytes:
    fields = stx.tx._base_fields()
    if chain_id is not None:
        fields += [to_minimal_bytes(chain_id), b"", b""]
    return rlp_encode(fields)


def _batch_hash_wanted(flag: bool, device) -> bool:
    """Device-batched signing hashes only pay where the device wins:
    host keccak is native C, so with ``device="cpu"`` the hashes stay
    scalar. ``device=None`` means the card."""
    return flag and resolve_device(device).type == "cuda"


def recover_block_senders(
    stxs, cache_entries: int = 65536, batch_hash: bool = False,
    device=None,
) -> None:
    """recover_senders with the process-wide cache in front: fill the
    per-object ``sender`` memo for every tx of a block, paying native
    recovery only for cache misses (one batched native call). With
    ``batch_hash`` on the card (``device=None``), the misses' signing
    hashes go through one K1r launch."""
    todo = []
    hits = misses = evictions = 0
    for stx in stxs:
        if "sender" in stx.__dict__:
            continue
        recid, chain_id = stx._recid_chain_id()
        if recid is None:
            stx.__dict__["sender"] = None
            continue
        key = (_signing_preimage(stx, chain_id), stx.v, stx.r, stx.s)
        with _CACHE_LOCK:
            sender = _CACHE.get(key, _ABSENT)
            if sender is not _ABSENT:
                _CACHE.move_to_end(key)
        if sender is not _ABSENT:
            stx.__dict__["sender"] = sender
            hits += 1
        else:
            todo.append((stx, key, recid))
            misses += 1
    if todo:
        if _batch_hash_wanted(batch_hash, device):
            from khipu_tpu_torch.ops.keccak import keccak256_batch

            hashes = keccak256_batch([key[0] for _, key, _ in todo], device)
            with _GAUGE_LOCK:
                PREFETCH_GAUGES["device_batches"] += 1
        else:
            hashes = [keccak256(key[0]) for _, key, _ in todo]
        pubs = ecdsa_recover_batch([
            (h, recid, stx.r, stx.s)
            for h, (stx, _, recid) in zip(hashes, todo)
        ])
        with _CACHE_LOCK:
            for (stx, key, _), pub in zip(todo, pubs):
                sender = (
                    pubkey_to_address(pub) if pub is not None else None
                )
                stx.__dict__["sender"] = sender
                _CACHE[key] = sender
            while len(_CACHE) > cache_entries:
                _CACHE.popitem(last=False)
                evictions += 1
    with _GAUGE_LOCK:
        PREFETCH_GAUGES["evictions"] += evictions
        PREFETCH_GAUGES["hits"] += hits
        PREFETCH_GAUGES["misses"] += misses
        PREFETCH_GAUGES["blocks"] += 1


_DONE = object()


class _PrefetchError:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class SenderPrefetcher:
    """Wrap a block iterator: a daemon thread recovers each block's
    senders before the block reaches the consumer. Bounded queue
    (``depth`` blocks ahead); source exceptions propagate to the
    consumer at the position they occurred; ``close()`` detaches the
    thread on abnormal driver exit (it drains away on the sentinel)."""

    def __init__(
        self,
        blocks: Iterable,
        depth: int = 8,
        cache_entries: int = 65536,
        batch_hash: bool = False,
        device=None,
    ):
        self._source = iter(blocks)
        self._cache_entries = cache_entries
        self._batch_hash = batch_hash
        self._device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._closed = threading.Event()
        self.busy_seconds = 0.0
        self._thread = threading.Thread(
            target=self._run, name="khipu-sender-prefetch", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            for block in self._source:
                if self._closed.is_set():
                    return
                t0 = time.perf_counter()
                recover_block_senders(
                    block.body.transactions,
                    self._cache_entries,
                    self._batch_hash,
                    self._device,
                )
                self.busy_seconds += time.perf_counter() - t0
                if not self._put(block):
                    return
            self._put(_DONE)
        # khipu-lint: ok KL002 not swallowed — the exception (including
        # InjectedDeath) crosses the queue as _PrefetchError and is
        # re-raised on the consumer thread at the exact iterator
        # position it occurred (__next__ raises item.exc), so
        # fail-stop semantics are preserved on the driver
        except BaseException as e:  # propagate through the queue
            self._put(_PrefetchError(e))

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, _PrefetchError):
            raise item.exc
        return item

    def close(self) -> None:
        """Stop the thread (abnormal exit: driver died mid-replay).
        Safe to call twice; the thread exits at its next queue/source
        step and is joined briefly (daemon — never blocks shutdown)."""
        self._closed.set()
        self._thread.join(timeout=2.0)
