"""Offline compaction: copy the nodes reachable from a pivot state root
into a fresh store generation — mark-and-sweep GC over the append-only
log (storage/KesqueCompactor.scala:32: NodeReader.processNode :72-92
walks the trie, NodeWriter :125 copies to the new file generation).

Works over any (source-store, target-store) pair with get/update. The
port's counterpart of ``khipu_tpu.storage.compactor``: the memory and
persistent engines copy into a new store, the Kesque engine
(``storage/kesque.py``) into staged segments it swaps in, and fills the
report's segment fields. ``verify_reachable`` is the completeness check
after a fast sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from khipu_tpu_torch.sync.fast_sync import (
    EVMCODE,
    STATE_NODE,
    STORAGE_NODE,
    _children_of,
)


@dataclass
class CompactionReport:
    state_nodes: int = 0
    storage_nodes: int = 0
    code_blobs: int = 0
    missing: int = 0
    corrupt: int = 0  # stored bytes whose keccak != key (verify_hashes)
    # segment-engine extensions (storage/kesque.py fills these in:
    # bytes the swap freed, and the post-compaction per-segment
    # live/garbage split feeding the khipu_kesque_* registry families)
    reclaimed_bytes: int = 0
    segment_stats: dict = field(default_factory=dict)

    @property
    def total(self) -> int:
        return self.state_nodes + self.storage_nodes + self.code_blobs


def compact(
    account_src,
    storage_src,
    evmcode_src,
    state_root: bytes,
    account_dst,
    storage_dst,
    evmcode_dst,
    batch: int = 1000,
    verify_hashes: bool = False,
) -> CompactionReport:
    """Walk the trie at ``state_root``; copy every reachable node/blob
    from the src stores into the dst stores. Returns counts
    (KesqueCompactor's NodeReader/NodeWriter roles).

    ``verify_hashes`` re-checks every value against its content address
    (all three stores are content-addressed), so a torn or bit-flipped
    record counts as ``corrupt`` instead of silently propagating."""
    if verify_hashes:
        from khipu_tpu_torch.base.keccak import keccak256

    report = CompactionReport()
    pending: List[Tuple[int, bytes]] = [(STATE_NODE, state_root)]
    seen = {state_root}
    buffers: Dict[int, Dict[bytes, bytes]] = {
        STATE_NODE: {}, STORAGE_NODE: {}, EVMCODE: {},
    }
    srcs = {STATE_NODE: account_src, STORAGE_NODE: storage_src, EVMCODE: evmcode_src}
    dsts = {STATE_NODE: account_dst, STORAGE_NODE: storage_dst, EVMCODE: evmcode_dst}

    def flush(kind: int) -> None:
        if buffers[kind]:
            dsts[kind].update([], buffers[kind])
            buffers[kind].clear()

    while pending:
        kind, h = pending.pop()
        value = srcs[kind].get(h)
        if value is None:
            report.missing += 1
            continue
        if verify_hashes and keccak256(value) != h:
            report.corrupt += 1
            continue  # children unreadable from corrupt bytes
        buffers[kind][h] = value
        if kind == STATE_NODE:
            report.state_nodes += 1
        elif kind == STORAGE_NODE:
            report.storage_nodes += 1
        else:
            report.code_blobs += 1
        if len(buffers[kind]) >= batch:
            flush(kind)
        for child in _children_of(kind, value):
            if child[1] not in seen:
                seen.add(child[1])
                pending.append(child)
    for kind in buffers:
        flush(kind)
    return report


def verify_reachable(
    account_src, storage_src, evmcode_src, state_root: bytes,
    verify_hashes: bool = False,
) -> CompactionReport:
    """DataChecker role (tools/DataChecker.scala:122): walk the whole
    state trie at a block and assert every node is retrievable; the
    report's ``missing`` (and, with ``verify_hashes``, ``corrupt``)
    counts are the integrity verdict."""

    class _Null:
        def update(self, r, u):
            pass

    null = _Null()
    return compact(
        account_src, storage_src, evmcode_src, state_root,
        null, null, null, verify_hashes=verify_hashes,
    )
