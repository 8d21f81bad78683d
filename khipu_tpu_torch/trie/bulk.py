"""Level-synchronous bulk MPT build.

The whole trie is built *structurally* on the host (pure shape/RLP
work, no hashing), then resolved bottom-up. Two resolvers:

* ``_resolve_levels``: all nodes of tree height h are RLP-encoded in one
  pass and hashed in ONE batched ``hasher`` call, then height h+1, etc.
* ``_resolve_fused`` (``fused=True``): every node gets a 32-byte
  placeholder ref and the whole DAG resolves in one fixpoint on
  ``device`` (trie/fused.py: kernel K5 on the card).

Roots are bit-exact with the host MerklePatriciaTrie, including the
<32-byte inline ("capped") rule.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.nibbles import bytes_to_nibbles, hp_encode
from khipu_tpu_torch.base.rlp import rlp_encode
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability.trace import span as _span

Hasher = Callable[[Sequence[bytes]], List[bytes]]

# Structural node tags (children are _StructNode, not refs).
_LEAF, _EXT, _BRANCH = 0, 1, 2


class _StructNode:
    __slots__ = ("tag", "path", "value", "children", "height", "ref", "encoded")

    def __init__(self, tag, path=b"", value=b"", children=None):
        self.tag = tag
        self.path = path
        self.value = value
        self.children = children  # list of Optional[_StructNode] for branch
        self.height = 0
        self.ref = None  # rlp structure (inline) or 32-byte hash
        self.encoded = None


def host_hasher(messages: Sequence[bytes]) -> List[bytes]:
    """Scalar host oracle, one pure-Python hash per message (tests and
    tiny batches)."""
    return [keccak256(m) for m in messages]


def device_hasher(messages: Sequence[bytes], device=None) -> List[bytes]:
    """One batched call per level: K1r on the card (``device=None``), the
    plain sponge with ``device="cpu"``."""
    from khipu_tpu_torch.ops.keccak import keccak256_batch

    return keccak256_batch(messages, device)


def resolve_hasher(hasher: Optional[Hasher], device, fused: bool = False):
    """``(device, hasher)`` for an entry point: ``device=None`` means the
    card (raising where there is none), and the default hasher batches
    on that same device. The device is resolved only where it is used:
    by the default hasher and by the ``fused`` fixpoint. An explicit
    hasher of a level loop hashes where it hashes, and ``device`` is
    passed back as given."""
    if hasher is None or fused:
        device = resolve_device(device)
    if hasher is None:
        hasher = functools.partial(device_hasher, device=device)
    return device, hasher


def _build_struct(
    items: List[Tuple[bytes, bytes]], pos: int
) -> Optional[_StructNode]:
    """Build the structural trie for sorted (nibbles, value) items that
    all share a common prefix of length ``pos``."""
    if not items:
        return None
    if len(items) == 1:
        nib, val = items[0]
        return _StructNode(_LEAF, path=nib[pos:], value=val)

    first, last = items[0][0], items[-1][0]
    limit = min(len(first), len(last))
    cp = 0
    while pos + cp < limit and first[pos + cp] == last[pos + cp]:
        cp += 1
    if cp > 0:
        child = _build_struct(items, pos + cp)
        if child.tag == _BRANCH:
            return _StructNode(_EXT, path=first[pos : pos + cp], children=[child])
        # all items still share a longer prefix only when len(items)==1,
        # handled above — a multi-item group below a full common prefix
        # is always a branch.
        raise AssertionError("non-branch below common prefix")

    value = b""
    groups: List[Optional[List[Tuple[bytes, bytes]]]] = [None] * 16
    for nib, val in items:
        if len(nib) == pos:
            value = val  # key terminates exactly here
        else:
            g = groups[nib[pos]]
            if g is None:
                groups[nib[pos]] = g = []
            g.append((nib, val))
    children = [
        _build_struct(g, pos + 1) if g is not None else None for g in groups
    ]
    return _StructNode(_BRANCH, value=value, children=children)


def _measure_heights(root: _StructNode) -> List[List[_StructNode]]:
    """Iterative post-order height assignment → nodes grouped by height."""
    levels: List[List[_StructNode]] = []
    stack: List[Tuple[_StructNode, bool]] = [(root, False)]
    while stack:
        node, seen = stack.pop()
        kids = [c for c in (node.children or []) if c is not None]
        if not seen and kids:
            stack.append((node, True))
            for c in kids:
                stack.append((c, False))
            continue
        node.height = 1 + max((c.height for c in kids), default=-1) if kids else 0
        while len(levels) <= node.height:
            levels.append([])
        levels[node.height].append(node)
    return levels


def _encode(node: _StructNode):
    """RLP structure for a node whose children already carry refs."""
    if node.tag == _LEAF:
        return [hp_encode(node.path, True), node.value]
    if node.tag == _EXT:
        return [hp_encode(node.path, False), node.children[0].ref]
    refs = [c.ref if c is not None else b"" for c in node.children]
    return refs + [node.value]


def build_levels(pairs: Iterable[Tuple[bytes, bytes]]):
    """The structural trie of ``pairs`` (last write wins, empty values
    dropped): ``(root, nodes grouped by height)``, or None if empty."""
    dedup: Dict[bytes, bytes] = {}
    for k, v in pairs:
        dedup[bytes(k)] = bytes(v)
    items = sorted(
        (bytes_to_nibbles(k), v) for k, v in dedup.items() if v != b""
    )
    if not items:
        return None
    root = _build_struct(items, 0)
    return root, _measure_heights(root)


def bulk_build(
    pairs: Iterable[Tuple[bytes, bytes]],
    hasher: Optional[Hasher] = None,
    fused: bool = False,
    device=None,
    stats_out: Optional[Dict[str, float]] = None,
) -> Tuple[bytes, Dict[bytes, bytes]]:
    """Build a fresh MPT from (key, value) pairs.

    Returns ``(root_hash, {node_hash: node_rlp})`` — the node dict is
    what a NodeDataSource persist of the same trie would contain.
    Duplicate keys: last write wins. Empty input → empty trie hash.

    ``fused``: resolve the ENTIRE node DAG in one fixpoint on ``device``
    (trie/fused.py) instead of one ``hasher`` call per trie level.
    ``device=None`` means the card; ``device="cpu"`` runs the plain
    versions. ``hasher`` defaults to the batched sponge on ``device``.
    ``stats_out`` (a dict) receives ``pack_s`` (host pack and
    upload) and ``device_s`` (the fixpoint and the digest fetch).
    """
    from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH

    device, hasher = resolve_hasher(hasher, device, fused)
    with _span("bulk.structure"):
        built = build_levels(pairs)
    if built is None:
        return EMPTY_TRIE_HASH, {}
    root, levels = built

    if fused:
        nodes = _resolve_fused(levels, device, stats_out)
    else:
        nodes = _resolve_levels(levels, hasher)

    if isinstance(root.ref, bytes) and len(root.ref) == 32:
        root_hash = root.ref
    else:  # inline root is still stored by hash (mpt.persist parity)
        root_hash = keccak256(root.encoded)
        nodes[root_hash] = root.encoded
    return root_hash, nodes


def _resolve_levels(levels, hasher: Hasher) -> Dict[bytes, bytes]:
    """One batched hasher call per tree height (the portable path)."""
    nodes: Dict[bytes, bytes] = {}
    for level in levels:
        to_hash: List[_StructNode] = []
        msgs: List[bytes] = []
        for node in level:
            struct = _encode(node)
            encoded = rlp_encode(struct)
            node.encoded = encoded
            if len(encoded) < 32:
                node.ref = struct  # capped: inline into the parent
            else:
                to_hash.append(node)
                msgs.append(encoded)
        if msgs:
            for node, digest in zip(to_hash, hasher(msgs)):
                node.ref = digest
                nodes[digest] = node.encoded
    return nodes


def placeholder_dag(levels):
    """Encode bottom-up with 32-byte placeholder refs: the inline-or-hash
    decision only needs LENGTHS, and a placeholder is exactly hash-sized.
    Returns ``(to_resolve, ph_nodes)``: placeholder -> raw encoding, and
    the (placeholder, node) pairs to patch once resolved."""
    from khipu_tpu_torch.trie.deferred import _make_placeholder

    counter = 0
    to_resolve: Dict[bytes, bytes] = {}
    ph_nodes: List[Tuple[bytes, _StructNode]] = []
    for level in levels:  # leaves first: children encode before parents
        for node in level:
            struct = _encode(node)
            encoded = rlp_encode(struct)
            node.encoded = encoded
            if len(encoded) < 32:
                node.ref = struct
                continue
            ph = _make_placeholder(counter)
            counter += 1
            to_resolve[ph] = encoded
            node.ref = ph
            ph_nodes.append((ph, node))
    return to_resolve, ph_nodes


def _resolve_fused(levels, device, stats_out=None) -> Dict[bytes, bytes]:
    """Whole-DAG resolve in one fixpoint (trie/fused.py) over the
    placeholder DAG. Bit-exact with the level loop — the same
    substitution-length invariant the windowed commit relies on."""
    import time as _time

    from khipu_tpu_torch.trie.deferred import (
        _PLACEHOLDER_PREFIX,
        _substitute_bytes,
    )
    from khipu_tpu_torch.trie.fused import fused_submit

    with _span("bulk.encode"):
        to_resolve, ph_nodes = placeholder_dag(levels)
    # the fixpoint finds the DAG from the encodings' placeholder spans;
    # the structural depth bounds its levels
    t0 = _time.perf_counter()
    job = fused_submit(
        to_resolve, {}, _PLACEHOLDER_PREFIX, device=device,
        depth=len(levels),
    )
    t1 = _time.perf_counter()
    mapping = job.collect()
    if stats_out is not None:
        # pack + upload + kernel enqueue is HOST work; device_s is the
        # wait for the fixpoint and the digest fetch
        stats_out["pack_s"] = t1 - t0
        stats_out["device_s"] = _time.perf_counter() - t1

    nodes: Dict[bytes, bytes] = {}
    with _span("bulk.substitute"):
        for ph, node in ph_nodes:
            real = mapping[ph]
            node.encoded = _substitute_bytes(node.encoded, mapping)
            node.ref = real
            nodes[real] = node.encoded
    return nodes
