"""Merkle Patricia Trie — functional host implementation with write logs.

Parity target: khipu-base/src/main/scala/khipu/trie/MerklePatriciaTrie.scala
(put:157, remove:290, fix:431, getNode:520, persist:544, changes:549) and
Node.scala (capped <32-byte inline rule, Node.scala:114). The port's copy
of ``khipu_tpu.trie.mpt``: state roots produced here must be
byte-for-byte what geth would compute. The eager path hashes one node at
a time with the scalar oracle; batched commits go through
``DeferredMPT`` (deferred.py) and the device paths.

Representation
--------------
A *node* is its decoded-RLP structure:
  * blank        — ``b""``
  * leaf / ext   — ``[hp(nibbles, is_leaf), value_or_ref]``
  * branch       — 17-item list ``[ref0..ref15, value]``
A *ref* (what a parent stores for a child) is ``b""`` (blank), a 32-byte
Keccak-256 of the child's RLP, or — when the child's RLP is shorter than
32 bytes — the child structure inlined ("capped" rule).

Mutation returns a new trie sharing the backing source; freshly hashed
nodes accumulate in an internal log (hash → Updated(bytes) | Removed)
until :meth:`persist` flushes Updated entries to the source. Removed
entries are reported via :meth:`changes` but never deleted from the
source (NodeStorage.scala:16-19 — content-addressed stores don't
delete), matching the reference's archive semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.nibbles import bytes_to_nibbles, hp_decode, hp_encode
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode

Node = Union[bytes, List]  # b"" blank | [hp, v] | [c0..c15, v]
Ref = Union[bytes, List]  # b"" | 32-byte hash | inline node

BLANK: bytes = b""
# keccak256(rlp_encode(b""))
EMPTY_TRIE_HASH: bytes = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)

# Change-log records are [net_refcount, encoded|None]: count > 0 is the
# reference's Updated, < 0 Removed (khipu-base package.scala:12-19
# Log/Updated/Removed ADT, refcounted for hash-aliased nodes).


class MPTException(Exception):
    pass


class MPTNodeMissingException(MPTException):
    """A referenced node is absent from the source — drives fast-sync
    node fetch (MerklePatriciaTrie.scala:47)."""

    def __init__(self, hash_: bytes):
        super().__init__(f"missing MPT node {hash_.hex()}")
        self.hash = hash_


def _is_branch(node: List) -> bool:
    return len(node) == 17


def _common_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class MerklePatriciaTrie:
    """Immutable-style MPT over a ``get(hash) -> bytes|None`` source.

    ``source`` needs only a ``get`` method; persist additionally uses
    ``update(to_remove, to_upsert)`` when present, else ``put``.
    """

    __slots__ = ("source", "_root_ref", "_logs", "_staged", "_dcache")

    def __init__(
        self,
        source,
        root_hash: Optional[bytes] = None,
        _root_ref: Optional[Ref] = None,
        _logs: Optional[Dict[bytes, List]] = None,
        _staged: Optional[Dict[bytes, bytes]] = None,
    ):
        self.source = source
        # Decoded-node cache, attached to the SOURCE so it survives
        # across trie instances/blocks: nodes are content-addressed
        # (hash -> immutable bytes) and resolved structures are never
        # mutated in place (_insert/_delete copy before writing), so a
        # shared decode cache is sound. Falls back to per-trie when the
        # source can't carry attributes.
        try:
            self._dcache = source._mpt_dcache
        except AttributeError:
            try:
                source._mpt_dcache = {}
                self._dcache = source._mpt_dcache
            except AttributeError:
                self._dcache = {}
        if _root_ref is not None:
            self._root_ref = _root_ref
        elif root_hash is None or root_hash == EMPTY_TRIE_HASH:
            self._root_ref = BLANK
        else:
            self._root_ref = bytes(root_hash)
        # hash -> [net_refcount, encoded|None]; insertion-ordered
        self._logs: Dict[bytes, List] = dict(_logs or {})
        # freshly created hash -> encoded, readable before persist
        self._staged: Dict[bytes, bytes] = dict(_staged or {})

    # ------------------------------------------------------------- root

    @property
    def root_hash(self) -> bytes:
        """Root hash; short roots are hashed too (only the root is
        hashed even when <32 bytes, per the yellow paper)."""
        if self._root_ref == BLANK:
            return EMPTY_TRIE_HASH
        if isinstance(self._root_ref, bytes):
            return self._root_ref
        return keccak256(rlp_encode(self._root_ref))

    # ------------------------------------------------------------ reads

    def get(self, key: bytes) -> Optional[bytes]:
        node = self._resolve(self._root_ref)
        if node == BLANK:
            return None
        return self._get(node, bytes_to_nibbles(key))

    def _get(self, node: Node, nibbles: bytes) -> Optional[bytes]:
        while True:
            if node == BLANK:
                return None
            if _is_branch(node):
                if not nibbles:
                    return node[16] or None
                node = self._resolve(node[nibbles[0]])
                nibbles = nibbles[1:]
                continue
            path, is_leaf = hp_decode(node[0])
            if is_leaf:
                return node[1] if path == nibbles else None
            if nibbles[: len(path)] != path:
                return None
            node = self._resolve(node[1])
            nibbles = nibbles[len(path) :]

    def _resolve(self, ref: Ref) -> Node:
        if isinstance(ref, list):
            return ref
        if ref == BLANK:
            return BLANK
        cache = self._dcache
        node = cache.get(ref)
        if node is not None:
            return node
        encoded = self._staged.get(ref)
        if encoded is None:
            log = self._logs.get(ref)
            if log is not None and log[0] > 0:
                encoded = log[1]
        if encoded is not None:
            # session-local (staged/log) nodes are NOT cached: they may
            # never be durably written, and a shared cache would keep
            # serving them after the session is dropped
            return rlp_decode(encoded)
        encoded = self.source.get(ref)
        if encoded is None:
            raise MPTNodeMissingException(ref)
        node = rlp_decode(encoded)
        if len(cache) >= 262144:  # bound memory; hot top levels re-warm
            cache.clear()
        cache[ref] = node
        return node

    # ---------------------------------------------------------- updates

    def put(self, key: bytes, value: bytes) -> "MerklePatriciaTrie":
        if value == b"":
            return self.remove(key)
        t = self._child()
        root = t._resolve(t._root_ref)
        t._log_remove(t._root_ref)  # the old root node is superseded
        new_root = t._insert(root, bytes_to_nibbles(key), value)
        t._root_ref = t._ref(new_root)
        return t

    def remove(self, key: bytes) -> "MerklePatriciaTrie":
        t = self._child()
        root = t._resolve(t._root_ref)
        if root == BLANK:
            return t
        old_ref = t._root_ref
        new_root = t._delete(root, bytes_to_nibbles(key))
        if new_root == root:
            return t  # key absent: pure no-op, log nothing
        t._root_ref = t._ref(new_root) if new_root != BLANK else BLANK
        t._log_remove(old_ref)
        return t

    def _child(self) -> "MerklePatriciaTrie":
        # Logs/staged are SHARED with the parent (not copied): a session
        # accumulates one write-log across all mutations until persist(),
        # so changes() reflects every mutation since the last persist no
        # matter which returned trie it is called on. Old forks remain
        # readable (_staged is append-only within a session). Copying
        # here would cost O(n²) across n mutations.
        t = MerklePatriciaTrie(self.source)
        t._root_ref = self._root_ref
        t._logs = self._logs
        t._staged = self._staged
        return t

    # Build a ref for a node, staging its encoding when it hashes
    # (capped rule, Node.scala:114: inline iff len(rlp) < 32).
    def _ref(self, node: Node) -> Ref:
        if node == BLANK:
            return BLANK
        encoded = rlp_encode(node)
        if len(encoded) < 32:
            return node
        h = keccak256(encoded)
        self._staged[h] = encoded
        self._log_update(h, encoded)
        return h

    # The log is REFCOUNTED per hash: identical subtrees under different
    # parents alias one hash (content addressing), so a plain tag would
    # drop the UPDATED record when only one of several referents goes
    # away — silent data loss at persist. Net count > 0 ⇒ Updated,
    # < 0 ⇒ Removed, == 0 ⇒ no net change (updateNodesToLogs dedup,
    # MerklePatriciaTrie.scala:491-516; refcount idea: KesqueIndex's
    # 16-bit refcount, KesqueIndex.scala:17-26).

    def _log_update(self, h: bytes, encoded: bytes) -> None:
        rec = self._logs.get(h)
        if rec is None:
            self._logs[h] = [1, encoded]
        else:
            rec[0] += 1
            rec[1] = encoded
            if rec[0] == 0:
                del self._logs[h]

    def _log_remove(self, ref: Ref) -> None:
        if not isinstance(ref, bytes) or ref == BLANK:
            return  # inline nodes were never stored
        rec = self._logs.get(ref)
        if rec is None:
            self._logs[ref] = [-1, None]
        else:
            rec[0] -= 1
            if rec[0] == 0:
                del self._logs[ref]

    # _insert/_delete take *resolved* nodes, return resolved nodes.
    def _insert(self, node: Node, nibbles: bytes, value: bytes) -> Node:
        if node == BLANK:
            return [hp_encode(nibbles, True), value]

        if _is_branch(node):
            new = list(node)
            if not nibbles:
                new[16] = value
                return new
            child_ref = node[nibbles[0]]
            child = self._resolve(child_ref)
            self._log_remove(child_ref)
            new[nibbles[0]] = self._ref(self._insert(child, nibbles[1:], value))
            return new

        path, is_leaf = hp_decode(node[0])
        common = _common_prefix_len(path, nibbles)

        if is_leaf:
            if path == nibbles:
                return [node[0], value]  # overwrite
            return self._split(path, node[1], True, nibbles, value, common)

        # extension
        if common == len(path):
            child_ref = node[1]
            child = self._resolve(child_ref)
            self._log_remove(child_ref)
            new_child = self._insert(child, nibbles[common:], value)
            return [node[0], self._ref(new_child)]
        return self._split(path, node[1], False, nibbles, value, common)

    def _split(
        self,
        path: bytes,
        payload,
        is_leaf: bool,
        nibbles: bytes,
        value: bytes,
        common: int,
    ) -> Node:
        """Diverge an existing leaf/ext from a new leaf at offset ``common``."""
        branch: List = [BLANK] * 16 + [b""]

        # existing node's remainder under the branch
        rest = path[common:]
        if is_leaf:
            if not rest:
                branch[16] = payload
            else:
                leaf = [hp_encode(rest[1:], True), payload]
                branch[rest[0]] = self._ref(leaf)
        else:
            if not rest:
                raise MPTException("extension collapsing to branch slot")
            if len(rest) == 1:
                branch[rest[0]] = payload  # child ref moves up directly
            else:
                ext = [hp_encode(rest[1:], False), payload]
                branch[rest[0]] = self._ref(ext)

        # new value's remainder
        nrest = nibbles[common:]
        if not nrest:
            branch[16] = value
        else:
            leaf = [hp_encode(nrest[1:], True), value]
            branch[nrest[0]] = self._ref(leaf)

        if common:
            return [hp_encode(path[:common], False), self._ref(branch)]
        return branch

    def _delete(self, node: Node, nibbles: bytes) -> Node:
        if node == BLANK:
            return BLANK

        if _is_branch(node):
            if not nibbles:
                if node[16] == b"":
                    return node  # nothing to delete
                new = list(node)
                new[16] = b""
                return self._fix_branch(new)
            child_ref = node[nibbles[0]]
            child = self._resolve(child_ref)
            if child == BLANK:
                return node
            new_child = self._delete(child, nibbles[1:])
            if new_child == child:
                return node  # key absent below: pure no-op, log nothing
            new = list(node)
            if new_child == BLANK:
                self._log_remove(child_ref)
                new[nibbles[0]] = BLANK
                return self._fix_branch(new)
            self._log_remove(child_ref)
            new[nibbles[0]] = self._ref(new_child)
            return new

        path, is_leaf = hp_decode(node[0])
        if is_leaf:
            return BLANK if path == nibbles else node

        if nibbles[: len(path)] != path:
            return node
        child_ref = node[1]
        child = self._resolve(child_ref)
        new_child = self._delete(child, nibbles[len(path) :])
        if new_child == child:
            return node  # no-op below: log nothing
        self._log_remove(child_ref)
        if new_child == BLANK:
            return BLANK
        # merge with child if it became leaf/ext (fix, :431); the child
        # is NOT _ref'd here — _merge_ext either refs it (branch) or
        # absorbs it into this node (leaf/ext), so staging it would
        # orphan a node no parent references.
        return self._merge_ext(path, new_child)

    def _merge_ext(self, path: bytes, child: Node) -> Node:
        """Normalize an extension whose child may no longer be a branch."""
        if _is_branch(child):
            return [hp_encode(path, False), self._ref(child)]
        cpath, cleaf = hp_decode(child[0])
        return [hp_encode(path + cpath, cleaf), child[1]]

    def _fix_branch(self, branch: List) -> Node:
        """Collapse a branch left with <2 occupied slots (fix, :431-489)."""
        used = [i for i in range(16) if branch[i] != BLANK]
        has_value = branch[16] != b""
        if len(used) + (1 if has_value else 0) >= 2:
            return branch
        if not used:
            if not has_value:
                return BLANK
            return [hp_encode(b"", True), branch[16]]
        # single child: splice it up, prefixing its nibble
        idx = used[0]
        child_ref = branch[idx]
        child = self._resolve(child_ref)
        self._log_remove(child_ref)
        if _is_branch(child):
            return [hp_encode(bytes([idx]), False), self._ref(child)]
        cpath, cleaf = hp_decode(child[0])
        return [hp_encode(bytes([idx]) + cpath, cleaf), child[1]]

    # ---------------------------------------------------------- persist

    def changes(self) -> Tuple[List[bytes], Dict[bytes, bytes]]:
        """(removed_hashes, {hash: encoded}) accumulated since the last
        persisted trie (MerklePatriciaTrie.changes:549)."""
        removed = [h for h, (count, _) in self._logs.items() if count < 0]
        upserts = {
            h: enc for h, (count, enc) in self._logs.items() if count > 0
        }
        return removed, upserts

    def persist(self) -> "MerklePatriciaTrie":
        """Flush Updated nodes to the source; returns a clean trie at the
        same root. Removed hashes are dropped (never deleted from a
        content-addressed source)."""
        _, upserts = self.changes()
        if isinstance(self._root_ref, list):
            # Inline (<32 B) roots are still stored by hash so the trie
            # can be reopened from root_hash alone.
            encoded = rlp_encode(self._root_ref)
            upserts[keccak256(encoded)] = encoded
        if hasattr(self.source, "update"):
            self.source.update([], upserts)
        else:
            for h, enc in upserts.items():
                self.source.put(h, enc)
        return MerklePatriciaTrie(self.source, _root_ref=self._root_ref)
