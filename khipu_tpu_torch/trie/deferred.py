"""Deferred-hash MPT commit: incremental updates with level-synchronous
batched hashing.

``bulk.py`` builds *fresh* tries batch-wise; block execution instead
produces a few hundred dirty keys against an EXISTING trie. The eager
MPT hashes each rebuilt node on the host as it goes (HOT LOOP 3,
SURVEY §3.2); here the same update machinery runs with hashing
*deferred*: ``_ref`` hands out 32-byte placeholder refs and records the
encoding, and ``finalize`` resolves the placeholder DAG — one batched
hasher call per dependency level, or (``fused=True``) the whole DAG in
one launch on the device (trie/fused.py: kernel K5 on the card).
It reuses MerklePatriciaTrie's insert/delete/capping logic verbatim so
bit-exactness is inherited, not re-proven.

Placeholders are 32 bytes (same length as a real hash), so every RLP
length — and therefore every <32-byte inline ("capped") decision — is
identical to the eager path. A node containing a placeholder child is
necessarily >= 33 bytes encoded, so placeholders can never hide inside
an inlined child.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.observability.trace import span as _span
from khipu_tpu_torch.trie.bulk import Hasher, resolve_hasher
from khipu_tpu_torch.trie.mpt import BLANK, EMPTY_TRIE_HASH, MerklePatriciaTrie

# UNFORGEABLE per-process prefix: leaf values are attacker-controlled
# (a contract can SSTORE any 32-byte word), so a fixed magic could be
# forged to make finalize() substitute a real node hash into stored
# data or crash the level loop. 14 random bytes make a collision
# 2^-112; detection additionally requires membership in the session's
# own staged-placeholder set (see _collect_placeholders).
_PLACEHOLDER_PREFIX = b"\xfe\xc0" + os.urandom(14) + b"\xc0\xfe"  # 18 bytes


def _make_placeholder(counter: int) -> bytes:
    return _PLACEHOLDER_PREFIX + counter.to_bytes(14, "big")


def _is_placeholder(ref) -> bool:
    return (
        isinstance(ref, bytes)
        and len(ref) == 32
        and ref.startswith(_PLACEHOLDER_PREFIX)
    )


class DeferredMPT(MerklePatriciaTrie):
    """MerklePatriciaTrie whose freshly created nodes get placeholder
    refs instead of eager keccak256 calls. Call :func:`finalize` (or
    :meth:`commit`) to resolve."""

    def __init__(self, source, root_hash=None, _root_ref=None,
                 _logs=None, _staged=None, counter=None, ref_sink=None):
        super().__init__(
            source, root_hash=root_hash, _root_ref=_root_ref,
            _logs=_logs, _staged=_staged,
        )
        # The base class defensively COPIES _logs/_staged; a deferred
        # session must share them BY REFERENCE — the window commits
        # several trie sessions into one placeholder namespace, and a
        # read-through source resolves staged nodes across blocks.
        if _logs is not None:
            self._logs = _logs
        if _staged is not None:
            self._staged = _staged
        # counter may be SHARED across sessions too; ref_sink tags which
        # session created each placeholder so persist can route nodes to
        # the right store
        self._counter = counter if counter is not None else [0]
        self._ref_sink = ref_sink
        # SESSION-local decode cache, never the source-attached one:
        # placeholder refs are NOT content-addressed (the per-process
        # prefix + a restarting counter reuses the same byte strings
        # across sessions with different content), so a cross-session
        # cache would serve stale structures. Within one session each
        # placeholder is staged write-once, so caching is sound.
        self._dcache = {}

    def _child(self) -> "DeferredMPT":
        t = DeferredMPT(self.source)
        t._root_ref = self._root_ref
        t._logs = self._logs
        t._staged = self._staged
        t._counter = self._counter
        t._ref_sink = self._ref_sink
        t._dcache = self._dcache
        return t

    def _ref(self, node):
        if node == BLANK:
            return BLANK
        encoded = rlp_encode(node)
        if len(encoded) < 32:
            return node
        ph = _make_placeholder(self._counter[0])
        self._counter[0] += 1
        self._staged[ph] = encoded
        self._log_update(ph, encoded)
        if self._ref_sink is not None:
            self._ref_sink.add(ph)
        return ph

    def force_hashed_root(self) -> bytes:
        """32-byte root ref: placeholders/real hashes pass through; an
        inline (<32 B) root gets its own placeholder (the eager path
        hashes inline roots too — mpt.persist parity). BLANK roots are
        the empty-trie hash."""
        ref = self._root_ref
        if ref == BLANK:
            return EMPTY_TRIE_HASH
        if isinstance(ref, bytes):
            return ref
        encoded = rlp_encode(ref)
        ph = _make_placeholder(self._counter[0])
        self._counter[0] += 1
        self._staged[ph] = encoded
        self._log_update(ph, encoded)
        if self._ref_sink is not None:
            self._ref_sink.add(ph)
        return ph

    def commit(
        self, hasher: Optional[Hasher] = None, device=None
    ) -> MerklePatriciaTrie:
        """Resolve all placeholders; returns an ordinary trie whose
        logs/staged/root carry real hashes."""
        return finalize(self, hasher, device=device)


def _substitute_bytes(value: bytes, mapping: Dict[bytes, bytes]) -> bytes:
    """Replace EMBEDDED placeholders inside an opaque byte string (leaf
    values may contain them: an account's RLP embeds its storage root,
    which is a placeholder while the window is open)."""
    pos = value.find(_PLACEHOLDER_PREFIX)
    if pos < 0:
        return value
    out = bytearray(value)
    while pos >= 0:
        ph = bytes(out[pos : pos + 32])
        real = mapping.get(ph)
        if real is not None:
            out[pos : pos + 32] = real
        pos = bytes(out).find(_PLACEHOLDER_PREFIX, pos + 1)
    return bytes(out)


def _substitute_many(encs: List[bytes], lookup) -> List[bytes]:
    """Batched :func:`_substitute_bytes` over many encodings: ONE numpy
    scan of the joined buffer finds every placeholder-prefix occurrence
    (18 vectorized byte-compare refinements) instead of a Python
    ``find`` loop per node — the dominant host cost of the window
    persist. ``lookup(ph) -> real | None`` decides substitution; an
    occurrence whose 32 bytes are not a known placeholder (opaque data
    that collided with the prefix, or a foreign counter range) is left
    untouched, exactly like the scalar path."""
    total = sum(map(len, encs))
    if total < 32:
        return [bytes(e) for e in encs]
    joined = b"".join(encs)
    buf = np.frombuffer(joined, dtype=np.uint8).copy()
    pref = np.frombuffer(_PLACEHOLDER_PREFIX, dtype=np.uint8)
    cand = np.flatnonzero(buf[: total - 31] == pref[0])
    for k in range(1, len(pref)):
        if not cand.size:
            break
        cand = cand[buf[cand + k] == pref[k]]
    hits: List[int] = []
    digs: List[bytes] = []
    if cand.size:
        # boundary guard: in the JOINED buffer a prefix match could
        # straddle two adjacent encodings — a real placeholder never
        # does (it was written as one 32-byte ref inside one node)
        ends = np.cumsum(
            np.fromiter(map(len, encs), np.int64, len(encs))
        )
        node_end = ends[np.searchsorted(ends, cand, side="right")]
        for p, e in zip(cand.tolist(), node_end.tolist()):
            if p + 32 > e:
                continue
            real = lookup(joined[p : p + 32])
            if real is not None:
                hits.append(p)
                digs.append(real)
    if hits:
        pos = np.asarray(hits, np.int64)
        rep = np.frombuffer(b"".join(digs), np.uint8)
        buf[(pos[:, None] + np.arange(32)).reshape(-1)] = rep
    blob = buf.tobytes()
    out: List[bytes] = []
    off = 0
    for e in encs:
        out.append(blob[off : off + len(e)])
        off += len(e)
    return out


def _substitute(structure, mapping: Dict[bytes, bytes]):
    """Replace placeholder refs (and embedded ones) inside a decoded
    node structure."""
    if isinstance(structure, bytes):
        direct = mapping.get(structure)
        if direct is not None:
            return direct
        return _substitute_bytes(structure, mapping)
    return [_substitute(item, mapping) for item in structure]


def _collect_placeholders(structure, out: List[bytes], known) -> None:
    """Collect placeholder refs, direct or embedded. ``known`` is the
    session's own placeholder set — a prefix match that is NOT a key the
    session handed out is opaque user data, never a dependency."""
    if isinstance(structure, bytes):
        if _is_placeholder(structure):
            if structure in known:
                out.append(structure)
        else:
            pos = structure.find(_PLACEHOLDER_PREFIX)
            while pos >= 0:
                ph = structure[pos : pos + 32]
                if ph in known:
                    out.append(ph)
                pos = structure.find(_PLACEHOLDER_PREFIX, pos + 32)
        return
    for item in structure:
        _collect_placeholders(item, out, known)


def resolution_inputs(trie: DeferredMPT, subset=None):
    """(to_resolve, deps, structures) for a deferred session — the
    placeholder set a resolver must hash and its dependency map, by
    decoding every staged encoding. ``subset`` restricts to given
    placeholders (finalize's live-only mode) while membership (`known`)
    always spans every placeholder the session handed out."""
    staged = {
        ph: enc for ph, enc in trie._staged.items() if _is_placeholder(ph)
    }
    if subset is None:
        to_resolve = staged
    else:
        to_resolve = {ph: staged[ph] for ph in subset}
    known = frozenset(staged)
    structures = {ph: rlp_decode(enc) for ph, enc in to_resolve.items()}
    deps: Dict[bytes, List[bytes]] = {}
    for ph, struct in structures.items():
        children: List[bytes] = []
        _collect_placeholders(struct, children, known)
        deps[ph] = children
    return to_resolve, deps, structures


def finalize(
    trie: DeferredMPT,
    hasher: Optional[Hasher] = None,
    return_mapping: bool = False,
    fused: bool = False,
    device=None,
):
    """Hash the live placeholder DAG bottom-up, one batch per level.

    Dead placeholders (created then superseded within the same session;
    net refcount 0) were already dropped by the MPT's refcount log.
    With ``return_mapping``, returns (trie, {placeholder: real_hash})
    — the window committer resolves per-block root refs through it.

    ``device=None`` means the card, ``"cpu"`` the plain versions, and
    ``hasher`` defaults to the batched sponge on ``device``. With
    ``fused``, the whole DAG resolves in one fixpoint on ``device``
    (trie/fused.py: kernel K5 on the card, one launch for every level)
    instead of one hasher call per level; ``hasher`` is then unused.
    """
    device, hasher = resolve_hasher(hasher, device, fused)
    # live placeholders: positive log entries with placeholder keys
    live: Dict[bytes, bytes] = {}  # placeholder -> encoded (raw)
    removed: Dict[bytes, List] = {}
    for h, rec in trie._logs.items():
        if _is_placeholder(h):
            if rec[0] > 0:
                live[h] = rec[1]
            # negative placeholder records are impossible: a placeholder
            # starts at +1 and a net removal deletes the entry
        else:
            removed[h] = rec

    with _span("finalize.inputs"):
        if return_mapping:
            # Resolve EVERY placeholder the session created (the staged
            # store retains them): a window's intermediate block roots
            # are superseded by later blocks (net refcount 0 — dead for
            # PERSISTING) yet their resolved hashes are what the
            # per-block root checks compare against. Only live ones
            # persist below.
            to_resolve, deps, structures = resolution_inputs(trie)
        else:
            # plain batch commit: nobody reads dead placeholders — hash
            # only the live set (work scales with live nodes, not churn)
            to_resolve, deps, structures = resolution_inputs(
                trie, subset=live
            )

    resolved: Dict[bytes, bytes] = {}  # placeholder -> real hash
    final_encoded: Dict[bytes, bytes] = {}  # real hash -> final rlp
    if fused and to_resolve:
        from khipu_tpu_torch.trie.fused import fused_resolve

        resolved = fused_resolve(
            to_resolve, deps, _PLACEHOLDER_PREFIX, device=device
        )
        # substitution is length-invariant, so the byte-level
        # substitute over the RAW encoding equals the loop path's
        # decode -> substitute -> re-encode
        with _span("finalize.substitute"):
            for ph, enc in to_resolve.items():
                final_encoded[resolved[ph]] = _substitute_bytes(
                    enc, resolved
                )
    elif deps:
        from khipu_tpu_torch.trie.fused import topo_levels

        for level in topo_levels(deps):
            encodings = []
            for ph in level:
                final = rlp_encode(_substitute(structures[ph], resolved))
                encodings.append(final)
            digests = hasher(encodings)
            for ph, enc, digest in zip(level, encodings, digests):
                resolved[ph] = digest
                final_encoded[digest] = enc

    # rebuild logs: resolved placeholders become Updated(real) records;
    # removal records for pre-existing hashes pass through. Two
    # placeholders can resolve to the SAME hash (identical subtrees) —
    # refcounts add.
    new_logs: Dict[bytes, List] = {h: [rec[0], rec[1]] for h, rec in removed.items()}
    for ph, enc in live.items():
        digest = resolved[ph]
        count = trie._logs[ph][0]
        rec = new_logs.get(digest)
        if rec is None:
            new_logs[digest] = [count, final_encoded[digest]]
        else:
            rec[0] += count
            rec[1] = final_encoded[digest]
            if rec[0] == 0:
                del new_logs[digest]

    new_staged = {
        resolved[ph]: final_encoded[resolved[ph]] for ph in live
    }
    root_ref = trie._root_ref
    if _is_placeholder(root_ref):
        root_ref = resolved[root_ref]
    elif isinstance(root_ref, list):
        root_ref = rlp_decode(
            rlp_encode(_substitute(root_ref, resolved))
        )
    out = MerklePatriciaTrie(
        trie.source, _root_ref=root_ref, _logs=new_logs, _staged=new_staged
    )
    if return_mapping:
        return out, resolved
    return out


def batch_commit(
    trie: MerklePatriciaTrie,
    upserts: Sequence[Tuple[bytes, bytes]],
    removes: Sequence[bytes] = (),
    hasher: Optional[Hasher] = None,
    device=None,
) -> MerklePatriciaTrie:
    """Apply a batch of updates to an existing trie with all node
    hashing deferred into level batches. Drop-in replacement for a
    put/remove fold — roots are bit-exact (tests fuzz the equality)."""
    # deep-copy log records: the MPT mutates them in place, and the
    # caller's trie must stay untouched
    d = DeferredMPT(
        trie.source,
        _root_ref=trie._root_ref,
        _logs={h: [c, e] for h, (c, e) in trie._logs.items()},
        _staged=dict(trie._staged),
    )
    for key in removes:
        d = d.remove(key)
    for key, value in upserts:
        d = d.put(key, value)
    return d.commit(hasher, device)
