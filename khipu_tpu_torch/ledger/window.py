"""Block-window commit: N blocks of dirty trie nodes, one device pass.

The port's counterpart of ``khipu_tpu.ledger.window``. Per-block state
diffs accumulate into ONE deferred placeholder session; later blocks
execute against the *unresolved* state (placeholder refs resolve through
the session's staged store). A sealed window's whole node DAG resolves
in one fused fixpoint — one launch of kernel K5 on the card
(trie/fused.py) — then each block's resolved root is checked against
its header and the window persists.

The session continues across windows: ``seal`` closes a window on the
driver thread and the staged pipeline (sync/replay.py) runs the rest on
its stage threads — ``pack_and_dispatch`` (seal stage), ``collect_roots``
and ``admit_mirror`` (collect stage), ``persist`` (persist stage). Refs
into a window still in flight ride the next window's K5 launch as a
resolved-input tile gathered card to card (``fused.ExtRows``).

Every device operation of the pipeline is enqueued on the device's
current stream, which every thread shares (PyTorch's default stream):
the seal stage's gathers and launch, the collect stage's root fetch and
mirror admits, the persist stage's spill read-back and the driver's
mirror reads run in the order they were enqueued, as the reference
relies on XLA's program order on one device. K5 is a cooperative launch
and only the seal stage launches it.

Pre-Byzantium receipts embed per-tx intermediate roots (host-computed
during execution), so windows > 1 require Byzantium+ receipt semantics
(ReplayDriver enforces this).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import torch

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.chaos import fault_point
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.account import address_key
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.ledger.world import BlockWorldState
from khipu_tpu_torch.observability.profiler import H2D, HOST, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import span
from khipu_tpu_torch.ops.keccak_torch import RATE
from khipu_tpu_torch.trie.bulk import Hasher, host_hasher
from khipu_tpu_torch.trie.deferred import (
    DeferredMPT,
    _is_placeholder,
    _make_placeholder,
    _substitute_bytes,
    _substitute_many,
    _PLACEHOLDER_PREFIX,
)
from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH

# Module-level (not on the committer): committers are rebuilt every
# epoch and the counts must survive them.
WINDOW_GAUGES = REGISTRY.gauge_group("khipu_window", {
    # windows resolved by one fused fixpoint on the device, and windows
    # hashed by the host level loop (adaptive host mode or no device
    # commit)
    "device_windows": 0,
    "host_windows": 0,
}, help="window-commit state (ledger/window.py)")


class _StagedReadThrough:
    """Node source that serves the window's staged (unresolved) nodes
    first, then the underlying storage — how a block reads state
    committed by earlier blocks of the same open window.

    ``resolved`` maps pruned placeholders to their real hashes: once a
    window is persisted its staged encodings are dropped, but retained
    trie structure still holds placeholder refs into it — those reads
    indirect through the mapping to the store."""

    __slots__ = ("inner", "staged", "resolved")

    def __init__(self, inner, staged: Dict[bytes, bytes], resolved=None):
        self.inner = inner
        self.staged = staged
        self.resolved = resolved if resolved is not None else {}

    def get(self, key: bytes) -> Optional[bytes]:
        v = self.staged.get(key)
        if v is not None:
            return v
        real = self.resolved.get(key)
        if real is not None:
            return self.inner.get(real)
        return self.inner.get(key)


class WindowMismatch(Exception):
    def __init__(self, number: int, got: bytes, want: bytes):
        super().__init__(
            f"block {number}: window root {got.hex()} != header "
            f"{want.hex()}"
        )
        self.number = number


class WindowPlaceholderError(Exception):
    """A live placeholder could not be resolved at persist — it was
    skipped at seal (a foreign session sharing the counter range) or its
    digest never materialized. Carries the placeholder index."""

    def __init__(self, ph: bytes, reason: str):
        idx = int.from_bytes(ph[len(_PLACEHOLDER_PREFIX):], "big")
        super().__init__(
            f"window collect: live placeholder #{idx} {reason} "
            "(skipped at seal? a foreign session sharing the counter "
            "range cannot be collected here)"
        )
        self.index = idx


class WindowCommitter:
    """One windowed commit session. ``fused`` resolves each window in one
    ``fused_submit`` on ``device`` (``None`` means the card: K5 there;
    ``"cpu"`` its plain version); otherwise, and in the adaptive
    controller's host mode, the host level loop hashes with ``hasher``
    (``host_hasher`` in host mode). ``mirror``: the device mirror the
    collect stage admits live nodes into (persist then spills them to
    the host stores). ``on_block_committed``: the serving read view's
    publish hook (``ReadView.publish_block``), called at the end of
    each ``commit_block``."""

    def __init__(self, storages, parent_root: bytes,
                 hasher: Hasher = host_hasher,
                 account_start_nonce: int = 0,
                 get_block_hash=None,
                 fused: bool = False,
                 mirror=None,
                 adaptive=None,
                 device=None,
                 on_block_committed=None):
        self.storages = storages
        self.hasher = hasher
        self.fused = fused
        # the fused fixpoint's device: None means the card
        self.device = resolve_device(device) if fused else device
        # cost-model-adaptive controller (sync/adaptive.py): consulted
        # per window at pack time — in host mode the window skips the
        # fused dispatch and hashes on the host (the mirror stays
        # attached; rows admitted by earlier device windows stay valid)
        self.adaptive = adaptive
        # device-resident commit target: admit_mirror() lands each
        # window's live nodes on the device straight from the fused
        # outputs and persist() becomes an async spill — reads of
        # not-yet-spilled nodes are served by the mirror through
        # NodeStorage's read-through
        self.mirror = mirror
        self.account_start_nonce = account_start_nonce
        self.get_block_hash = get_block_hash or (lambda n: None)
        # serving hook (serving/readview.py): called per commit_block
        # with (header, {addr: Account | None}, txs) — the account diff
        # folded into the session, BEFORE any of it is durable. A host
        # dict: no device read, no sync. It runs on the driver thread
        # inside the window critical path, so it must be cheap and
        # must not raise
        self.on_block_committed = on_block_committed

        # ONE placeholder namespace for every trie in the window
        self._logs: Dict[bytes, list] = {}
        self._staged: Dict[bytes, bytes] = {}
        self._counter = [0]
        # only storage placeholders need tagging: persist routes nodes
        # account-side by default and storage-side on membership here
        self._storage_phs: Set[bytes] = set()
        # placeholders of already-resolved windows -> real hashes
        self._resolved_global: Dict[bytes, bytes] = {}
        self._window_start = 0  # counter value at the last seal
        # sealed-but-unpersisted windows: ph -> (job, digest row) while
        # in flight, and their FIFO (collect and persist run in seal
        # order — window N+1's packed encodings still embed window-N
        # placeholder bytes)
        self._inflight_rows: Dict[bytes, Tuple["WindowJob", int]] = {}
        self._inflight_jobs: deque = deque()
        # windows fully persisted whose device buffers await release;
        # drained by pack_and_dispatch ON THE SEAL STAGE, the only
        # thread that gathers out of in-flight digest tensors
        self._retired: deque = deque()

        # persist-stage accounting: node bytes + keys landed in the host
        # store, and the seconds the store writes took
        self.persist_bytes = 0
        self.persist_seconds = 0.0

        self._storage_source = _StagedReadThrough(
            storages.storage_node_storage, self._staged,
            self._resolved_global,
        )
        self._evmcode_source = _StagedReadThrough(
            storages.evmcode_storage, {}
        )
        # code hashes staged since the last seal (persist writes ONLY the
        # sealed window's codes)
        self._window_codes: List[bytes] = []
        self.account_trie = DeferredMPT(
            _StagedReadThrough(
                storages.account_node_storage, self._staged,
                self._resolved_global,
            ),
            root_hash=parent_root,
            _logs=self._logs,
            _staged=self._staged,
            counter=self._counter,
        )
        # (header, root_ref) per committed block, checked at collect
        self._pending_blocks: List[Tuple[BlockHeader, bytes]] = []

    # ------------------------------------------------------------ worlds

    def make_world(self, state_root: bytes) -> BlockWorldState:
        """World factory for execute_block. The open session IS the
        parent state, whatever root is passed."""
        del state_root
        return BlockWorldState(
            self.account_trie,
            self._storage_source,
            self._evmcode_source,
            get_block_hash=self.get_block_hash,
            account_start_nonce=self.account_start_nonce,
        )

    # ------------------------------------------------------------ commit

    def commit_block(self, world: BlockWorldState, header: BlockHeader,
                     txs: Optional[list] = None) -> None:
        """Fold one executed block's world into the window session (the
        deferred analog of world.flush): accounts put, or removed where
        the block deleted them (EIP-161), storage tries folded by
        ``storage_session``. ``txs`` (the block's tx hashes) rides
        through to ``on_block_committed`` so the serving overlay can
        stamp per-tx visibility journeys — ``None`` when the journey
        plane is off (the zero-cost default)."""
        final = world._materialized_accounts(hasher=None, window=self)
        trie = self.account_trie
        for addr in sorted(final):
            acc = final[addr]
            key = address_key(addr)
            if acc is None:
                trie = trie.remove(key)
            else:
                trie = trie.put(key, acc.encode())
        self.account_trie = trie
        for code in world.codes.values():
            if code:
                h = keccak256(code)
                if h not in self._evmcode_source.staged:
                    self._window_codes.append(h)
                self._evmcode_source.staged[h] = code
        self._pending_blocks.append((header, trie.force_hashed_root()))
        if self.on_block_committed is not None:
            self.on_block_committed(header, final, txs)

    def storage_session(self, root_ref) -> DeferredMPT:
        """A storage-trie session sharing the window namespace; root_ref
        may be a placeholder from an earlier block of the window."""
        if isinstance(root_ref, bytes) and (
            root_ref == EMPTY_TRIE_HASH or not root_ref
        ):
            root_ref = b""
        return DeferredMPT(
            self._storage_source,
            _root_ref=root_ref if root_ref else None,
            root_hash=None if root_ref else EMPTY_TRIE_HASH,
            _logs=self._logs,
            _staged=self._staged,
            counter=self._counter,
            ref_sink=self._storage_phs,
        )

    # ------------------------------------------------------ seal/collect

    def drain_retired(self) -> None:
        """Free the device buffers of windows that fully left the
        pipeline. Persist only APPENDS to ``_retired``; the release runs
        here — on the seal stage (pack_and_dispatch) or after the final
        drain."""
        while self._retired:
            self._retired.popleft().fused_job.release()

    def seal(self) -> "WindowJob":
        """Close the current window ON THE DRIVER THREAD: counter-range
        capture, pending-block swap, live map, fresh log namespace,
        staged-code swap. The pack, dispatch build and upload run later
        in :meth:`pack_and_dispatch`, on the seal stage. The session
        continues: later blocks keep reading the sealed window's staged
        nodes and committing into the same namespace."""
        start, end = self._window_start, self._counter[0]
        self._window_start = end
        pending, self._pending_blocks = self._pending_blocks, []
        # fresh log namespace for the next window; the retained account
        # trie must adopt it (its children share _logs by reference)
        live = {
            ph: rec[0]
            for ph, rec in self._logs.items()
            if _is_placeholder(ph) and rec[0] > 0
        }
        self._logs = {}
        self.account_trie._logs = self._logs
        job = WindowJob(self, pending, None, live)
        job._pack_range = (start, end)
        job.codes, self._window_codes = self._window_codes, []
        return job

    def pack_and_dispatch(self, job: "WindowJob") -> None:
        """Pack the sealed window's placeholder DAG and launch its fused
        fixpoint (asynchronous: the device hashes while later windows
        pack), or resolve it on the host. Runs on the seal stage.

        Earlier windows need not be collected first: refs out of the
        window ride into the launch as resolved-input tile rows (an
        ``ExtRows`` that ``fused.pack``'s scan fills, so each node is
        scanned once), gathered card to card from an in-flight window's
        digests or uploaded from ``_resolved_global``; seals run
        ``pipeline_depth`` ahead of collects. A failed build or launch
        propagates: the replay stops. Idempotent per job:
        ``job._packed`` flips only at the very end."""
        if job._packed:
            return
        # retire windows that left the pipeline (their rows are out of
        # _inflight_rows, so no later pack gathers from them): device
        # memory stays O(in-flight windows)
        self.drain_retired()
        start, end = job._pack_range
        staged = self._staged
        # the raw encodings, in placeholder order; refs to earlier
        # windows are substituted by the launch (device) or the host
        # level loop, and at persist
        pack_t0 = time.perf_counter() if LEDGER.enabled else 0.0
        with span("seal.pack", **job.range_tags()) as pack_sp:
            to_resolve: Dict[bytes, bytes] = {}
            for idx in range(start, end):
                ph = _make_placeholder(idx)
                enc = staged.get(ph)
                if enc is not None:  # None: another session's counter
                    to_resolve[ph] = enc
            pack_sp.set_tag("nodes", len(to_resolve))
        if LEDGER.enabled:
            # host-side classification event: the encoding bytes the pack
            # step staged for dispatch (the cost model's node x bytes
            # join for seal.pack)
            LEDGER.record(
                "seal.pack", HOST, sum(len(e) for e in to_resolve.values()),
                duration=time.perf_counter() - pack_t0,
            )
        job.to_resolve = to_resolve
        # chaos seam: a die between the pack scan and the dispatch — the
        # resumed stage re-runs pack_and_dispatch from the top (memory-
        # only mutations so far; the re-pack is deterministic)
        fault_point("collector.pack")
        adaptive = self.adaptive
        use_device = bool(
            self.fused and to_resolve
            and (adaptive is None or adaptive.device_mode)
        )
        disp_t0 = time.perf_counter()
        if use_device:
            from khipu_tpu_torch.trie.fused import ExtRows, fused_submit

            if job.fused_job is None:
                # the mirror's admit gather rides inside the launch
                # (FusedJob.admit_tiles); its spans carry the window's
                # block range
                job.fused_job = fused_submit(
                    to_resolve, None, _PLACEHOLDER_PREFIX,
                    device=self.device,
                    ext=ExtRows(self._ext_source, job.range_tags()),
                    admit_live=job.live if self.mirror is not None else None,
                    span_tags=job.range_tags(),
                )
            fj = job.fused_job
            if fj.dpos:
                for ph2, row in fj.dpos.items():
                    self._inflight_rows[ph2] = (job, row)
                if job not in self._inflight_jobs:
                    self._inflight_jobs.append(job)
            mode = "device"
            WINDOW_GAUGES["device_windows"] += 1
        else:
            # in the adaptive controller's host mode, hash with the
            # scalar host hasher even where the committer has the device
            # hasher
            hasher = self.hasher
            if adaptive is not None and not adaptive.device_mode:
                hasher = host_hasher
            job.mapping = self._resolve_on_host(to_resolve, hasher,
                                                job.range_tags())
            # digests are FINAL here — publish now so the next seal
            # resolves this window's refs without a barrier (persistence
            # is still gated by collect's root checks)
            self._resolved_global.update(job.mapping)
            mode = "host"
            WINDOW_GAUGES["host_windows"] += 1
        if adaptive is not None:
            adaptive.observe_window(
                mode, len(to_resolve), time.perf_counter() - disp_t0,
            )
        job._packed = True

    def _ext_source(self, ref: bytes):
        """Where a ref out of the window being packed finds its digest:
        32 bytes of an earlier resolved window, ``(digests, row)`` of
        one still in flight on the device, or None for bytes that are
        no placeholder of this session."""
        real = self._resolved_global.get(ref)
        if real is not None:
            return real
        src = self._inflight_rows.get(ref)
        if src is not None:
            return src[0].fused_job.digests, src[1]
        # the persist stage may have published this window between the
        # two probes (it publishes BEFORE dropping the in-flight rows)
        real = self._resolved_global.get(ref)
        if real is None and ref in self._staged:
            raise AssertionError(
                "seal(): unresolvable placeholder ref (foreign session "
                "sharing the staged namespace?)"
            )
        return real

    def _resolve_on_host(self, to_resolve: Dict[bytes, bytes],
                         hasher: Hasher, tags: dict) -> Dict[bytes, bytes]:
        """The host level loop: scan for the in-window children, seed
        the refs out of the window (an in-flight device window's refs by
        a blocking collect of its digests), hash level by level."""
        from khipu_tpu_torch.trie.fused import topo_levels

        deps: Dict[bytes, List[bytes]] = {}
        mapping: Dict[bytes, bytes] = {}
        for ph, enc in to_resolve.items():
            children: List[bytes] = []
            pos = enc.find(_PLACEHOLDER_PREFIX)
            while pos >= 0:
                ref = enc[pos : pos + 32]
                if ref in to_resolve:
                    children.append(ref)
                elif ref not in mapping:
                    real = self._ext_source(ref)
                    if isinstance(real, tuple):
                        digests, row = real
                        real = digests[row].cpu().numpy().tobytes()
                    if real is not None:
                        mapping[ref] = real
                pos = enc.find(_PLACEHOLDER_PREFIX, pos + 32)
            deps[ph] = children
        with span("window.hash", nodes=len(to_resolve), **tags):
            for level in topo_levels(deps):
                digests = hasher([
                    _substitute_bytes(to_resolve[ph], mapping)
                    for ph in level
                ])
                mapping.update(zip(level, digests))
        return mapping

    def collect_roots(self, job: "WindowJob"
                      ) -> List[Tuple[BlockHeader, bytes]]:
        """CHECK every block root against its header, fetching ONLY the
        per-block root digests from the device (32 B x blocks via
        ``FusedJob.fetch_rows``); the full digest tensor stays on the
        device for persist(). Returns [(header, real_root)] and marks
        the job root-checked.

        May run while the PREVIOUS window is still in persist: a root
        ref into it resolves through that job's own fetch_rows via
        ``_inflight_rows`` (rows are deregistered only at the end of
        persist)."""
        # non-staged callers (finalize, the degraded collector, direct
        # tests) reach here straight from seal() — pack lazily
        if not job._packed:
            self.pack_and_dispatch(job)
        if job.fused_job is not None and job in self._inflight_jobs:
            for other in self._inflight_jobs:
                if other is job:
                    break
                if not other._roots_checked:
                    raise AssertionError(
                        "collect() out of FIFO order: an earlier "
                        "sealed window is still in flight"
                    )
        resolved_global = self._resolved_global
        refs = [root_ref for _h, root_ref in job.pending_blocks]
        results: List[Tuple[BlockHeader, bytes]] = []
        with span("seal.rootcheck", blocks=len(job.pending_blocks),
                  **job.range_tags()):
            if job.mapping is not None:
                fetched = job.mapping
            elif job.fused_job is not None:
                fetched = job.fused_job.fetch_rows(refs)
            else:
                fetched = {}
            for header, root_ref in job.pending_blocks:
                real = fetched.get(root_ref) or resolved_global.get(
                    root_ref
                )
                if real is None:
                    # an earlier window mid-persist: fetch its digest
                    # row straight off the device
                    src = self._inflight_rows.get(root_ref)
                    if src is not None:
                        real = src[0].fused_job.fetch_rows(
                            [root_ref]
                        ).get(root_ref)
                if real is None:
                    real = root_ref
                if real != header.state_root:
                    raise WindowMismatch(
                        header.number, real, header.state_root
                    )
                results.append((header, real))
        job.results = results
        job._roots_checked = True
        return results

    def admit_mirror(self, job: "WindowJob") -> None:
        """Land the window's LIVE nodes in the device mirror straight
        from the fused outputs: final encodings and claimed digests
        gathered card to card; only the row indices cross to the device.
        Rows are keyed by the window's placeholder ALIASES (the real
        digests are still on the device) and persist() rekeys them. A
        no-op without a mirror or on the host path."""
        fj = job.fused_job
        mirror = self.mirror
        if mirror is None or fj is None:
            if fj is not None:
                fj.release_encs()
            return
        # fast path: the launch already gathered the live rows
        # (fused_submit admit_live) — the tiles land straight in the
        # mirror
        tiles = fj.admit_tiles
        if tiles is not None:
            aliases2: List[bytes] = []
            with span("seal.alias_gather", live=len(job.live),
                      fused_admit=True, **job.range_tags()):
                for nb2, keys2, enc_g2, claim_g2, lengths2 in tiles:
                    mirror.admit_device(
                        nb2, keys2, enc_g2, claim_g2, lengths2
                    )
                    aliases2.extend(k for k in keys2 if k is not None)
            job.aliases = aliases2
            fj.admit_tiles = None  # free the gathered device tensors
            fj.release_encs()
            return
        if fj.encs is None:
            fj.release_encs()
            return
        from khipu_tpu_torch.storage.device_mirror import TILE

        live = job.live
        aliases: List[bytes] = []
        with span("seal.alias_gather", live=len(live),
                  **job.range_tags()):
            for c, (phs, base) in enumerate(fj.class_rows):
                enc_dev = fj.encs[c]
                nb = int(enc_dev.shape[1]) // RATE
                idx: List[int] = []
                keys: List[Optional[bytes]] = []
                lengths: List[int] = []
                for r, ph in enumerate(phs):
                    if ph in live:
                        idx.append(r)
                        keys.append(ph)
                        lengths.append(len(job.to_resolve[ph]))
                if not idx:
                    continue
                n = len(idx)
                npad = -(-n // TILE) * TILE
                # padding points at the class's spare filler row: a
                # valid padded row whose digest K5 computed, so filler
                # slots verify
                dummy = int(enc_dev.shape[0]) - 1
                rows = torch.full((npad,), dummy, dtype=torch.long)
                rows[:n] = torch.tensor(idx, dtype=torch.long)
                keys.extend([None] * (npad - n))
                lengths.extend([0] * (npad - n))
                # only the row indices cross; the gathers run card to
                # card
                with LEDGER.transfer("mirror.admit_window", H2D,
                                     rows.numel() * rows.element_size()):
                    rows = rows.to(enc_dev.device)
                enc_g = enc_dev.index_select(0, rows)
                claim_g = fj.digests.index_select(0, rows + base)
                mirror.admit_device(nb, keys, enc_g, claim_g, lengths)
                aliases.extend(k for k in keys if k is not None)
        job.aliases = aliases
        fj.release_encs()

    def persist(self, job: "WindowJob") -> None:
        """Fetch the window's full mapping (the one bulk device-to-host
        copy, off the critical path), publish it, spill the live nodes
        to the host stores, prune session state.

        Runs on the persist stage while the driver executes later
        windows. The step ORDER is the thread-safety invariant (every
        mutation is a GIL-atomic dict/deque op). WITH a mirror: rekey
        the device rows to their real hashes FIRST, then publish
        ``_resolved_global`` — a reader following a published hash finds
        the node in the mirror before the host spill lands. WITHOUT a
        mirror: spill BEFORE publishing, publish BEFORE pruning
        ``_staged``, prune BEFORE dropping the in-flight rows."""
        if job.fused_job is not None and self._inflight_jobs:
            if (self._inflight_jobs[0] is not job
                    and job in self._inflight_jobs):
                raise AssertionError(
                    "persist() out of FIFO order: an earlier sealed "
                    "window is still in flight"
                )
        mapping = job.mapping
        if mapping is None:
            mapping = job.fused_job.collect()
        resolved_global = self._resolved_global
        published = False
        if job.aliases:
            with span("window.rekey", rows=len(job.aliases),
                      **job.range_tags()):
                self.mirror.rekey(
                    {a: mapping[a] for a in job.aliases if a in mapping}
                )
            resolved_global.update(mapping)
            published = True

        # spill LIVE nodes only (dead intermediates were hashed for the
        # root checks but nothing references them), routed by session
        # tag; cross-window refs resolve through resolved_global (FIFO
        # persist order: the source window published first)
        live_phs: List[bytes] = []
        reals: List[bytes] = []
        encs: List[bytes] = []
        for ph in job.live:
            real = mapping.get(ph) or resolved_global.get(ph)
            if real is None:
                raise WindowPlaceholderError(ph, "has no resolved digest")
            enc = job.to_resolve.get(ph)
            if enc is None:
                raise WindowPlaceholderError(ph, "has no packed encoding")
            live_phs.append(ph)
            reals.append(real)
            encs.append(enc)

        def _lookup(ref, _m=mapping, _g=resolved_global):
            v = _m.get(ref)
            return v if v is not None else _g.get(ref)

        # the mirror's resident rows ARE the final substituted encodings:
        # read them back a whole tile at a time (mirror.spill_rows) in
        # place of substituting on the host. Rows ring-evicted before
        # the spill fall back to host substitution below
        spilled: Dict[bytes, bytes] = {}
        if published and self.mirror is not None and reals:
            spilled = self.mirror.spill_rows(reals)

        with span("window.store", live=len(live_phs), **job.range_tags()):
            if spilled:
                miss = [
                    i for i, real in enumerate(reals)
                    if real not in spilled
                ]
                miss_sub = (
                    _substitute_many([encs[i] for i in miss], _lookup)
                    if miss else []
                )
                miss_map = dict(zip(miss, miss_sub))
                subbed = [
                    miss_map[i] if i in miss_map else spilled[real]
                    for i, real in enumerate(reals)
                ]
            else:
                subbed = _substitute_many(encs, _lookup)
            account_nodes: Dict[bytes, bytes] = {}
            storage_nodes: Dict[bytes, bytes] = {}
            storage_phs = self._storage_phs
            for ph, real, enc in zip(live_phs, reals, subbed):
                if ph in storage_phs:
                    storage_nodes[real] = enc
                else:
                    account_nodes[real] = enc
            t_store = time.perf_counter()
            self.storages.account_node_storage.update([], account_nodes)
            # chaos seam: a ``die`` here kills the spill between the two
            # node stores — the torn window must roll back bit-exact
            # through journal.recover() (host state has the account half
            # only; the mirror is volatile and detached there)
            fault_point("collector.spill")
            self.storages.storage_node_storage.update([], storage_nodes)
            store_bytes = sum(len(e) for e in subbed) + 32 * len(live_phs)
            store_secs = time.perf_counter() - t_store
            self.persist_bytes += store_bytes
            self.persist_seconds += store_secs
            if LEDGER.enabled:
                # host-side store traffic: classification only (HOST
                # direction never feeds the device-transfer counters)
                LEDGER.record("window.store", HOST, store_bytes,
                              duration=store_secs)
        # only THIS window's codes persist (later windows' roots are
        # still unchecked; their codes stay staged until their persist)
        staged_codes = self._evmcode_source.staged
        for code_hash in job.codes:
            code = staged_codes.pop(code_hash, None)
            if code is not None:
                self.storages.evmcode_storage.put(code_hash, code)
        if not published:
            resolved_global.update(mapping)
        # prune the persisted window's staged encodings: live nodes are
        # durable (or mirror-resident) and retained trie refs read
        # through the resolved mapping; dead ones are unreferenced
        staged = self._staged
        for ph in job.to_resolve:
            staged.pop(ph, None)
            storage_phs.discard(ph)
        # drop the in-flight registration LAST: a racing seal that misses
        # these rows re-checks _resolved_global, published above
        if job.fused_job is not None:
            inflight = self._inflight_rows
            for ph in job.fused_job.dpos:
                inflight.pop(ph, None)
            if self._inflight_jobs and self._inflight_jobs[0] is job:
                self._inflight_jobs.popleft()
            # device buffers are released by the next pack on the seal
            # stage (drain_retired) — never here, where a concurrent
            # pack may be gathering from the digest tensor
            self._retired.append(job)

    def collect(self, job: "WindowJob") -> List[Tuple[BlockHeader, bytes]]:
        """Root-check + mirror-admit + persist in one call — the
        synchronous composition of the three stages (finalize, the
        degraded collector, direct tests)."""
        results = self.collect_roots(job)
        self.admit_mirror(job)
        self.persist(job)
        return results

    # ---------------------------------------------------------- finalize

    def finalize(self) -> List[Tuple[BlockHeader, bytes]]:
        """Resolve the whole open window's placeholder DAG, CHECK every
        block root against its header, persist all nodes + codes.
        Returns [(header, real_root)]."""
        return self.collect(self.seal())


class WindowJob:
    """A sealed window in flight: its packed DAG (placeholder -> raw
    encoding), live set, pending block-root checks, and
    either an async FusedJob (device) or an eager mapping (host)."""

    __slots__ = ("committer", "pending_blocks", "to_resolve", "live",
                 "fused_job", "mapping", "codes", "results", "aliases",
                 "_roots_checked", "_packed", "_pack_range")

    def __init__(self, committer, pending_blocks, to_resolve, live):
        self.committer = committer
        self.pending_blocks = pending_blocks
        # None until pack_and_dispatch runs (seal() is close-out only)
        self.to_resolve = to_resolve
        self.live = live
        self.fused_job = None
        self.mapping: Optional[Dict[bytes, bytes]] = None
        self.codes: List[bytes] = []
        # set by collect_roots / admit_mirror
        self.results: Optional[List[Tuple[BlockHeader, bytes]]] = None
        self.aliases: List[bytes] = []
        self._roots_checked = False
        # the counter range captured at seal and the flipped-at-the-end
        # idempotency latch
        self._packed = False
        self._pack_range: Tuple[int, int] = (0, 0)

    def range_tags(self) -> dict:
        """The window's block range as span tags (``block_lo`` /
        ``block_hi``), so the sub-phase spans of one window join its
        window report and cost rows; empty for a window of no blocks."""
        if not self.pending_blocks:
            return {}
        return {"block_lo": self.pending_blocks[0][0].number,
                "block_hi": self.pending_blocks[-1][0].number}
