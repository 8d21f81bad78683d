"""Regular-sync replay driver: feed blocks through execution, gate every
root, keep the per-block perf line.

Parity: blockchain/sync/RegularSyncService.scala:43 —
executeAndInsertBlocks:381 (serial fold), executeAndInsertBlock:405
(validate -> execute -> save), and the one-line per-block perf report
:429. Networking is replaced by a block source (another Blockchain, or
decoded RLP blocks).

The port's counterpart of ``khipu_tpu.sync.replay``. At
``commit_window_blocks=1`` every block is executed, its dirty trie nodes
hashed through the driver's hasher (``device_commit``: one K1r launch a
trie level on the card) and checked against the header's state root. At
``commit_window_blocks > 1`` the windowed pipeline runs
(``replay_windowed``): W blocks fold into one deferred session
(ledger/window.py), the window resolves in one K5 launch on the card,
and background stage threads check its roots, admit its live nodes into
the device mirror, spill them to the host stores and save its blocks,
while the driver executes the next window. Each stage boundary is a
chaos seam (``collector.seal``, ``collector.collect``,
``collector.persist``, ``collector.save``, ``collector.commit``): a
``die`` there stops the stage thread as a process death would, and
``recover`` settles what it left.

The observability plane rides the same path (``config.observability``,
off by default): the driver's tracer (``ReplayDriver(tracer=)``) is
active on the calling thread and on each stage thread while it runs its
job, and the driver's ``window.seal`` span token rides each job's
closures, so ``window.pack`` / ``collect`` / ``persist`` / ``save`` are
its children across threads; the movement ledger (``LEDGER``) tags each
crossing with its window and phase; the transaction passport
(``JOURNEY``) stamps ``ingress``, ``seal``, ``journal.intent`` and
``durable``.

The serving plane's read view (``ReplayDriver(read_view=)``,
serving/readview.py) rides it too: each ``commit_block`` publishes the
block's account diff on the driver thread (a host dict), the save
stage retires a window once its commit mark is down, and every
exception that leaves ``replay_windowed`` (a validation or execution
error, a stage's failure re-raised here, a kernel wrapper's or
``fused.dispatch``'s error, a ``CollectorDied``) invalidates the overlay
above best before it propagates: a reader never sees state that no
durable window holds.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional

import torch

from khipu_tpu_torch.chaos import InjectedDeath, fault_point
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.domain.difficulty import calc_difficulty
from khipu_tpu_torch.evm.config import for_block
from khipu_tpu_torch.ledger.ledger import execute_block
from khipu_tpu_torch.ledger.window import WindowCommitter
from khipu_tpu_torch.observability.journey import JOURNEY, current_node
from khipu_tpu_torch.observability.profiler import HOST, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import (
    Tracer,
    apply_config,
    event,
    span,
    use_tracer,
)
from khipu_tpu_torch.observability.trace import tracer as _default_tracer
from khipu_tpu_torch.sync.prefetch import (
    SenderPrefetcher,
    recover_block_senders,
)
from khipu_tpu_torch.trie.bulk import device_hasher, host_hasher
from khipu_tpu_torch.validators.validators import (
    BlockHeaderValidator,
    BlockValidator,
    OmmersValidator,
)

# the driver thread's wall clock, split; they add up to the replay's
# seconds but for the loop's own bookkeeping
PHASES = ("senders", "validate", "execute", "commit", "save")
# the windowed pipeline's: ``commit`` folds a block into the window
# session, ``seal`` is the driver's close-out and journal intent,
# ``collect`` the driver's stalls on the pipeline (backpressure and
# drains); the ``*_bg`` stage times overlap the driver's and are not
# wall clock
WINDOWED_PHASES = ("senders", "validate", "execute", "commit", "seal",
                   "collect", "seal_bg", "collect_bg", "persist_bg",
                   "save_bg", "senders_bg")

# live window-pipeline gauges; the driver and the stage threads update
# them in place
PIPELINE_GAUGES = REGISTRY.gauge_group("khipu_pipeline", {
    "depth": 0,  # pipeline_depth of the last run
    "in_flight": 0,  # windows sealed but not yet fully saved
    "windows_sealed": 0,
    "windows_collected": 0,
    "occupancy": 0.0,  # driver/collector overlap fraction, last run
    "driver_stall_s": 0.0,  # driver seconds blocked on the pipeline
    "collector_busy_s": 0.0,  # background stage busy seconds (all)
    "collector_deaths": 0,  # dead workers detected by liveness checks
    # windows committed synchronously after a collector death
    "sync_fallback_windows": 0,
    # per-stage depth and busy seconds (seal -> collect -> persist ->
    # save)
    "stage_seal_depth": 0,
    "stage_collect_depth": 0,
    "stage_persist_depth": 0,
    "stage_save_depth": 0,
    "stage_seal_busy_s": 0.0,
    "stage_collect_busy_s": 0.0,
    "stage_persist_busy_s": 0.0,
    "stage_save_busy_s": 0.0,
}, help="window-pipeline state (sync/replay.py)")


class WindowNeedsByzantium(ValueError):
    """A windowed replay met a pre-Byzantium block (its receipts embed
    per-tx roots the window cannot produce); nothing of that window was
    persisted, so a caller may import it block by block."""


class CollectorDied(RuntimeError):
    """A background stage thread is no longer alive but never recorded
    a failure — a death mid-job. Detected by the timed liveness checks
    in submit/drain instead of hanging on the condition variable."""


@dataclass
class ReplayStats:
    blocks: int = 0
    txs: int = 0
    gas: int = 0
    seconds: float = 0.0
    # execute-stage split (ledger/ledger.py Stats, summed): txs merged
    # without a serial re-run (optimistic) or run inside a scheduled
    # batch, serial re-executions or conflicted predictions, txs through
    # the vectorized fast path vs the serial residue, and scheduled
    # attempts discarded by the post-hoc footprint check
    parallel_txs: int = 0
    conflicts: int = 0
    fast_path_txs: int = 0
    residue_txs: int = 0
    mispredictions: int = 0
    # per-phase wall-clock split (seconds) of the driver thread:
    # senders (waiting on the prefetcher; without it, execute_block
    # recovers them inside execute), validate (header, body and ommer
    # checks, with the host-hashed transaction root), execute (the
    # serial fold, rewards, receipts root), commit (the state-root flush: the block's dirty
    # trie nodes hashed a level at a time), save (persist the flushed
    # nodes and the block stores). ``senders_bg`` is the prefetch
    # thread's busy time, which overlaps the others.
    # (the windowed pipeline's phases: WINDOWED_PHASES)
    phases: dict = field(default_factory=dict)
    # windowed: fraction of the stage threads' busy time that overlapped
    # driver work (1.0 = collect/persist/save fully hidden)
    pipeline_occupancy: float = 0.0
    # windowed: node bytes + keys the persist stage landed in the host
    # stores, and the seconds the store writes took
    persist_bytes: int = 0
    persist_store_seconds: float = 0.0

    @property
    def blocks_per_s(self) -> float:
        return self.blocks / self.seconds if self.seconds else 0.0

    @property
    def persist_bytes_per_sec(self) -> float:
        if self.persist_store_seconds <= 0.0:
            return 0.0
        return self.persist_bytes / self.persist_store_seconds

    @property
    def parallel_rate(self) -> float:
        """Fraction of executed txs that ran in parallel (merged
        without a re-run, or inside a scheduled batch)."""
        return self.parallel_txs / self.txs if self.txs else 0.0

    @property
    def fast_path_coverage(self) -> float:
        """Fraction of executed txs the vectorized fast path carried."""
        return self.fast_path_txs / self.txs if self.txs else 0.0

    def add_exec(self, s) -> None:
        """Add one block's execute-stage counters (a ledger ``Stats``)."""
        self.parallel_txs += s.parallel_count
        self.conflicts += s.conflict_count
        self.fast_path_txs += s.fast_path_txs
        self.residue_txs += s.residue_txs
        self.mispredictions += s.mispredicted_txs

    def phase_line(self) -> dict:
        return {k: round(v, 3) for k, v in self.phases.items()}


class _WindowCollector:
    """Staged background pipeline: each window job flows through four
    bounded FIFO stages on dedicated threads — **seal** (pack, dispatch
    build, upload and the K5 launch, off the driver), **collect** (root
    checks and the mirror admit), **persist** (the host spill) and
    **save** (block storage) — while the driver executes the next
    window's transactions. ``submit`` enqueues one job (a callable, or a
    tuple of per-stage callables) and blocks only while ``depth`` jobs
    already occupy the first stage; stage hand-offs are bounded the same
    way; ``drain`` blocks until every stage is empty. Within a stage
    jobs run strictly FIFO, and hand-off order preserves queue order.

    Failure semantics: the FIRST exception (typically WindowMismatch)
    aborts the whole pipeline — queued jobs at every stage are dropped
    WITHOUT persisting anything and the original exception re-raises on
    the driver thread at its next submit/drain, so a mismatch still
    names the failing block number."""

    STAGES = ("seal", "collect", "persist", "save")

    def __init__(self, depth: int, join_timeout: float = 60.0,
                 liveness_poll: float = 0.1):
        self.depth = max(1, depth)
        self.join_timeout = join_timeout
        # backpressure/drain waits wake at this period to re-check the
        # workers are alive — a dead thread can never notify
        self.liveness_poll = liveness_poll
        self._cv = threading.Condition()
        k = len(self.STAGES)
        self._qs: List[deque] = [deque() for _ in range(k)]
        self._active: List[bool] = [False] * k
        self._current: List[Optional[tuple]] = [None] * k
        self._done: List[bool] = [False] * k  # normal thread exit
        self.stage_busy: List[float] = [0.0] * k
        self._failure: Optional[BaseException] = None
        self._closed = False
        # set by take_pending: each live worker finishes (and hands on)
        # the job in hand, then exits without taking another
        self._halt = False
        self._inflight = 0  # jobs submitted but not fully completed
        self._threads = [
            threading.Thread(
                target=self._run, args=(i,),
                name=f"window-{name}", daemon=True,
            )
            for i, name in enumerate(self.STAGES)
        ]
        for t in self._threads:
            t.start()

    @property
    def busy_seconds(self) -> float:
        return sum(self.stage_busy)

    # ------------------------------------------------------- driver side

    def _update_gauges(self) -> None:
        """Call under ``_cv``."""
        PIPELINE_GAUGES["in_flight"] = self._inflight
        for i, name in enumerate(self.STAGES):
            PIPELINE_GAUGES[f"stage_{name}_depth"] = (
                len(self._qs[i]) + (1 if self._active[i] else 0)
            )
            PIPELINE_GAUGES[f"stage_{name}_busy_s"] = round(
                self.stage_busy[i], 3
            )

    def _check_liveness(self) -> None:
        """Call under ``_cv``: a stage worker that exited without
        recording a failure and without being closed died mid-job."""
        if self._failure is not None or self._closed:
            return
        for i, t in enumerate(self._threads):
            if not self._done[i] and not t.is_alive():
                raise CollectorDied(
                    f"window-{self.STAGES[i]} stage thread died mid-"
                    f"job ({sum(len(q) for q in self._qs)} queued, "
                    f"active={self._active})"
                )

    def submit(self, fns) -> float:
        """Queue one job: a bare callable (runs entirely on the first
        stage) or a tuple of per-stage callables — stage i runs
        ``fns[i]`` then hands the job to stage i+1. Returns driver
        seconds stalled on backpressure. Re-raises the collector's
        failure, if any; raises CollectorDied when a worker is gone."""
        fns = (fns,) if callable(fns) else tuple(fns)
        t0 = time.perf_counter()
        with self._cv:
            self._check_liveness()
            while (self._failure is None and not self._closed
                   and len(self._qs[0]) + self._active[0] >= self.depth):
                self._cv.wait(timeout=self.liveness_poll)
                self._check_liveness()
            if self._failure is not None:
                raise self._failure
            if self._closed:
                raise RuntimeError("collector is closed")
            self._qs[0].append(fns)
            self._inflight += 1
            PIPELINE_GAUGES["windows_sealed"] += 1
            self._update_gauges()
            self._cv.notify_all()
        return time.perf_counter() - t0

    def drain(self) -> float:
        """Wait until every submitted job has completed all stages;
        returns driver seconds stalled. Re-raises the collector's
        failure, if any; raises CollectorDied when a worker is gone."""
        t0 = time.perf_counter()
        with self._cv:
            self._check_liveness()
            while self._failure is None and self._inflight:
                self._cv.wait(timeout=self.liveness_poll)
                self._check_liveness()
            if self._failure is not None:
                raise self._failure
        return time.perf_counter() - t0

    def take_pending(self) -> List[Callable[[], None]]:
        """After CollectorDied: every unfinished job in FIFO order —
        deepest stage first (those windows are oldest), the dead stage's
        torn current job ahead of its queue (jobs are idempotent: node
        puts are content-addressed, block saves overwrite by number,
        stats apply only at job end). The live workers first finish the
        job in hand and hand it on, then stop (joined within
        ``join_timeout``): a job a live stage is running is never
        returned to be run a second time beside it. Marks the collector
        closed; the caller runs these synchronously."""
        with self._cv:
            self._closed = True
            self._halt = True
            self._cv.notify_all()
        deadline = time.monotonic() + self.join_timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError(
                "window-collector failed to stop within "
                f"{self.join_timeout:.0f}s after a stage died — a wedged "
                "job is still holding the pipeline"
            )
        if self._failure is not None:
            # a live stage failed while finishing its job: fail-stop
            raise self._failure
        with self._cv:
            out: List[Callable[[], None]] = []
            for i in range(len(self.STAGES) - 1, -1, -1):
                entries: List[tuple] = []
                if self._active[i] and self._current[i] is not None:
                    entries.append(self._current[i])
                entries.extend(self._qs[i])
                self._qs[i].clear()
                out.extend(self._resume(fns, i) for fns in entries)
            self._inflight = 0
            self._update_gauges()
            self._cv.notify_all()
        return out

    @staticmethod
    def _resume(fns: tuple, i: int) -> Callable[[], None]:
        rest = fns[i:]
        if len(rest) == 1:
            return rest[0]

        def run_rest():
            for fn in rest:
                fn()

        return run_rest

    def close(self) -> None:
        """Stop the workers (after finishing anything queued) and join.
        Raises if any worker is still alive after ``join_timeout`` — a
        wedged job must not be silently abandoned."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        deadline = time.monotonic() + self.join_timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError(
                "window-collector failed to stop within "
                f"{self.join_timeout:.0f}s — a wedged job is still "
                "holding the pipeline (its windows are NOT committed)"
            )

    def kill(self) -> None:
        """Abort: drop queued jobs at every stage WITHOUT running them
        and join. The driver calls this when IT failed — windows sealed
        after the failing block must not be committed. Already
        unwinding, so a wedged worker is reported, not raised."""
        with self._cv:
            for q in self._qs:
                q.clear()
            self._closed = True
            self._inflight = 0
            self._update_gauges()
            self._cv.notify_all()
        deadline = time.monotonic() + self.join_timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            print(
                "WARNING: window-collector did not stop within "
                f"{self.join_timeout:.0f}s of kill(); abandoning the "
                "wedged daemon thread",
                file=sys.stderr,
            )

    # ------------------------------------------------------- worker side

    def _exit_ready(self, i: int) -> bool:
        """Call under ``_cv``: stage ``i`` may exit once the collector
        is closed and its upstream can never forward again."""
        if not self._closed:
            return False
        if i == 0:
            return True
        return self._done[i - 1] or not self._threads[i - 1].is_alive()

    def _run(self, i: int) -> None:
        q = self._qs[i]
        while True:
            with self._cv:
                while (not q and self._failure is None and not self._halt
                       and not self._exit_ready(i)):
                    # timed: an upstream death is silent (no notify)
                    self._cv.wait(timeout=0.5)
                if self._failure is not None or self._halt or (
                    not q and self._exit_ready(i)
                ):
                    self._done[i] = True
                    self._cv.notify_all()
                    return
                fns = q.popleft()
                self._current[i] = fns
                self._active[i] = True
                self._update_gauges()
            t0 = time.perf_counter()
            try:
                fns[i]()
            except InjectedDeath:
                # simulated process death (chaos ``die``): no failure
                # record, no notify — the thread just stops with the job
                # half done, as under SIGKILL. The driver's liveness
                # checks raise CollectorDied; _current stays set so
                # take_pending can re-run the torn job.
                return
            # anything else is recorded and re-raised on the driver by
            # submit()/drain(): fail-stop, not swallowed
            except BaseException as exc:  # noqa: BLE001
                with self._cv:
                    self._failure = exc
                    self._active[i] = False
                    self._current[i] = None
                    for qq in self._qs:
                        qq.clear()  # abort: NOTHING else persists
                    self._inflight = 0
                    self._update_gauges()
                    self._cv.notify_all()
                return
            dt = time.perf_counter() - t0
            forward = len(fns) > i + 1 and i + 1 < len(self._qs)
            with self._cv:
                self.stage_busy[i] += dt
                PIPELINE_GAUGES["collector_busy_s"] = round(
                    self.busy_seconds, 3
                )
                if forward:
                    # bounded hand-off: wait while downstream is full
                    # (close() still forwards — queued work completes;
                    # only kill()/failure drop it)
                    while (len(self._qs[i + 1]) >= self.depth
                           and self._failure is None
                           and not self._closed):
                        self._cv.wait(timeout=self.liveness_poll)
                    if self._failure is None:
                        self._qs[i + 1].append(fns)
                else:
                    self._inflight = max(0, self._inflight - 1)
                    PIPELINE_GAUGES["windows_collected"] += 1
                self._active[i] = False
                self._current[i] = None
                self._update_gauges()
                self._cv.notify_all()


class ReplayDriver:
    """Executes a stream of blocks against a target chain DB.

    ``device=None`` means the card: with ``device_commit`` every block's
    trie commit hashes there (``device_hasher`` bound to it; in the
    windowed pipeline the fused fixpoint, K5 on the card, and the device
    mirror), and the sender prefetcher batches each block's signing
    hashes there when ``sync.sender_batch_hash`` is on. ``device="cpu"``
    runs the plain versions. Without ``device_commit`` the commit is the
    host fold (serial) or the host level loop (windowed).

    ``tracer``: the ring this driver's spans go to (the process tracer
    by default); ``config.observability`` enables it, the movement
    ledger and the journey board. ``read_view``: the serving plane's
    read-your-writes overlay (serving/readview.py) the windowed replay
    publishes into, retires from and invalidates.
    """

    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        log: Optional[Callable[[str], None]] = None,
        validate_headers: bool = True,
        device_commit: bool = False,
        device=None,
        tracer: Optional[Tracer] = None,
        read_view=None,
    ):
        self.blockchain = blockchain
        self.config = config
        # serving-plane read view (serving/readview.py): committed
        # blocks publish their account diffs into it on the driver
        # thread, durable windows retire them on the save stage, and a
        # pipeline abort invalidates everything above the committed
        # best — RPC reads stay monotonic mid-pipeline
        self.read_view = read_view
        # per-driver recorder: a driver handed its own Tracer records
        # there; the default is the process instance
        self.tracer = tracer if tracer is not None else _default_tracer
        apply_config(config.observability, self.tracer)
        self.log = log
        self.device = resolve_device(device)
        self.header_validator = BlockHeaderValidator(
            config.blockchain,
            difficulty_fn=lambda h, p: calc_difficulty(
                h.unix_timestamp, p, config.blockchain
            ),
        )
        self.validate_headers = validate_headers
        # windowed-session epoch: blocks between committer resets (see
        # replay_windowed) — bounds session memory on long replays
        self.session_epoch_blocks = 512
        # save_block's persisted-root == header.state_root check gates
        # the device commit on every block
        if device_commit:
            self.hasher = functools.partial(device_hasher, device=self.device)
        else:
            self.hasher = None
        # the driver's device mirror (the window-commit target when
        # sync.device_mirror_commit is on), built at the first windowed
        # replay and reused across epochs and replays
        self._mirror = None
        # the last windowed replay's adaptive controller (None when off)
        self.adaptive = None

    def recover(self):
        """Crash-recovery startup pass (sync/journal.py): settle every
        pending window-commit intent — repair complete windows, roll
        back partial ones, complete or abandon torn chain switches (a
        torn switch re-executes on this driver's device). Returns a
        RecoveryReport."""
        from khipu_tpu_torch.sync.journal import recover

        return recover(self.blockchain, log=self.log, config=self.config,
                       device=self.device)

    def replay(self, blocks: Iterable[Block]) -> ReplayStats:
        """executeAndInsertBlocks: serial fold with full validation, or
        the windowed pipeline at ``commit_window_blocks > 1``."""
        sync = self.config.sync
        if sync.commit_window_blocks > 1:
            return self.replay_windowed(blocks, sync.commit_window_blocks)
        stats = ReplayStats(phases={k: 0.0 for k in PHASES})
        t_start = time.perf_counter()
        prefetcher = None
        if sync.sender_prefetch:
            prefetcher = SenderPrefetcher(
                blocks,
                depth=sync.sender_prefetch_depth,
                cache_entries=sync.sender_cache_entries,
                batch_hash=sync.sender_batch_hash,
                device=self.device,
            )
            source = _timed_pull(prefetcher, stats.phases)
        else:
            source = iter(blocks)
        try:
            with use_tracer(self.tracer):
                for block in source:
                    self._execute_and_insert(block, stats)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if prefetcher is not None:
            stats.phases["senders_bg"] = prefetcher.busy_seconds
        stats.seconds = time.perf_counter() - t_start
        return stats

    def replay_windowed(self, blocks: Iterable[Block],
                        window_size: int) -> ReplayStats:
        """The windowed replay with THIS driver's tracer active on the
        calling thread (each stage job activates it on its own thread —
        the tracer rides the closures like the seal token), so two
        drivers in one process record to their own rings. See
        ``_replay_windowed``."""
        with use_tracer(self.tracer):
            return self._replay_windowed(blocks, window_size)

    def _replay_windowed(self, blocks: Iterable[Block],
                         window_size: int) -> ReplayStats:
        """Window-batched PIPELINED replay: execute W blocks against one
        open deferred session, seal the window (the driver's close-out
        and journal intent), then execute the NEXT window's transactions
        while the stage threads pack and launch the fixpoint, check the
        roots, admit to the mirror, spill and save. Root checks happen up
        to ``pipeline_depth`` windows later than the serial path, with
        the same failure semantics: nothing of a window persists before
        its roots pass, and a WindowMismatch drains the pipeline and
        re-raises here with the failing block number."""
        stats = ReplayStats(phases={k: 0.0 for k in WINDOWED_PHASES})
        ph = stats.phases
        t_start = time.perf_counter()
        sync = self.config.sync
        dev = self.device
        hasher = self.hasher or host_hasher
        prefetcher = None
        if sync.sender_prefetch:
            prefetcher = SenderPrefetcher(
                blocks,
                depth=sync.sender_prefetch_depth,
                cache_entries=sync.sender_cache_entries,
                batch_hash=sync.sender_batch_hash,
                device=dev,
            )
            blocks = _timed_pull(prefetcher, ph)
        blocks = iter(blocks)
        try:
            first = next(blocks)
        except StopIteration:
            if prefetcher is not None:
                prefetcher.close()
            return stats

        parent = self.blockchain.get_header_by_number(first.number - 1)
        if parent is None:
            if prefetcher is not None:
                prefetcher.close()
            raise ValueError(f"no parent for block {first.number}")
        window_headers = {}
        window_headers_full = {}
        window_blocks = {}

        def block_hash_of(n: int):
            h = window_headers.get(n)
            return h if h else self.blockchain.get_hash_by_number(n)

        # device-resident commit: with device_commit the driver's mirror
        # is the commit target — collect admits windows card to card and
        # the host spill runs on the persist stage; NodeStorage's
        # read-through serves nodes not yet spilled
        mirror = None
        if self.hasher is not None and sync.device_mirror_commit:
            mirror = self._mirror
            if mirror is None:
                from khipu_tpu_torch.storage.device_mirror import (
                    DeviceNodeMirror,
                )

                mirror = self._mirror = DeviceNodeMirror(
                    sync.mirror_capacity_rows, device=dev
                )
            else:
                # a replay that died left the alias rows of windows that
                # never published; this replay's session restarts the
                # placeholder counter, so a stale alias would be rekeyed
                # under a new window's real hash. Completed replays leave
                # none (every window rekeyed its aliases at persist)
                mirror.drop_aliases(mirror.alias_keys())
            self.blockchain.storages.attach_mirror(mirror)

        # ONE controller per replay: it outlives epoch committer
        # rebuilds so the EWMA keeps its history
        adaptive = None
        if sync.adaptive_commit and self.hasher is not None:
            from khipu_tpu_torch.sync.adaptive import AdaptiveCommitController

            # the probe is seal-path machinery: bill it to the seal phase
            with LEDGER.context(window=0, phase="seal"):
                adaptive = AdaptiveCommitController(sync, device_cap=True,
                                                    device=dev)
        self.adaptive = adaptive

        def make_committer(parent_root: bytes) -> WindowCommitter:
            return WindowCommitter(
                self.blockchain.storages,
                parent_root,
                hasher=hasher,
                account_start_nonce=(
                    self.config.blockchain.account_start_nonce
                ),
                get_block_hash=block_hash_of,
                # device commit: one fused fixpoint a window
                fused=self.hasher is not None,
                mirror=mirror,
                adaptive=adaptive,
                device=dev,
                on_block_committed=(
                    self.read_view.publish_block
                    if self.read_view is not None else None
                ),
            )

        committer = make_committer(parent.state_root)
        depth = max(1, sync.pipeline_depth)
        collector = _WindowCollector(
            depth, join_timeout=sync.collector_join_timeout
        )
        PIPELINE_GAUGES["depth"] = depth
        # crash consistency: WAL intent before each background job, a
        # commit mark after its best-number advance
        journal = (
            self.blockchain.storages.window_journal
            if sync.commit_journal else None
        )
        window_parent_root = parent.state_root
        # graceful degradation: a dead stage thread (CollectorDied from
        # the liveness checks) switches the driver to synchronous
        # commits instead of aborting — unless config says abort
        sync_degraded = False

        def _degrade() -> None:
            nonlocal sync_degraded
            sync_degraded = True
            PIPELINE_GAUGES["collector_deaths"] += 1
            event("pipeline.degrade", reason="collector-died")
            if self.log is not None:
                self.log(
                    "window-collector thread died; degrading to "
                    "synchronous window commits (jobs are idempotent "
                    "— re-running the torn one)"
                )
            for fn in collector.take_pending():
                PIPELINE_GAUGES["sync_fallback_windows"] += 1
                fn()

        def submit_job(run_fns) -> float:
            if sync_degraded:
                PIPELINE_GAUGES["sync_fallback_windows"] += 1
                for fn in run_fns:
                    fn()
                if journal is not None:
                    journal.prune()
                return 0.0
            try:
                return collector.submit(run_fns)
            except CollectorDied:
                if not sync.degrade_on_collector_death:
                    raise
                _degrade()
                PIPELINE_GAUGES["sync_fallback_windows"] += 1
                for fn in run_fns:
                    fn()
                return 0.0

        def drain_pipeline() -> float:
            # with the pipeline empty every intent is settled: drop the
            # committed prefix so the journal stays O(pipeline_depth)
            if sync_degraded:
                if journal is not None:
                    journal.prune()
                return 0.0
            try:
                stall = collector.drain()
            except CollectorDied:
                if not sync.degrade_on_collector_death:
                    raise
                _degrade()
                return 0.0
            if journal is not None:
                journal.prune()
            return stall

        # epoch reset: every N blocks the session committer is rebuilt
        # from the last VALIDATED root, dropping the resolved-placeholder
        # map and all retained refs — replay memory stays O(epoch)
        epoch = self.session_epoch_blocks
        blocks_since_reset = 0

        def on_device():
            # stage threads name the replay's card explicitly (never the
            # thread's current device)
            if dev.type == "cuda":
                return torch.cuda.device(dev)
            return contextlib.nullcontext()

        def make_stage_jobs(cm: WindowCommitter, job, results, seal_tok,
                            intent_seq):
            # the four per-stage closures one window job flows through,
            # each on its own stage thread, strictly FIFO within a stage.
            # ``seal_tok`` (the driver's window.seal span id) rides the
            # closures across the queues, so each stage span is the
            # seal's child across threads (flow arrows in the Chrome
            # dump); the driver's tracer rides the same way — a stage
            # thread has no binding of its own
            lo, hi = results[0][0].number, results[-1][0].number
            tr = self.tracer

            def seal_fn():
                # pack scan + dispatch build + upload + K5 launch, while
                # the driver executes the next window; the journal intent
                # was written before this job existed and pack mutates
                # memory only. A rule at any collector.* seam models a
                # failure or death at that phase of the job. The ledger
                # phase stays "seal" so the cost model bills the
                # sub-phases to the seal family
                with use_tracer(tr):
                    fault_point("collector.seal")
                    with on_device():
                        t0 = time.perf_counter()
                        with span("window.pack", parent=seal_tok,
                                  block_lo=lo, block_hi=hi), \
                                LEDGER.context(window=lo, phase="seal"):
                            cm.pack_and_dispatch(job)
                        ph["seal_bg"] += time.perf_counter() - t0

            def collect_fn():
                with use_tracer(tr):
                    fault_point("collector.collect")
                    with on_device():
                        t0 = time.perf_counter()
                        with span("window.collect", parent=seal_tok,
                                  block_lo=lo, block_hi=hi), \
                                LEDGER.context(window=lo, phase="collect"):
                            # root checks fetch ONLY the per-block root
                            # digests (32 B x blocks); the live nodes
                            # land in the device mirror card to card
                            cm.collect_roots(job)  # raises WindowMismatch
                            cm.admit_mirror(job)
                        ph["collect_bg"] += time.perf_counter() - t0

            def persist_fn():
                with use_tracer(tr):
                    fault_point("collector.persist")
                    with on_device():
                        t0 = time.perf_counter()
                        with span("window.persist", parent=seal_tok,
                                  block_lo=lo, block_hi=hi,
                                  live=len(job.live)), \
                                LEDGER.context(window=lo, phase="persist"):
                            cm.persist(job)
                        ph["persist_bg"] += time.perf_counter() - t0

            def save_fn():
                with use_tracer(tr):
                    t0 = time.perf_counter()
                    n_blocks = txs = gas = 0
                    with span("window.save", parent=seal_tok,
                              block_lo=lo, block_hi=hi,
                              blocks=len(results)), \
                            LEDGER.context(window=lo, phase="save"):
                        for block, result in results:
                            td = (
                                self.blockchain.get_total_difficulty(
                                    block.number - 1
                                )
                                or 0
                            ) + block.header.difficulty
                            # world=None: the window persisted the nodes
                            t_save = time.perf_counter()
                            self.blockchain.save_block(
                                block, result.receipts, td, world=None
                            )
                            # host-side persistence: classification
                            # traffic for window_report, never a device
                            # crossing
                            LEDGER.record(
                                "block.save", HOST, 0,
                                duration=time.perf_counter() - t_save,
                            )
                            fault_point("collector.save")
                            n_blocks += 1
                            txs += result.stats.tx_count
                            gas += result.gas_used
                        # the commit mark is the job's LAST mutation: a
                        # window is durable only after persist + save
                        if intent_seq is not None:
                            fault_point("collector.commit")
                            journal.log_commit(intent_seq)
                        if JOURNEY.enabled:
                            # persist + save done, commit mark down: the
                            # crash-survivable point, the passport's
                            # durable page
                            for b, _r in results:
                                for stx in b.body.transactions:
                                    JOURNEY.record(
                                        stx.hash, "durable",
                                        block=b.header.number,
                                    )
                        if self.log is not None:
                            self.log(
                                f"Committed window [{lo}..{hi}] "
                                f"({len(results)} blocks) in one batched "
                                "device pass"
                            )
                        # stats land ONLY here, after the commit mark: a
                        # torn job re-run after a collector death stays
                        # idempotent
                        stats.blocks += n_blocks
                        stats.txs += txs
                        stats.gas += gas
                        for _, result in results:
                            stats.add_exec(result.stats)
                        LEDGER.note_blocks(n_blocks)
                    # the window is durable (best advanced, commit mark
                    # down): the committed store now serves same-or-newer
                    # state, so the read-view overlay lets go of it
                    if self.read_view is not None:
                        self.read_view.retire_through(hi)
                    ph["save_bg"] += time.perf_counter() - t0

            return (seal_fn, collect_fn, persist_fn, save_fn)

        def seal_and_submit() -> None:
            nonlocal results_cur, window_parent_root
            lo = results_cur[0][0].number
            hi = results_cur[-1][0].number
            t0 = time.perf_counter()
            intent_seq = None
            LEDGER.note_window(lo, lo, hi)
            with span("window.seal", block_lo=lo, block_hi=hi) as seal_sp, \
                    LEDGER.context(window=lo, phase="seal"):
                job = committer.seal()
                if JOURNEY.enabled:
                    for b, _r in results_cur:
                        for stx in b.body.transactions:
                            JOURNEY.record(stx.hash, "seal",
                                           window_lo=lo, window_hi=hi)
                if journal is not None:
                    # WAL barrier: the intent is durable BEFORE the job
                    # can run (submit enqueues it strictly afterwards)
                    j0 = time.perf_counter()
                    with span("seal.journal", block_lo=lo, block_hi=hi):
                        intent_seq = journal.log_intent(
                            lo, hi, window_parent_root,
                            [b.header.state_root for b, _ in results_cur],
                        )
                    # host-side classification event so the window
                    # report's seal row decomposes the journal's cost
                    LEDGER.record("seal.journal", HOST, 0,
                                  duration=time.perf_counter() - j0)
                    if JOURNEY.enabled:
                        # the intent is on disk: from here a crash
                        # replays the window forward
                        for b, _r in results_cur:
                            for stx in b.body.transactions:
                                JOURNEY.record(stx.hash, "journal.intent",
                                               seq=intent_seq)
                run_fns = make_stage_jobs(committer, job, results_cur,
                                          seal_sp.token, intent_seq)
            ph["seal"] += time.perf_counter() - t0
            with span("pipeline.stall", block_lo=lo, block_hi=hi,
                      kind="submit"):
                ph["collect"] += submit_job(run_fns)
                window_parent_root = results_cur[-1][0].header.state_root
                results_cur = []

        results_cur: List = []
        prev = parent
        try:
            for block in itertools.chain((first,), blocks):
                header = block.header
                with span("window.build", block=header.number,
                          txs=len(block.body.transactions)):
                    t0 = time.perf_counter()
                    # a no-op sweep when the prefetch thread already
                    # filled the per-object memos
                    with span("senders", block=header.number):
                        recover_block_senders(
                            block.body.transactions,
                            sync.sender_cache_entries,
                            sync.sender_batch_hash, dev,
                        )
                    ph["senders"] += time.perf_counter() - t0
                    if JOURNEY.enabled:
                        # passport ingress for imported txs: the first
                        # sighting wins, so a reorg re-import keeps the
                        # original stamp
                        for stx in block.body.transactions:
                            JOURNEY.record(stx.hash, "ingress",
                                           source="import",
                                           block=header.number)
                    t0 = time.perf_counter()
                    if self.validate_headers:
                        self.header_validator.validate(header, prev)
                    BlockValidator.validate_body(block)
                    OmmersValidator.validate(
                        self.blockchain, block,
                        header_lookup=window_headers_full.get,
                        block_lookup=window_blocks.get,
                        header_validator=(
                            self.header_validator
                            if self.validate_headers else None
                        ),
                    )
                    if not for_block(header.number,
                                     self.config.blockchain).byzantium:
                        raise WindowNeedsByzantium(
                            "window commits need Byzantium receipts "
                            "(pre-Byzantium receipts embed per-tx roots)"
                        )
                    ph["validate"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    with span("execute", block=header.number,
                              txs=len(block.body.transactions)):
                        result = execute_block(
                            block,
                            b"",  # the open session IS the parent state
                            committer.make_world,
                            self.config,
                            validate=True,
                            check_root=False,  # deferred to collect
                            # no pool thread may read through the mirror
                            exec_pool=mirror is None,
                            device=dev,
                        )
                    ph["execute"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    committer.commit_block(
                        result.world, header,
                        txs=([stx.hash for stx in block.body.transactions]
                             if JOURNEY.enabled else None),
                    )
                    window_headers[header.number] = header.hash
                    window_headers_full[header.number] = header
                    window_blocks[header.number] = block
                    results_cur.append((block, result))
                    prev = header
                    ph["commit"] += time.perf_counter() - t0
                if len(results_cur) >= window_size:
                    # NO barrier before seal: cross-window refs resolve
                    # from the in-flight jobs' device digests; the only
                    # wait is backpressure once pipeline_depth windows
                    # are queued
                    blocks_since_reset += len(results_cur)
                    seal_and_submit()
                    if blocks_since_reset >= epoch:
                        # drain, then restart the session from the last
                        # validated root (memory bound)
                        with span("pipeline.stall", kind="epoch-drain"):
                            ph["collect"] += drain_pipeline()
                        stats.persist_bytes += committer.persist_bytes
                        stats.persist_store_seconds += (
                            committer.persist_seconds
                        )
                        committer = make_committer(prev.state_root)
                        blocks_since_reset = 0
                        # ommers reach back 6 ancestors, BLOCKHASH 256
                        for d, keep in (
                            (window_headers, 260),
                            (window_headers_full, 8),
                            (window_blocks, 8),
                        ):
                            for n in sorted(d)[:-keep]:
                                del d[n]
            if results_cur:
                seal_and_submit()
            with span("pipeline.stall", kind="final-drain"):
                ph["collect"] += drain_pipeline()
        except BaseException:
            # a driver-side failure (validation, execution, or a
            # re-raised stage failure) aborts the pipeline: queued
            # windows are dropped WITHOUT persisting
            if prefetcher is not None:
                prefetcher.close()
            collector.kill()
            # un-durable overlay state dies with the windows that
            # produced it: reads fall back to the committed store
            if self.read_view is not None:
                self.read_view.invalidate_above(
                    self.blockchain.best_block_number
                )
            raise
        collector.close()
        if prefetcher is not None:
            prefetcher.close()
            ph["senders_bg"] += prefetcher.busy_seconds
        # every window is durable: free the last fused jobs' device
        # buffers (earlier retirees were freed at later packs)
        committer.drain_retired()
        stats.persist_bytes += committer.persist_bytes
        stats.persist_store_seconds += committer.persist_seconds
        stats.seconds = time.perf_counter() - t_start
        # overlap fraction: stage busy seconds NOT spent with the driver
        # blocked on them ((C - stall) / C)
        stall = ph["collect"]
        busy = collector.busy_seconds
        occ = max(0.0, min(1.0, (busy - stall) / busy)) if busy > 0 else 0.0
        stats.pipeline_occupancy = occ
        PIPELINE_GAUGES["occupancy"] = round(occ, 4)
        PIPELINE_GAUGES["driver_stall_s"] = round(stall, 3)
        return stats

    def _execute_and_insert(self, block: Block, stats: ReplayStats) -> None:
        header = block.header
        ph = stats.phases
        t0 = time.perf_counter()
        parent = self.blockchain.get_header_by_number(header.number - 1)
        if parent is None:
            raise ValueError(f"no parent for block {header.number}")
        # passport stamps for the per-block import path (live sync, the
        # reorg's adoption); a replica's tail re-execution runs under
        # use_node("replica:...") and stamps only its own visibility
        # page (serving/replica.py)
        journeys = JOURNEY.enabled and current_node() == "primary"
        if journeys:
            for stx in block.body.transactions:
                JOURNEY.record(stx.hash, "ingress", source="import",
                               block=header.number)
        if self.validate_headers:
            self.header_validator.validate(header, parent)
        BlockValidator.validate_body(block)
        OmmersValidator.validate(
            self.blockchain, block,
            header_validator=(
                self.header_validator if self.validate_headers else None
            ),
        )
        t1 = time.perf_counter()
        result = execute_block(
            block,
            parent.state_root,
            self.blockchain.get_world_state,
            self.config,
            validate=True,
            hasher=self.hasher,  # root check + persist share one flush
            device=self.device,
        )
        t2 = time.perf_counter()
        td = (
            self.blockchain.get_total_difficulty(parent.number) or 0
        ) + header.difficulty
        self.blockchain.save_block(
            block, result.receipts, td, result.world, hasher=self.hasher
        )
        if journeys:
            for stx in block.body.transactions:
                JOURNEY.record(stx.hash, "durable", block=header.number)
        t3 = time.perf_counter()
        commit = result.stats.commit_seconds
        ph["validate"] += t1 - t0
        ph["execute"] += t2 - t1 - commit
        ph["commit"] += commit
        ph["save"] += t3 - t2

        stats.blocks += 1
        stats.txs += result.stats.tx_count
        stats.gas += result.gas_used
        stats.add_exec(result.stats)

        if self.log is not None:
            # RegularSyncService.scala:429 one-line format
            ntx = result.stats.tx_count
            dt = t3 - t0
            self.log(
                f"Executed #{header.number} ({block.hash[:4].hex()}) "
                f"{ntx} txs in {dt * 1000:.1f}ms, "
                f"{ntx / dt if dt else 0:.1f} tx/s, "
                f"{result.gas_used / dt / 1e6 if dt else 0:.2f} mgas/s, "
                f"parallel {result.stats.parallel_rate * 100:.0f}%, "
                f"cache hit "
                f"{self.blockchain.storages.account_node_storage.cache_hit_rate * 100:.0f}%"
            )


def _timed_pull(prefetcher: SenderPrefetcher, phases: dict) -> Iterator[Block]:
    """Blocks off the prefetch queue, the wait billed to ``senders``: it
    is the part of sender recovery the background thread failed to
    hide."""
    it = iter(prefetcher)
    while True:
        t0 = time.perf_counter()
        with span("pipeline.stall", kind="prefetch"):
            try:
                block = next(it)
            except StopIteration:
                return
        phases["senders"] += time.perf_counter() - t0
        yield block
