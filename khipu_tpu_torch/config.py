"""Configuration tree — one dataclass hierarchy for the whole node.

The port's copy of ``khipu_tpu.config``, every default the same, cut to
the fields the port reads: the chain's fork schedule, the replay's
sync knobs (serial, optimistic and scheduled execution, the execute
stage's device validation, the windowed commit pipeline, the commit
journal and the adaptive controller), the storage engine
(``DbConfig``: engine, directory, cache size and the reorg depth limit,
read by ``ServiceBoard``), the observability plane
(``ObservabilityConfig``) and the serving plane (``ServingConfig``). A
section or field comes back with the module that reads it.

Parity: config/KhipuConfig.scala:20-120 (nested Network/Sync/Db accessor
objects over HOCON) and BlockchainConfig :185 (fork block numbers,
chainId, accountStartNonce, monetary policy). HOCON cake traits become
plain frozen dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

FAR = 1 << 62  # "fork not scheduled" sentinel block number


@dataclass(frozen=True)
class MonetaryPolicy:
    """Block reward eras (BlockRewardCalculator.scala:11 — ETH forks)."""

    frontier_reward: int = 5 * 10**18
    byzantium_reward: int = 3 * 10**18  # EIP-649
    constantinople_reward: int = 2 * 10**18  # EIP-1234


@dataclass(frozen=True)
class BlockchainConfig:
    """Fork schedule + chain constants (BlockchainConfig, KhipuConfig.scala:185).

    Defaults are Ethereum mainnet numbers; fixtures construct compressed
    schedules (e.g. all forks at 0) for targeted testing.
    """

    chain_id: int = 1
    account_start_nonce: int = 0
    # fork activation block numbers
    homestead_block: int = 1_150_000
    eip150_block: int = 2_463_000
    eip155_block: int = 2_675_000  # also EIP-160/161 (Spurious Dragon)
    eip160_block: int = 2_675_000
    eip161_block: int = 2_675_000
    # one-block mainnet patch: blocks where EIP-161 state clearing was
    # retro-disabled (EvmConfig.scala:111-118 eip161PatchBlockNumber)
    eip161_patch_block: int = FAR
    eip170_block: int = 2_675_000  # max code size
    byzantium_block: int = 4_370_000
    constantinople_block: int = 7_280_000
    petersburg_block: int = 7_280_000
    istanbul_block: int = 9_069_000
    # DAO hard fork (KhipuConfig.scala:219-220 dao-fork-block-number/
    # hash; ForkResolver.scala:18-31). The hash is OUR side's block at
    # the fork height — defaults are the pro-fork (ETH) mainnet side.
    dao_fork_block_number: int = 1_920_000
    dao_fork_block_hash: Optional[bytes] = bytes.fromhex(
        "4985f5ca3d2afbec36529aa96f74de3cc10a2a4a6c44f2157a57d2c6059a11bb"
    )
    # pro-fork consensus rule (geth PR#2814): blocks in
    # [fork, fork + range) must carry exactly this extraData. None
    # disables the rule (the contra-fork side instead REJECTS it).
    dao_fork_extra_data: Optional[bytes] = bytes.fromhex(
        "64616f2d686172642d666f726b"  # "dao-hard-fork"
    )
    dao_fork_extra_data_range: int = 10
    # irregular state change at the fork block: each drain address's
    # full balance moves into the refund contract before any tx runs.
    # NOTE: the canonical mainnet list (116 child-DAO addresses ->
    # 0xbf4ed7b2...) is chain data that must be provisioned by the
    # operator; with an empty list a mainnet replay stops AT the fork
    # block with a state-root mismatch rather than silently diverging.
    dao_drain_list: tuple = ()  # 20-byte addresses
    dao_refund_contract: Optional[bytes] = None
    # difficulty-bomb rewind schedule (DifficultyCalculator.scala:17):
    # (activation_block, total_rewind) pairs, cumulative per EIP-649
    # (-3M), EIP-1234 (-5M), EIP-2384 (-9M); the largest activated
    # rewind applies
    bomb_delays: tuple = (
        (4_370_000, 3_000_000),
        (7_280_000, 5_000_000),
        (9_200_000, 9_000_000),
    )
    bomb_defuse_block: int = FAR
    monetary_policy: MonetaryPolicy = field(default_factory=MonetaryPolicy)
    max_code_size: int = 24_576  # EIP-170


@dataclass(frozen=True)
class DbConfig:
    """Engine selection (DbConfig.scala:5-19): the values here are the
    engines Storages dispatches on; ``ServiceBoard`` opens its stores
    from them. ``unconfirmed_depth`` bounds the unconfirmed ring,
    beyond which sync/reorg.py refuses a chain switch."""

    engine: str = "memory"  # memory | native | sqlite | kesque
    data_dir: Optional[str] = None
    cache_size: int = 1 << 20  # node FIFO cache entries (cache-size)
    unconfirmed_depth: int = 20  # block-resolving-depth reorg ring


@dataclass(frozen=True)
class SyncConfig:
    """Replay/sync knobs (KhipuConfig.Sync)."""

    # regular sync's backward branch walk cap (RegularSyncService.scala)
    block_resolving_depth: int = 20
    # parallel execution of a block's transactions: the scheduled
    # executor (below) for Byzantium+ blocks, else the optimistic pass
    # with its serial merge (P1). False = the serial fold
    parallel_tx: bool = True
    tx_workers: int = 8  # worker pool width (TxProcessor.scala:29 role)
    # conflict-aware scheduled execution (ledger/schedule.py): predict
    # read/write sets, pack disjoint batches, vectorize plain-transfer
    # batches (ledger/batch_exec.py), serial residue for everything
    # unpredictable; mispredictions fall back to the optimistic path
    # whole-block. False = always optimistic (the P1 oracle). Only
    # engages for Byzantium+ blocks (pre-Byzantium receipts embed
    # intermediate roots, which forbid out-of-order execution)
    scheduled_tx: bool = True
    # pipelined sender recovery (sync/prefetch.py): a prefetch thread
    # recovers senders for upcoming blocks while the driver executes
    # the current block, with a process-wide (preimage, v, r, s) ->
    # sender cache so re-imports/reorgs never pay recovery twice
    sender_prefetch: bool = True
    sender_prefetch_depth: int = 8  # blocks buffered ahead of driver
    sender_cache_entries: int = 65536  # LRU cap (~100 B/entry)
    # batch the per-tx signing-hash keccaks through ops.keccak when the
    # replay runs on the card (one K1r launch per block instead of N
    # host hashes). Host keccak is native C, so with device="cpu" this
    # knob is a no-op
    sender_batch_hash: bool = True
    # fast-sync pivot choice (FastSyncService.scala:184-273 role)
    min_peers_to_choose_pivot: int = 5
    pivot_block_offset: int = 500  # pivot = median(best) - offset
    # node-download scheduler (processDownload:537-667 role)
    nodes_per_request: int = 50
    peer_request_timeout: float = 5.0
    commit_window_blocks: int = 1  # blocks batched per device trie commit
    # windows sealed-but-uncollected allowed in flight: the driver
    # seals window N+1 (cross-window refs ride the dispatch as
    # resolved-input tiles) while the background collector checks roots
    # and persists window N. 1 = seal/collect lockstep, still off the
    # driver thread
    pipeline_depth: int = 2
    # write-ahead window-commit journal (sync/journal.py): an intent
    # record lands before the background collector's first mutation, a
    # commit mark after best advances
    commit_journal: bool = True
    # a dead collector thread (detected by liveness checks in
    # submit/drain) degrades the driver to synchronous commits instead
    # of aborting the replay; False = abort with CollectorDied
    degrade_on_collector_death: bool = True
    # close()/kill() raise/warn when the worker outlives this join
    collector_join_timeout: float = 60.0
    # device-resident window commit (storage/device_mirror.py): the
    # collect stage admits the window's live nodes into the device
    # mirror card-to-card and only the async persist stage spills them
    # to host storage — the collect stage's device-to-host traffic is
    # the 32 B/block root fetch. Requires device_commit
    device_mirror_commit: bool = True
    # mirror ring capacity in rows per size class (1024-row multiples)
    mirror_capacity_rows: int = 16384
    # cost-model-adaptive commit (sync/adaptive.py): an EWMA controller
    # over the per-window seal cost falls device_mirror_commit back to
    # the host hasher when the device path is slower than the host.
    # device_mirror_commit stays the CAP — adaptive only ever downgrades
    # device -> host. Off by default here (on in the JAX package): on
    # the H100 its probe and trigger read launch noise and moved whole
    # replays to the host hasher at half the speed (PERF.md)
    adaptive_commit: bool = False
    # one-shot backend probe at controller construction: time a
    # card-to-card gather against the equivalent host memcpy; device
    # mode engages only when the card wins by adaptive_d2d_margin.
    # False skips the probe
    adaptive_probe: bool = True
    adaptive_d2d_margin: float = 1.5
    # execute-stage device dispatch: ship the gathered account rows of
    # the scheduled executor's fast-path batches through the row
    # validation kernel (trie/fused.py fused_exec_validate, K6 on the
    # card). Opt-in CAP like device_mirror_commit — even when True the
    # dispatch engages only where the adaptive probe shows real device
    # memory (d2d beats memcpy by adaptive_d2d_margin), or where
    # adaptive_probe is False. Off, the host numpy pass validates the
    # rows; on, a device error stops the block (no host fallback)
    exec_device: bool = False
    # EWMA smoothing over per-window per-hash seal cost observations
    adaptive_ewma_alpha: float = 0.4
    # Schmitt trigger: flip device -> host when the device EWMA
    # exceeds flip_ratio x the host estimate; flip back only below
    # flip_back_ratio x (hysteresis band kills oscillation)
    adaptive_flip_ratio: float = 2.0
    adaptive_flip_back_ratio: float = 0.5
    # windows a new mode must dwell before the controller may flip
    # again (flap suppression)
    adaptive_dwell_windows: int = 6
    # opcode-level trace for ONE block number (debug-trace-at;
    # VM.scala:40-57) — that block runs sequentially with a per-op line
    debug_trace_at: Optional[int] = None


@dataclass(frozen=True)
class ObservabilityConfig:
    """Flight recorder (observability/ package).

    ``enabled=False`` (the default) keeps every ``span(...)`` seam an
    attribute load + branch returning an inert singleton: bit-exact
    identical replay behavior, no recording. Enabling sizes the
    lock-light drop-oldest ring that trace.py records into. (The JAX
    package's ``compile_cache_capacity`` and ``chrome_trace_path`` have
    no reader in the port: it has no fused compile cache, and no bench
    or service that dumps a trace on its own.)"""

    enabled: bool = False
    ring_capacity: int = 65536  # spans retained (drop-oldest beyond)
    # head-based per-trace-id sampling: keep N in 10_000 traces, decided
    # deterministically from the trace id (trace.trace_sampled).
    # 10_000 (default) keeps everything
    sample_per_10k: int = 10_000
    # data-movement ledger (observability/profiler.py): per-site
    # host<->device transfer accounting behind khipu_device_transfer_*
    # and window_report(n). Off by default — same zero-cost contract as
    # the tracer
    ledger_enabled: bool = False
    ledger_capacity: int = 65536  # transfer events retained
    # per-transaction lineage plane (observability/journey.py — the
    # "tx passport"): bounded per-tx lifecycle event records keyed by
    # tx hash. Same zero-cost contract: off by default, every seam one
    # attribute load + branch
    journey_enabled: bool = False
    journey_capacity: int = 4096  # happy-path journeys (drop-oldest)
    journey_pinned_capacity: int = 1024  # tail-retained journeys
    # deterministic head-sampling in the tx hash (journey_sampled):
    # keep N in 10_000 happy-path journeys; pinned classes (shed,
    # mispredicted, retracted, rolled-back, slow) always tracked
    journey_sample_per_10k: int = 10_000
    journey_max_events: int = 64  # per-journey event cap
    # ingress->durable beyond this budget pins the journey (slow tail)
    journey_slow_ms: float = 250.0


@dataclass(frozen=True)
class ServingConfig:
    """Serving plane (serving/ package): SLO-aware admission control +
    read-your-writes view between the JSON-RPC server and the
    sync/storage stack.

    The plane is opt-in (``ServiceBoard.start_serving``); a bare
    ``JsonRpcServer`` keeps the zero-overhead direct-dispatch path.
    Per-class concurrency limits adapt by AIMD around the latency
    targets; pressure signals (window-pipeline occupancy, commit-journal
    depth, txpool fill, replica lag) shed work class-by-class before
    queues melt (Welsh's SEDA staged admission; Dean & Barroso's
    p99-first SLO)."""

    # JSON-RPC surface hardening (jsonrpc/server.py)
    max_batch: int = 100  # requests per batch array
    max_body_bytes: int = 2 << 20  # HTTP request body cap
    # installed filters not polled within this TTL are evicted
    # (jsonrpc/filters.py; geth's 5-minute deadline)
    filter_ttl: float = 300.0
    # bounded admission queue: a request waits at most this long for a
    # concurrency slot, and at most ``max_queue`` requests wait per
    # class — beyond either bound it is shed with -32005
    queue_timeout: float = 0.25
    max_queue: int = 64
    # AIMD concurrency limiter (admission.py): additive increase per
    # under-target completion, multiplicative decrease (x beta) per
    # over-target completion, at most once per ``decrease_cooldown``
    aimd_beta: float = 0.7
    decrease_cooldown: float = 0.1
    # pressure level in [0,1] at which each cost class starts shedding
    # (writes go first, cheap reads last); >1 disables pressure sheds
    shed_write_at: float = 0.85
    shed_execute_at: float = 0.90
    shed_read_at: float = 0.95
    # SLO objective: fraction of requests that must be admitted and
    # answered without an internal error (error-budget readout)
    objective: float = 0.999
    # replica fleet (serving/replica.py + serving/fleet.py): a follower
    # past this many committed blocks behind the primary saturates the
    # replica_lag pressure signal, so its read class sheds instead of
    # serving stale state
    max_replica_lag_blocks: int = 16
    # consistent-read wait-or-redirect budget: a token-bearing read
    # waits at most this long for the picked replica's tail to reach
    # the token height before redirecting to the primary
    ryw_wait_s: float = 0.05
    # follower tail pacing: idle poll interval and the per-pass block
    # batch bound (a far-behind replica catches up in bounded slices
    # so lag stays an honest signal)
    replica_poll_interval: float = 0.02
    replica_batch_blocks: int = 64


@dataclass(frozen=True)
class KhipuConfig:
    blockchain: BlockchainConfig = field(default_factory=BlockchainConfig)
    db: DbConfig = field(default_factory=DbConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )
    serving: ServingConfig = field(default_factory=ServingConfig)


def fixture_config(
    chain_id: int = 1, fork_block: int = 0, **overrides
) -> KhipuConfig:
    """A compressed schedule with every fork active from ``fork_block`` —
    what fixture chains use so modern semantics apply from genesis."""
    kwargs = dict(
        chain_id=chain_id,
        homestead_block=fork_block,
        eip150_block=fork_block,
        eip155_block=fork_block,
        eip160_block=fork_block,
        eip161_block=fork_block,
        eip170_block=fork_block,
        byzantium_block=fork_block,
        constantinople_block=fork_block,
        petersburg_block=fork_block,
        istanbul_block=fork_block,
        bomb_delays=((fork_block, 3_000_000),),
    )
    kwargs.update(overrides)
    return KhipuConfig(blockchain=BlockchainConfig(**kwargs))
