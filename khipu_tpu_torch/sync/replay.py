"""Regular-sync replay driver: feed blocks through execution, gate every
root, keep the per-block perf line.

Parity: blockchain/sync/RegularSyncService.scala:43 —
executeAndInsertBlocks:381 (serial fold), executeAndInsertBlock:405
(validate -> execute -> save), and the one-line per-block perf report
:429. Networking is replaced by a block source (another Blockchain, or
decoded RLP blocks).

The port's counterpart of ``khipu_tpu.sync.replay`` at
``commit_window_blocks=1``: every block is executed, its dirty trie
nodes hashed through the driver's hasher (``device_commit``: one K1r
launch a trie level on the card) and checked against the header's state
root by the post-execution gate and by ``save_block``. The windowed
pipeline (``commit_window_blocks > 1``), the chaos ``fault_point`` hooks
and the transaction passport are not ported yet (ROADMAP).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Optional

from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.domain.difficulty import calc_difficulty
from khipu_tpu_torch.ledger.ledger import execute_block
from khipu_tpu_torch.sync.prefetch import SenderPrefetcher
from khipu_tpu_torch.trie.bulk import device_hasher
from khipu_tpu_torch.validators.validators import (
    BlockHeaderValidator,
    BlockValidator,
    OmmersValidator,
)

# the driver thread's wall clock, split; they add up to the replay's
# seconds but for the loop's own bookkeeping
PHASES = ("senders", "validate", "execute", "commit", "save")


@dataclass
class ReplayStats:
    blocks: int = 0
    txs: int = 0
    gas: int = 0
    seconds: float = 0.0
    # per-phase wall-clock split (seconds) of the driver thread:
    # senders (waiting on the prefetcher; without it, execute_block
    # recovers them inside execute), validate (header, body and ommer
    # checks, with the host-hashed transaction root), execute (the
    # serial fold, rewards, receipts root), commit (the state-root flush: the block's dirty
    # trie nodes hashed a level at a time), save (persist the flushed
    # nodes and the block stores). ``senders_bg`` is the prefetch
    # thread's busy time, which overlaps the others.
    phases: dict = field(default_factory=dict)

    @property
    def blocks_per_s(self) -> float:
        return self.blocks / self.seconds if self.seconds else 0.0

    def phase_line(self) -> dict:
        return {k: round(v, 3) for k, v in self.phases.items()}


class ReplayDriver:
    """Executes a stream of blocks against a target chain DB.

    ``device=None`` means the card: with ``device_commit`` every block's
    trie commit hashes there (``device_hasher`` bound to it), and the
    sender prefetcher batches each block's signing hashes there when
    ``sync.sender_batch_hash`` is on. ``device="cpu"`` runs the plain
    versions. Without ``device_commit`` the commit is the host fold.
    """

    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        log: Optional[Callable[[str], None]] = None,
        validate_headers: bool = True,
        device_commit: bool = False,
        device=None,
    ):
        self.blockchain = blockchain
        self.config = config
        self.log = log
        self.device = resolve_device(device)
        self.header_validator = BlockHeaderValidator(
            config.blockchain,
            difficulty_fn=lambda h, p: calc_difficulty(
                h.unix_timestamp, p, config.blockchain
            ),
        )
        self.validate_headers = validate_headers
        # save_block's persisted-root == header.state_root check gates
        # the device commit on every block
        if device_commit:
            self.hasher = functools.partial(device_hasher, device=self.device)
        else:
            self.hasher = None

    def replay(self, blocks: Iterable[Block]) -> ReplayStats:
        """executeAndInsertBlocks: serial fold with full validation."""
        sync = self.config.sync
        if sync.commit_window_blocks > 1:
            raise NotImplementedError(
                "commit_window_blocks > 1 needs the windowed pipeline "
                "(ledger/window.py, the window collector, the journal and "
                "the mirror commit), which khipu_tpu_torch has not ported "
                "yet (ROADMAP A: the next slice); use 1"
            )
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
            for block in source:
                self._execute_and_insert(block, stats)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if prefetcher is not None:
            stats.phases["senders_bg"] = prefetcher.busy_seconds
        stats.seconds = time.perf_counter() - t_start
        return stats

    def _execute_and_insert(self, block: Block, stats: ReplayStats) -> None:
        header = block.header
        ph = stats.phases
        t0 = time.perf_counter()
        parent = self.blockchain.get_header_by_number(header.number - 1)
        if parent is None:
            raise ValueError(f"no parent for block {header.number}")
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
        )
        t2 = time.perf_counter()
        td = (
            self.blockchain.get_total_difficulty(parent.number) or 0
        ) + header.difficulty
        self.blockchain.save_block(
            block, result.receipts, td, result.world, hasher=self.hasher
        )
        t3 = time.perf_counter()
        commit = result.stats.commit_seconds
        ph["validate"] += t1 - t0
        ph["execute"] += t2 - t1 - commit
        ph["commit"] += commit
        ph["save"] += t3 - t2

        stats.blocks += 1
        stats.txs += result.stats.tx_count
        stats.gas += result.gas_used

        if self.log is not None:
            # RegularSyncService.scala:429 one-line format
            ntx = result.stats.tx_count
            dt = t3 - t0
            self.log(
                f"Executed #{header.number} ({block.hash[:4].hex()}) "
                f"{ntx} txs in {dt * 1000:.1f}ms, "
                f"{ntx / dt if dt else 0:.1f} tx/s, "
                f"{result.gas_used / dt / 1e6 if dt else 0:.2f} mgas/s, "
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
        try:
            block = next(it)
        except StopIteration:
            return
        phases["senders"] += time.perf_counter() - t0
        yield block
