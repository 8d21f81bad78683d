"""Header/block structural validators.

Parity: validators/BlockHeaderValidator.scala:36 (difficulty, gas
limit/used, timestamp, number, extra-data :54-197 — PoW seal check is
pluggable and off by default, matching how fixture/replay chains are
driven) and BlockValidator.scala:19 (tx root :82, ommers hash :102,
receipts root :121, log bloom :142).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from khipu_tpu_torch.config import BlockchainConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.receipt import Receipt
from khipu_tpu_torch.ledger.bloom import bloom_union
from khipu_tpu_torch.validators.roots import (
    ommers_hash,
    receipts_root,
    transactions_root,
)

MAX_EXTRA_DATA = 32
GAS_LIMIT_BOUND_DIVISOR = 1024
MIN_GAS_LIMIT = 5000


class ValidationError(Exception):
    pass


class HeaderValidationError(ValidationError):
    pass


class BlockHeaderValidator:
    """Structural + parent-linked header checks. ``seal_check`` is a
    hook for a PoW validator (consensus/pow) — None skips seal
    validation (fixture chains, fast sync headers-only mode)."""

    def __init__(
        self,
        bc: BlockchainConfig,
        difficulty_fn: Optional[Callable[[BlockHeader, BlockHeader], int]] = None,
        seal_check: Optional[Callable[[BlockHeader], bool]] = None,
    ):
        self.bc = bc
        self.difficulty_fn = difficulty_fn
        self.seal_check = seal_check

    def validate(self, header: BlockHeader, parent: BlockHeader) -> None:
        if header.number != parent.number + 1:
            raise HeaderValidationError(
                f"number {header.number} != parent+1 ({parent.number + 1})"
            )
        if header.parent_hash != parent.hash:
            raise HeaderValidationError("parent hash mismatch")
        if len(header.extra_data) > MAX_EXTRA_DATA:
            raise HeaderValidationError("extra data > 32 bytes")
        if header.unix_timestamp <= parent.unix_timestamp:
            raise HeaderValidationError("timestamp not after parent")
        if header.gas_used > header.gas_limit:
            raise HeaderValidationError("gasUsed > gasLimit")
        limit_delta = abs(header.gas_limit - parent.gas_limit)
        if limit_delta >= parent.gas_limit // GAS_LIMIT_BOUND_DIVISOR:
            raise HeaderValidationError("gas limit delta out of bounds")
        if header.gas_limit < MIN_GAS_LIMIT:
            raise HeaderValidationError("gas limit below minimum")
        marker = self.bc.dao_fork_extra_data
        if marker is not None and (
            self.bc.dao_fork_block_number
            <= header.number
            < self.bc.dao_fork_block_number
            + self.bc.dao_fork_extra_data_range
        ):
            # pro-fork consensus rule (geth PR#2814): the first N
            # blocks after the DAO fork must carry the marker exactly
            if header.extra_data != marker:
                raise HeaderValidationError(
                    "missing dao-hard-fork extra data in fork window"
                )
        if self.difficulty_fn is not None:
            expected = self.difficulty_fn(header, parent)
            if header.difficulty != expected:
                raise HeaderValidationError(
                    f"difficulty {header.difficulty} != calculated {expected}"
                )
        if self.seal_check is not None and not self.seal_check(header):
            raise HeaderValidationError("invalid PoW seal")


class OmmersValidator:
    """Ommer consensus rules (validators/OmmersValidator.scala): at most
    2 ommers, no duplicates, each a valid header whose parent is an
    ancestor of the including block within 6 generations, none equal to
    an ancestor, none already included by a recent block."""

    MAX_OMMERS = 2
    GENERATION_LIMIT = 6

    @staticmethod
    def validate(blockchain, block: Block, header_lookup=None,
                 block_lookup=None, header_validator=None) -> None:
        """``header_lookup(n)``/``block_lookup(n)`` override the chain
        DB for blocks not yet persisted (an open commit window validates
        blocks whose parents live only in the window);
        ``header_validator`` additionally validates each ommer header
        against its parent (the Scala OmmersValidator runs the full
        BlockHeaderValidator on ommers)."""
        ommers = block.body.ommers
        if not ommers:
            return
        if len(ommers) > OmmersValidator.MAX_OMMERS:
            raise ValidationError(f"{len(ommers)} ommers > 2")
        if len({o.hash for o in ommers}) != len(ommers):
            raise ValidationError("duplicate ommers")

        def get_header(num):
            if header_lookup is not None:
                h = header_lookup(num)
                if h is not None:
                    return h
            return blockchain.get_header_by_number(num)

        def get_block(num):
            if block_lookup is not None:
                b = block_lookup(num)
                if b is not None:
                    return b
            return blockchain.get_block_by_number(num)

        # ancestors of the including block (hashes + headers), depth 7,
        # collected by WALKING parent_hash links — the block may sit on
        # a non-canonical branch, so looking up the canonical header at
        # each height would check the wrong lineage (the reference walks
        # getNBlocksBack from the block's parent)
        n = block.number
        ancestors = {}
        lineage: List[BlockHeader] = []
        cur_hash = block.header.parent_hash
        cur_num = n - 1
        for _depth in range(1, OmmersValidator.GENERATION_LIMIT + 2):
            if cur_num < 0:
                break
            h = None
            cand = get_header(cur_num)
            if cand is not None and cand.hash == cur_hash:
                h = cand
            else:
                by_hash = getattr(blockchain, "get_header_by_hash", None)
                if by_hash is not None:
                    h = by_hash(cur_hash)
            if h is None:
                break
            ancestors[h.hash] = h
            lineage.append(h)
            cur_hash = h.parent_hash
            cur_num -= 1
        # ommers already included by recent blocks ON THIS LINEAGE
        # (bodies whose stored block no longer matches the lineage
        # header are skipped, not trusted)
        seen = set()
        for h in lineage[: OmmersValidator.GENERATION_LIMIT]:
            b = get_block(h.number)
            if b is None or b.hash != h.hash:
                continue
            for o in b.body.ommers:
                seen.add(o.hash)

        for o in ommers:
            if o.hash in ancestors or o.hash == block.hash:
                raise ValidationError("ommer is an ancestor")
            if o.hash in seen:
                raise ValidationError("ommer already included")
            if not 0 < n - o.number <= OmmersValidator.GENERATION_LIMIT:
                raise ValidationError(
                    f"ommer depth {n - o.number} outside 1..6"
                )
            parent = ancestors.get(o.parent_hash)
            if parent is None:
                raise ValidationError(
                    "ommer's parent is not a recent ancestor"
                )
            if o.number != parent.number + 1:
                raise ValidationError(
                    f"ommer number {o.number} != parent+1 "
                    f"({parent.number + 1})"
                )
            if header_validator is not None:
                try:
                    header_validator.validate(o, parent)
                except HeaderValidationError as e:
                    raise ValidationError(f"invalid ommer header: {e}")


class BlockValidator:
    """Body-vs-header consistency (BlockValidator.scala:19)."""

    @staticmethod
    def validate_body(block: Block) -> None:
        header = block.header
        troot = transactions_root(block.body.transactions)
        if troot != header.transactions_root:
            raise ValidationError(
                f"tx root {troot.hex()} != header "
                f"{header.transactions_root.hex()}"
            )
        ohash = ommers_hash(block.body.ommers)
        if ohash != header.ommers_hash:
            raise ValidationError("ommers hash mismatch")

    @staticmethod
    def validate_receipts(
        header: BlockHeader, receipts: Sequence[Receipt]
    ) -> None:
        rroot = receipts_root(receipts)
        if rroot != header.receipts_root:
            raise ValidationError(
                f"receipts root {rroot.hex()} != header "
                f"{header.receipts_root.hex()}"
            )
        bloom = bloom_union(r.logs_bloom for r in receipts)
        if bloom != header.logs_bloom:
            raise ValidationError("log bloom mismatch")
