"""Difficulty calculator — fork-aware + bomb delays
(domain/DifficultyCalculator.scala:17).

Frontier: parent ± parent/2048 by a 13s timestamp gate.
Homestead (EIP-2): sigma = max(1 - (ts - parent_ts)//10, -99).
Byzantium (EIP-100): ommer-aware sigma = max((2|1) - (ts-parent_ts)//9, -99),
plus the exponential bomb with the EIP-649/1234/2384 rewind schedule
from BlockchainConfig.bomb_delays (largest activated rewind applies;
bomb_defuse_block removes the bomb entirely).
"""

from __future__ import annotations

from khipu_tpu_torch.config import BlockchainConfig
from khipu_tpu_torch.domain.block_header import EMPTY_OMMERS_HASH, BlockHeader

MIN_DIFFICULTY = 131_072
EXP_PERIOD = 100_000


def calc_difficulty(
    timestamp: int, parent: BlockHeader, bc: BlockchainConfig
) -> int:
    number = parent.number + 1
    adj = parent.difficulty // 2048
    dt = timestamp - parent.unix_timestamp

    if number >= bc.byzantium_block:
        has_ommers = parent.ommers_hash != EMPTY_OMMERS_HASH
        sigma = max((2 if has_ommers else 1) - dt // 9, -99)
        diff = parent.difficulty + adj * sigma
    elif number >= bc.homestead_block:
        sigma = max(1 - dt // 10, -99)
        diff = parent.difficulty + adj * sigma
    else:
        diff = parent.difficulty + (adj if dt < 13 else -adj)

    diff = max(diff, MIN_DIFFICULTY)

    # difficulty bomb: 2^(fake_number/100000 - 2), with the fake block
    # number rewound by the largest activated scheduled delay
    if number >= bc.bomb_defuse_block:
        return diff
    rewind = 0
    for at_block, delay in bc.bomb_delays:
        if number >= at_block:
            rewind = max(rewind, delay)
    fake_number = max(number - rewind, 0)
    period = fake_number // EXP_PERIOD
    if period >= 2:
        diff += 2 ** (period - 2)
    return max(diff, MIN_DIFFICULTY)
