"""Miner/ommer block rewards (ledger/BlockRewardCalculator.scala:11 —
ETH fork schedule: 5 ETH Frontier, 3 ETH Byzantium/EIP-649, 2 ETH
Constantinople/EIP-1234; ommer gets (8 + ommerNum - blockNum)/8 of the
base reward, miner +1/32 per ommer)."""

from __future__ import annotations

from typing import List, Tuple

from khipu_tpu_torch.config import BlockchainConfig


def base_reward(number: int, bc: BlockchainConfig) -> int:
    mp = bc.monetary_policy
    if number >= bc.constantinople_block:
        return mp.constantinople_reward
    if number >= bc.byzantium_block:
        return mp.byzantium_reward
    return mp.frontier_reward


def block_rewards(
    number: int, ommer_numbers: List[int], bc: BlockchainConfig
) -> Tuple[int, List[int]]:
    """(miner_reward, [per-ommer rewards])."""
    base = base_reward(number, bc)
    miner = base + (base // 32) * len(ommer_numbers)
    ommers = [
        base * (8 + on - number) // 8 if 0 < number - on <= 6 else 0
        for on in ommer_numbers
    ]
    return miner, ommers
