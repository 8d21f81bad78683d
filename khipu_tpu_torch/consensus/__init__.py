"""Consensus: Ethash PoW (consensus/pow/ in the reference)."""

from khipu_tpu_torch.consensus.ethash import EthashCache, hashimoto_light, mine

__all__ = ["EthashCache", "hashimoto_light", "mine"]
