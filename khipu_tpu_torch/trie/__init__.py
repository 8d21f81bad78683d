"""Merkle Patricia Trie: host MPT, bulk build, deferred commit and the
fused fixpoint (K1 + K2 on the card, the plain versions on the CPU)."""

from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH, MerklePatriciaTrie
from khipu_tpu_torch.trie.bulk import bulk_build

__all__ = ["EMPTY_TRIE_HASH", "MerklePatriciaTrie", "bulk_build"]
