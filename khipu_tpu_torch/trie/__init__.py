"""Merkle Patricia Trie: host MPT, bulk build, deferred commit and the
fused fixpoint (K5 on the card, its plain version on the CPU)."""

from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH, MerklePatriciaTrie
from khipu_tpu_torch.trie.bulk import bulk_build

__all__ = ["EMPTY_TRIE_HASH", "MerklePatriciaTrie", "bulk_build"]
