"""Primitives layer: bytes, nibbles, RLP and the scalar Keccak oracle.

The port's own copies of ``khipu_tpu.base`` — the port imports nothing
of the JAX package, so it carries what it needs.
"""

# keccak256(b"") — ubiquitous sentinel (empty account code hash).
EMPTY_KECCAK = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
)
# keccak256(rlp(b"")) — root hash of an empty Merkle Patricia Trie.
EMPTY_TRIE_HASH = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)
