"""khipu_tpu_torch: the PyTorch/CUDA port of khipu_tpu for NVIDIA Hopper.

This package imports ``torch`` and ``numpy`` and nothing of JAX or of
the ``khipu_tpu`` reference package; it carries its own copies of what
it needs. Layout mirrors the reference so each module's counterpart is
found by name:

* ``base/``    bytes, nibbles, RLP, the scalar Keccak oracle
* ``domain/``  the account record
* ``storage/`` the in-memory node store
* ``ops/``     batched Keccak-256: plain PyTorch sponge + CUDA kernels
               K1r (ragged batches) and K1f (rows of one length)
* ``trie/``    host MPT, bulk build, deferred commit, the fused
               fixpoint (kernel K5)
* ``state.py`` carries the JAX package's node dict into the port

Entry points take ``device=None``, meaning ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.
"""
