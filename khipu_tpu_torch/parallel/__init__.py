"""Multi-card parallelism: the device mesh, sharded hashing and
verification, and the sharded window finalize.

The counterpart of ``khipu_tpu/parallel/``. The JAX package shards node
batches over a ``jax.sharding.Mesh`` with XLA collectives over ICI; the
port runs one process a rank over ``torch.distributed`` (NCCL between
cards, gloo on the CPU) around the one-card kernels:

* hash a level's nodes sharded across ranks (K1f, K1r on a share),
* ``all_gather`` the level's digests so every rank can resolve parent
  references (the bulk build's level boundary, the sharded fixpoint),
* ``all_reduce`` the mismatch counts of a snapshot verify (config #5).

``python -m khipu_tpu_torch.parallel`` under ``torchrun`` drives them
all (parallel/__main__.py).
"""

from khipu_tpu_torch.parallel.mesh import Mesh, device_mesh
from khipu_tpu_torch.parallel.keccak_sharded import (
    hash_level_all_gather,
    keccak256_batch_sharded,
    keccak256_fixed_sharded,
    sharded_hasher,
    snapshot_verify_sharded,
)
from khipu_tpu_torch.parallel.fused_sharded import fused_resolve_sharded

__all__ = [
    "Mesh",
    "device_mesh",
    "fused_resolve_sharded",
    "hash_level_all_gather",
    "keccak256_batch_sharded",
    "keccak256_fixed_sharded",
    "sharded_hasher",
    "snapshot_verify_sharded",
]
