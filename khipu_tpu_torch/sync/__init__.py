"""Sync: the fast-sync state download (``fast_sync``), the regular-sync
replay driver (``replay``), sender prefetch and the fixture chain
builder."""

from khipu_tpu_torch.sync.chain_builder import ChainBuilder
from khipu_tpu_torch.sync.replay import ReplayDriver

__all__ = ["ChainBuilder", "ReplayDriver"]
