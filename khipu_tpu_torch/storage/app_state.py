"""Application state keys.

Parity: khipu-eth/.../storage/AppStateStorage.scala:8-15 — keys
BestBlockNumber / FastSyncDone / EstimatedHighestBlock /
SyncStartingBlock / LastPrunedBlock over a KeyValueDataSource.

The port's copy of ``khipu_tpu.storage.app_state`` (no JAX there, but the port imports
nothing of the reference package).
"""

from __future__ import annotations

from typing import Optional


class AppStateStorage:
    BEST_BLOCK_NUMBER = b"BestBlockNumber"
    FAST_SYNC_DONE = b"FastSyncDone"
    ESTIMATED_HIGHEST_BLOCK = b"EstimatedHighestBlock"
    SYNC_STARTING_BLOCK = b"SyncStartingBlock"
    LAST_PRUNED_BLOCK = b"LastPrunedBlock"

    def __init__(self, source):
        self.source = source

    def _get_int(self, key: bytes, default: int = 0) -> int:
        v = self.source.get(key)
        return int.from_bytes(v, "big") if v else default

    def _put_int(self, key: bytes, value: int) -> None:
        self.source.put(key, int(value).to_bytes(8, "big"))

    @property
    def best_block_number(self) -> int:
        return self._get_int(self.BEST_BLOCK_NUMBER)

    @best_block_number.setter
    def best_block_number(self, n: int) -> None:
        self._put_int(self.BEST_BLOCK_NUMBER, n)

    @property
    def fast_sync_done(self) -> bool:
        return self.source.get(self.FAST_SYNC_DONE) == b"\x01"

    def mark_fast_sync_done(self) -> None:
        self.source.put(self.FAST_SYNC_DONE, b"\x01")

    @property
    def estimated_highest_block(self) -> int:
        return self._get_int(self.ESTIMATED_HIGHEST_BLOCK)

    @estimated_highest_block.setter
    def estimated_highest_block(self, n: int) -> None:
        self._put_int(self.ESTIMATED_HIGHEST_BLOCK, n)

    @property
    def sync_starting_block(self) -> int:
        return self._get_int(self.SYNC_STARTING_BLOCK)

    @sync_starting_block.setter
    def sync_starting_block(self, n: int) -> None:
        self._put_int(self.SYNC_STARTING_BLOCK, n)
