"""SQLite-backed storage engine — the LMDB/RocksDB-role alternative.

Parity: khipu-lmdb / khipu-rocksdb (SURVEY §2.4): a second persistent
engine behind the same DataSource SPI, selected purely by
``db.engine = "sqlite"``. One database file per topic directory; WAL
mode for concurrent readers. The native append-log engine remains the
Kesque-role primary; this is the embedded-KV alternative the reference
keeps for operational flexibility. The port's copy of
``khipu_tpu.storage.sqlite_engine``.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional

from khipu_tpu_torch.storage.datasource import (
    BlockDataSource,
    KeyValueDataSource,
    NodeDataSource,
)


class _SqliteTable:
    def __init__(self, data_dir: str, topic: str):
        os.makedirs(data_dir, exist_ok=True)
        self._path = os.path.join(data_dir, f"{topic}.sqlite")
        self._local = threading.local()
        self._all_conns = []  # every thread's connection, for close()
        self._conns_lock = threading.Lock()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS kv"
                " (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False: each connection is still used by
            # exactly one thread for queries, but close() runs on the
            # shutdown thread — the default guard would make those
            # closes silently fail and pin -wal/-shm forever
            conn = sqlite3.connect(self._path, check_same_thread=False)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
            with self._conns_lock:
                # close + drop connections whose owner thread is gone —
                # thread-per-request servers would otherwise pin one fd
                # per request forever; weakrefs track thread liveness
                import weakref

                alive = []
                for c, tref in self._all_conns:
                    owner = tref()
                    if owner is not None and owner.is_alive():
                        alive.append((c, tref))
                    else:
                        try:
                            c.close()
                        except sqlite3.Error:
                            pass
                self._all_conns = alive
                self._all_conns.append(
                    (conn, weakref.ref(threading.current_thread()))
                )
        return conn

    def get(self, key: bytes) -> Optional[bytes]:
        row = self._conn().execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return row[0] if row else None

    def update(self, to_remove, to_upsert) -> None:
        conn = self._conn()
        with conn:
            conn.executemany(
                "DELETE FROM kv WHERE k = ?", [(bytes(k),) for k in to_remove]
            )
            conn.executemany(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                [(bytes(k), bytes(v)) for k, v in to_upsert.items()],
            )

    @property
    def count(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    def keys(self) -> list:
        """All keys, sorted — the StreamNodeData iteration surface
        (live rebalance); bytes sort == SQLite BLOB ordering."""
        return [
            row[0] for row in self._conn().execute(
                "SELECT k FROM kv ORDER BY k"
            )
        ]

    def max_key8(self) -> int:
        row = self._conn().execute(
            "SELECT MAX(k) FROM kv WHERE LENGTH(k) = 8"
        ).fetchone()
        return int.from_bytes(row[0], "big") if row and row[0] else -1

    def close(self) -> None:
        # close EVERY thread's connection (RPC/bridge/peer workers each
        # opened their own) — sqlite allows cross-thread close and this
        # releases the -wal/-shm pins
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn, _tref in conns:
            try:
                conn.close()
            except sqlite3.Error:
                pass
        self._local.conn = None


class SqliteKeyValueDataSource(KeyValueDataSource):
    def __init__(self, data_dir: str, topic: str):
        super().__init__()
        self._table = _SqliteTable(data_dir, topic)

    def get(self, key: bytes) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            return self._table.get(bytes(key))
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        self._table.update(to_remove, to_upsert)

    @property
    def count(self) -> int:
        return self._table.count

    def keys(self) -> list:
        return self._table.keys()

    def stop(self) -> None:
        self._table.close()


class SqliteNodeDataSource(SqliteKeyValueDataSource, NodeDataSource):
    """Content-addressed node store over sqlite. Removes are swallowed
    (archive semantics, NodeStorage.scala:16-19)."""

    def update(self, to_remove, to_upsert) -> None:
        self._table.update([], to_upsert)


class SqliteBlockDataSource(BlockDataSource):
    def __init__(self, data_dir: str, topic: str):
        super().__init__()
        self._table = _SqliteTable(data_dir, topic)
        self._best = self._table.max_key8()
        self._lock = threading.Lock()

    @staticmethod
    def _key(number: int) -> bytes:
        return int(number).to_bytes(8, "big")

    def get(self, number: int) -> Optional[bytes]:
        t0 = self.clock.start()
        try:
            return self._table.get(self._key(number))
        finally:
            self.clock.elapse(t0)

    def update(self, to_remove, to_upsert) -> None:
        with self._lock:
            self._table.update(
                [self._key(n) for n in to_remove],
                {self._key(n): v for n, v in to_upsert.items()},
            )
            for n in to_upsert:
                if int(n) > self._best:
                    self._best = int(n)
            if to_remove:
                self._best = self._table.max_key8()

    @property
    def best_block_number(self) -> int:
        return self._best

    @property
    def count(self) -> int:
        return self._table.count

    def stop(self) -> None:
        self._table.close()
