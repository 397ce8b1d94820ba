"""SQLite-backed storage hook — the durable single-file store, the analog of
the reference's embedded KV backends (badger/bolt/pebble). A copy of the JAX
package's; uses the stdlib ``sqlite3`` module, no external dependencies."""

from __future__ import annotations

import sqlite3
import threading
from typing import Any, Iterable, Optional

from .base import StorageHook

DEFAULT_PATH = "mqtt_tpu.db"


class SqliteOptions:
    def __init__(self, path: str = DEFAULT_PATH, sync: bool = False) -> None:
        self.path = path
        # sync=True forces fsync per write (the reference pebble hook's
        # Mode: Sync); default matches NoSync for throughput
        self.sync = sync


class SqliteStore(StorageHook):
    """Mirrors broker state into a single-table SQLite KV store."""

    def __init__(self) -> None:
        super().__init__()
        self.config = SqliteOptions()
        self._db: Optional[sqlite3.Connection] = None
        self._lock = threading.RLock()

    def id(self) -> str:
        return "sqlite-db"

    def init(self, config: Any) -> None:
        if config is not None and not isinstance(config, SqliteOptions):
            raise TypeError("invalid config type provided")
        self.config = config or SqliteOptions()
        self._db = sqlite3.connect(self.config.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB NOT NULL)"
        )
        self._db.execute(
            "PRAGMA synchronous = %s" % ("FULL" if self.config.sync else "OFF")
        )
        self._db.execute("PRAGMA journal_mode = WAL")
        self._db.commit()

    def stop(self) -> None:
        with self._lock:
            if self._db is not None:
                self._db.commit()
                self._db.close()
                self._db = None

    def _set(self, key: str, value: bytes) -> None:
        with self._lock:
            if self._db is None:
                self.log.error("sqlite store not open")
                return
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, value),
            )
            self._db.commit()

    def _get(self, key: str) -> Optional[bytes]:
        with self._lock:
            if self._db is None:
                return None
            row = self._db.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
            return row[0] if row else None

    def _del(self, key: str) -> None:
        with self._lock:
            if self._db is None:
                return
            self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._db.commit()

    def _iter(self, prefix: str) -> Iterable[bytes]:
        with self._lock:
            if self._db is None:
                return []
            rows = self._db.execute(
                "SELECT v FROM kv WHERE k >= ? AND k < ?", (prefix, prefix + "￿")
            ).fetchall()
            return [r[0] for r in rows]
