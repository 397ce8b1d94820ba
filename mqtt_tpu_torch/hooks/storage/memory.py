"""In-memory storage hook — the test/embedded analog of the reference's KV
stores; also the restore-path fixture backend."""

from __future__ import annotations

import threading
from typing import Any, Iterable, Optional

from .base import StorageHook


class MemoryStore(StorageHook):
    """Keeps the mirrored broker state in a process-local dict."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.RLock()
        self.data: dict[str, bytes] = {}

    def id(self) -> str:
        return "memory-store"

    def init(self, config: Any) -> None:
        if isinstance(config, dict):
            self.data.update(config)

    def _set(self, key: str, value: bytes) -> None:
        with self._lock:
            self.data[key] = value

    def _get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self.data.get(key)

    def _del(self, key: str) -> None:
        with self._lock:
            self.data.pop(key, None)

    def _iter(self, prefix: str) -> Iterable[bytes]:
        with self._lock:
            return [v for k, v in self.data.items() if k.startswith(prefix)]
