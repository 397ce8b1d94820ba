"""A lock-protected map for the subscription trie's per-node containers."""

from __future__ import annotations

import threading
from typing import Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LockedMap(Generic[K, V]):
    """Lock-protected dict with copy-on-iterate semantics. ``internal`` is
    public: the flat-index build reads it without the lock and retries a
    torn read."""

    __slots__ = ("_lock", "internal")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.internal: dict[K, V] = {}

    def add(self, key: K, val: V) -> None:
        with self._lock:
            self.internal[key] = val

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            return self.internal.get(key)

    def get_all(self) -> dict[K, V]:
        with self._lock:
            return dict(self.internal)

    def delete(self, key: K) -> None:
        with self._lock:
            self.internal.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self.internal)
