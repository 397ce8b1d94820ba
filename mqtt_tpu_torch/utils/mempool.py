"""Reusable byte-buffer pool.

The analog of reference ``mempool/bufpool.go:11-81`` (a sync.Pool of
bytes.Buffer, optionally size-capped). CPython's allocator makes pooling
far less critical than in Go, but hot encode paths can still avoid
reallocation churn by renting buffers here.
"""

from __future__ import annotations

import threading


class BufferPool:
    """A capped free-list of bytearrays; oversized buffers are discarded on
    return (bufpool.go:76-81)."""

    def __init__(self, max_size: int = 0, max_pooled: int = 256) -> None:
        self.max_size = max_size  # discard returned buffers larger than this (0 = no cap)
        self.max_pooled = max_pooled
        self._lock = threading.Lock()
        self._free: list[bytearray] = []

    def get(self) -> bytearray:
        with self._lock:
            if self._free:
                return self._free.pop()
        return bytearray()

    def put(self, buf: bytearray) -> None:
        if self.max_size and len(buf) > self.max_size:
            return
        del buf[:]
        with self._lock:
            if len(self._free) < self.max_pooled:
                self._free.append(buf)


_default_pool = BufferPool()


def get_buffer() -> bytearray:
    return _default_pool.get()


def put_buffer(buf: bytearray) -> None:
    _default_pool.put(buf)
