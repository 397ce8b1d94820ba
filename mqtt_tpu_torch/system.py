"""$SYS broker counters.

Behavioral parity with reference ``system/system.go:12-61`` (21 gauges /
counters published as retained ``$SYS/broker/...`` topics). Python ints under
the GIL replace Go's sync/atomic; the asyncio data plane mutates them from a
single thread. A copy of the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, replace


@dataclass
class Info:
    """Atomic-style counters on $SYS topics (system.go:12-34)."""

    version: str = ""  # the server version
    started: int = 0  # unix ts the server started
    time: int = 0  # current unix ts
    uptime: int = 0  # seconds since start
    bytes_received: int = 0
    bytes_sent: int = 0
    clients_connected: int = 0
    clients_disconnected: int = 0
    clients_maximum: int = 0
    clients_total: int = 0
    messages_received: int = 0
    messages_sent: int = 0
    messages_dropped: int = 0
    retained: int = 0
    inflight: int = 0
    inflight_dropped: int = 0
    subscriptions: int = 0
    packets_received: int = 0
    packets_sent: int = 0
    memory_alloc: int = 0
    threads: int = 0

    def __post_init__(self) -> None:
        # uptime anchor on the MONOTONIC clock: `started` is a wall-clock
        # unix ts, so `now - started` drifts when the wall clock steps
        # (NTP slew, manual set, suspend). Not a dataclass field — stores
        # and asdict() must not persist a monotonic reading, which is
        # meaningless across processes.
        self._mono_started = time.monotonic()

    def uptime_now(self) -> int:
        """Seconds since this Info was created, immune to wall-clock
        steps ($SYS/broker/uptime's source of truth)."""
        return int(time.monotonic() - self._mono_started)

    def clone(self) -> "Info":
        """Point-in-time copy (system.go:37-59)."""
        c = replace(self)
        c._mono_started = self._mono_started  # keep the uptime anchor
        return c

    def as_dict(self) -> dict:
        d = asdict(self)
        d["uptime"] = self.uptime_now()
        return d
