"""Per-client inflight (QoS>0) message map plus MQTT v5 send/receive flow
quotas.

Behavioral parity with reference ``inflight.go:16-156``. A copy of the JAX
package's; its lock is an ``InstrumentedLock`` under the same name.
"""

from __future__ import annotations

from typing import Optional

from .packets import Packet
from .utils.locked import InstrumentedLock


class Inflight:
    """Inflight packets keyed on packet id, with send/receive quota counters
    used for v5 flow control (inflight.go:16-23)."""

    def __init__(self) -> None:
        self._lock = InstrumentedLock("inflight", rlock=True)
        self.internal: dict[int, Packet] = {}
        self.receive_quota = 0  # remaining inbound qos quota
        self.send_quota = 0  # remaining outbound qos quota
        self.maximum_receive_quota = 0
        self.maximum_send_quota = 0

    def set(self, m: Packet) -> bool:
        """Add or update by packet id; True if it was new (inflight.go:33)."""
        with self._lock:
            existed = m.packet_id in self.internal
            self.internal[m.packet_id] = m
            return not existed

    def set_bulk(self, packets: list[Packet]) -> int:
        """Batched :meth:`set` for durable-session restore
        (staging.bulk_inflight): one lock acquisition per chunk instead
        of one per packet. Returns how many ids were new."""
        with self._lock:
            new = 0
            for m in packets:
                if m.packet_id not in self.internal:
                    new += 1
                self.internal[m.packet_id] = m
            return new

    def get(self, id_: int) -> Optional[Packet]:
        with self._lock:
            return self.internal.get(id_)

    def __len__(self) -> int:
        with self._lock:
            return len(self.internal)

    def clone(self) -> "Inflight":
        """Copy for session takeover (inflight.go:63-71)."""
        c = Inflight()
        with self._lock:
            c.internal = dict(self.internal)
        return c

    def get_all(self, immediate: bool) -> list[Packet]:
        """All inflight messages ordered by created time; when ``immediate``,
        only packets flagged for immediate resend (expiry < 0, set when the
        send quota was exhausted) (inflight.go:74-90)."""
        with self._lock:
            m = [v for v in self.internal.values() if not immediate or v.expiry < 0]
        # reference sorts on uint16(Created) — preserved for identical order
        m.sort(key=lambda pk: pk.created & 0xFFFF)
        return m

    def next_immediate(self) -> Optional[Packet]:
        """The next quota-starved packet to resend (inflight.go:95-105)."""
        m = self.get_all(True)
        return m[0] if m else None

    def delete(self, id_: int) -> bool:
        with self._lock:
            return self.internal.pop(id_, None) is not None

    # -- flow-control quotas (inflight.go:119-156) -------------------------

    def decrease_receive_quota(self) -> None:
        if self.receive_quota > 0:
            self.receive_quota -= 1

    def increase_receive_quota(self) -> None:
        if self.receive_quota < self.maximum_receive_quota:
            self.receive_quota += 1

    def reset_receive_quota(self, n: int) -> None:
        self.receive_quota = n
        self.maximum_receive_quota = n

    def decrease_send_quota(self) -> None:
        if self.send_quota > 0:
            self.send_quota -= 1

    def increase_send_quota(self) -> None:
        if self.send_quota < self.maximum_send_quota:
            self.send_quota += 1

    def reset_send_quota(self, n: int) -> None:
        self.send_quota = n
        self.maximum_send_quota = n
