"""Debug hook: logs low-level packet flow for every lifecycle event.

A copy of the JAX package's (reference ``hooks/debug/debug.go:18-237``):
provides all events, logs packets in/out with type-specific metadata,
optionally including pings, payloads, and passwords.
"""

from __future__ import annotations

from typing import Any, Optional

from ..packets import (
    CONNACK,
    CONNECT,
    PACKET_NAMES,
    PINGREQ,
    PINGRESP,
    PUBLISH,
    SUBACK,
    SUBSCRIBE,
    UNSUBSCRIBE,
    Packet,
)
from . import Hook


class DebugOptions:
    """Configuration for debug output (debug.go:18-23)."""

    def __init__(
        self,
        enable: bool = True,
        show_packet_data: bool = False,
        show_pings: bool = False,
        show_passwords: bool = False,
    ) -> None:
        self.enable = enable
        self.show_packet_data = show_packet_data
        self.show_pings = show_pings
        self.show_passwords = show_passwords


class DebugHook(Hook):
    """Logs additional low-level information from the server."""

    def __init__(self) -> None:
        super().__init__()
        self.config = DebugOptions()

    def id(self) -> str:
        return "debug"

    def provides(self, b: int) -> bool:
        return True  # all events (debug.go:38-40)

    def init(self, config: Any) -> None:
        if config is not None and not isinstance(config, DebugOptions):
            raise TypeError("invalid config type provided")
        self.config = config or DebugOptions()

    def _packet_meta(self, pk: Packet) -> dict:
        """Type-specific log fields (debug.go:166-237)."""
        t = pk.fixed_header.type
        meta: dict = {"id": pk.packet_id}
        if t == CONNECT:
            meta.update(
                username=pk.connect.username,
                clean=pk.connect.clean,
                keepalive=pk.connect.keepalive,
                client_id=pk.connect.client_identifier,
                version=pk.protocol_version,
            )
            if self.config.show_passwords:
                meta["password"] = pk.connect.password
        elif t == CONNACK:
            meta.update(code=pk.reason_code, session_present=pk.session_present)
        elif t == PUBLISH:
            meta.update(
                topic=pk.topic_name,
                qos=pk.fixed_header.qos,
                retain=pk.fixed_header.retain,
                dup=pk.fixed_header.dup,
                size=len(pk.payload),
            )
            if self.config.show_packet_data:
                meta["payload"] = pk.payload
        elif t in (SUBSCRIBE, UNSUBSCRIBE):
            meta["filters"] = [(s.filter, s.qos) for s in pk.filters]
        elif t == SUBACK:
            meta["reason_codes"] = list(pk.reason_codes)
        else:
            meta["code"] = pk.reason_code
        return meta

    def _skip_ping(self, pk: Packet) -> bool:
        return pk.fixed_header.type in (PINGREQ, PINGRESP) and not self.config.show_pings

    # -- events ------------------------------------------------------------

    def on_started(self) -> None:
        self.log.debug("OnStarted")

    def on_stopped(self) -> None:
        self.log.debug("OnStopped")

    def on_packet_read(self, cl, pk: Packet) -> Packet:
        if not self._skip_ping(pk):
            name = PACKET_NAMES.get(pk.fixed_header.type, "?").upper()
            self.log.debug("%s << %s %s", name, cl.id if cl else "?", self._packet_meta(pk))
        return pk

    def on_packet_sent(self, cl, pk: Packet, b: bytes) -> None:
        if not self._skip_ping(pk):
            name = PACKET_NAMES.get(pk.fixed_header.type, "?").upper()
            self.log.debug("%s >> %s %s", name, cl.id if cl else "?", self._packet_meta(pk))

    def on_retain_message(self, cl, pk: Packet, r: int) -> None:
        self.log.debug("retained message on topic %s", self._packet_meta(pk))

    def on_qos_publish(self, cl, pk: Packet, sent: int, resends: int) -> None:
        self.log.debug("inflight out %s", self._packet_meta(pk))

    def on_qos_complete(self, cl, pk: Packet) -> None:
        self.log.debug("inflight complete %s", self._packet_meta(pk))

    def on_qos_dropped(self, cl, pk: Packet) -> None:
        self.log.debug("inflight dropped %s", self._packet_meta(pk))

    def on_will_sent(self, cl, pk: Packet) -> None:
        self.log.debug("sent lwt for client %s", cl.id if cl else "?")

    def on_connect(self, cl, pk: Packet) -> None:
        self.log.debug("OnConnect client=%s", cl.id if cl else "?")

    def on_disconnect(self, cl, err: Optional[Exception], expire: bool) -> None:
        self.log.debug(
            "OnDisconnect client=%s err=%s expire=%s", cl.id if cl else "?", err, expire
        )

    def on_session_established(self, cl, pk: Packet) -> None:
        self.log.debug("OnSessionEstablished client=%s", cl.id if cl else "?")

    def on_subscribed(self, cl, pk: Packet, reason_codes: bytes) -> None:
        self.log.debug(
            "OnSubscribed client=%s filters=%s", cl.id if cl else "?",
            [s.filter for s in pk.filters],
        )

    def on_unsubscribed(self, cl, pk: Packet) -> None:
        self.log.debug(
            "OnUnsubscribed client=%s filters=%s", cl.id if cl else "?",
            [s.filter for s in pk.filters],
        )
