"""MQTT fixed header codec with per-type flag validation.

Behavioral parity with reference ``packets/fixedheader.go:12-63``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .codec import encode_length
from .codes import (
    ERR_MALFORMED_FLAGS,
    ERR_PROTOCOL_VIOLATION_DUP_NO_QOS,
    ERR_PROTOCOL_VIOLATION_QOS_OUT_OF_RANGE,
)

# Packet type ids occupying bits 7-4 of the header byte (MQTT §2.1.2).
RESERVED = 0
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
PUBREC = 5
PUBREL = 6
PUBCOMP = 7
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14
AUTH = 15
# Sentinel used only for validating will properties (reference packets.go:37).
WILL_PROPERTIES = 99

PACKET_NAMES = {
    0: "Reserved",
    1: "Connect",
    2: "Connack",
    3: "Publish",
    4: "Puback",
    5: "Pubrec",
    6: "Pubrel",
    7: "Pubcomp",
    8: "Subscribe",
    9: "Suback",
    10: "Unsubscribe",
    11: "Unsuback",
    12: "Pingreq",
    13: "Pingresp",
    14: "Disconnect",
    15: "Auth",
}


@dataclass
class FixedHeader:
    """The first byte's packed fields plus the remaining-length value."""

    type: int = 0
    dup: bool = False
    qos: int = 0
    retain: bool = False
    remaining: int = 0

    def encode(self, out: bytearray) -> None:
        out.append(
            (self.type << 4)
            | ((1 if self.dup else 0) << 3)
            | (self.qos << 1)
            | (1 if self.retain else 0)
        )
        encode_length(out, self.remaining)

    def decode(self, hb: int) -> None:
        """Unpack the header byte, enforcing per-type reserved-flag rules."""
        self.type = hb >> 4
        if self.type == PUBLISH:
            if (hb >> 1) & 0x01 and (hb >> 1) & 0x02:
                raise ERR_PROTOCOL_VIOLATION_QOS_OUT_OF_RANGE()   # [MQTT-3.3.1-4]
            self.dup = bool((hb >> 3) & 0x01)
            self.qos = (hb >> 1) & 0x03
            self.retain = bool(hb & 0x01)
        elif self.type in (PUBREL, SUBSCRIBE, UNSUBSCRIBE):
            # Flags must be exactly 0b0010 [MQTT-3.8.1-1] [MQTT-3.10.1-1]
            if hb & 0x01 or (hb >> 1) & 0x01 != 1 or (hb >> 2) & 0x01 or (hb >> 3) & 0x01:
                raise ERR_MALFORMED_FLAGS()
            self.qos = (hb >> 1) & 0x03
        else:
            # [MQTT-3.8.3-5] [MQTT-3.14.1-1] [MQTT-3.15.1-1]
            if hb & 0x0F:
                raise ERR_MALFORMED_FLAGS()
        if self.qos == 0 and self.dup:
            raise ERR_PROTOCOL_VIOLATION_DUP_NO_QOS()   # [MQTT-3.3.1-2]
