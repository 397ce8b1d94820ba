"""MQTT v5 properties: all 27 property ids, the per-packet-type validity
matrix, and encode/decode.

Behavioral parity with reference ``packets/properties.go`` (ids :15-43,
validity matrix :46-74, encode order and gating :199-363, decode :366-481).
Encode emits properties in the reference's field order so golden wire bytes
match byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import fixedheader as fh
from .codec import (
    decode_byte,
    decode_bytes,
    decode_length,
    decode_string,
    decode_uint16,
    decode_uint32,
    encode_bytes,
    encode_length,
    encode_string,
    encode_uint16,
    encode_uint32,
)
from .codes import ERR_PROTOCOL_VIOLATION_UNSUPPORTED_PROPERTY

PROP_PAYLOAD_FORMAT = 1
PROP_MESSAGE_EXPIRY_INTERVAL = 2
PROP_CONTENT_TYPE = 3
PROP_RESPONSE_TOPIC = 8
PROP_CORRELATION_DATA = 9
PROP_SUBSCRIPTION_IDENTIFIER = 11
PROP_SESSION_EXPIRY_INTERVAL = 17
PROP_ASSIGNED_CLIENT_ID = 18
PROP_SERVER_KEEP_ALIVE = 19
PROP_AUTHENTICATION_METHOD = 21
PROP_AUTHENTICATION_DATA = 22
PROP_REQUEST_PROBLEM_INFO = 23
PROP_WILL_DELAY_INTERVAL = 24
PROP_REQUEST_RESPONSE_INFO = 25
PROP_RESPONSE_INFO = 26
PROP_SERVER_REFERENCE = 28
PROP_REASON_STRING = 31
PROP_RECEIVE_MAXIMUM = 33
PROP_TOPIC_ALIAS_MAXIMUM = 34
PROP_TOPIC_ALIAS = 35
PROP_MAXIMUM_QOS = 36
PROP_RETAIN_AVAILABLE = 37
PROP_USER = 38
PROP_MAXIMUM_PACKET_SIZE = 39
PROP_WILDCARD_SUB_AVAILABLE = 40
PROP_SUB_ID_AVAILABLE = 41
PROP_SHARED_SUB_AVAILABLE = 42

# property id -> set of packet types it may appear in (properties.go:46-74).
VALID_PACKET_PROPERTIES: dict[int, frozenset[int]] = {
    PROP_PAYLOAD_FORMAT: frozenset({fh.PUBLISH, fh.WILL_PROPERTIES}),
    PROP_MESSAGE_EXPIRY_INTERVAL: frozenset({fh.PUBLISH, fh.WILL_PROPERTIES}),
    PROP_CONTENT_TYPE: frozenset({fh.PUBLISH, fh.WILL_PROPERTIES}),
    PROP_RESPONSE_TOPIC: frozenset({fh.PUBLISH, fh.WILL_PROPERTIES}),
    PROP_CORRELATION_DATA: frozenset({fh.PUBLISH, fh.WILL_PROPERTIES}),
    PROP_SUBSCRIPTION_IDENTIFIER: frozenset({fh.PUBLISH, fh.SUBSCRIBE}),
    PROP_SESSION_EXPIRY_INTERVAL: frozenset({fh.CONNECT, fh.CONNACK, fh.DISCONNECT}),
    PROP_ASSIGNED_CLIENT_ID: frozenset({fh.CONNACK}),
    PROP_SERVER_KEEP_ALIVE: frozenset({fh.CONNACK}),
    PROP_AUTHENTICATION_METHOD: frozenset({fh.CONNECT, fh.CONNACK, fh.AUTH}),
    PROP_AUTHENTICATION_DATA: frozenset({fh.CONNECT, fh.CONNACK, fh.AUTH}),
    PROP_REQUEST_PROBLEM_INFO: frozenset({fh.CONNECT}),
    PROP_WILL_DELAY_INTERVAL: frozenset({fh.WILL_PROPERTIES}),
    PROP_REQUEST_RESPONSE_INFO: frozenset({fh.CONNECT}),
    PROP_RESPONSE_INFO: frozenset({fh.CONNACK}),
    PROP_SERVER_REFERENCE: frozenset({fh.CONNACK, fh.DISCONNECT}),
    PROP_REASON_STRING: frozenset(
        {fh.CONNACK, fh.PUBACK, fh.PUBREC, fh.PUBREL, fh.PUBCOMP, fh.SUBACK, fh.UNSUBACK, fh.DISCONNECT, fh.AUTH}
    ),
    PROP_RECEIVE_MAXIMUM: frozenset({fh.CONNECT, fh.CONNACK}),
    PROP_TOPIC_ALIAS_MAXIMUM: frozenset({fh.CONNECT, fh.CONNACK}),
    PROP_TOPIC_ALIAS: frozenset({fh.PUBLISH}),
    PROP_MAXIMUM_QOS: frozenset({fh.CONNACK}),
    PROP_RETAIN_AVAILABLE: frozenset({fh.CONNACK}),
    PROP_USER: frozenset(
        {
            fh.CONNECT,
            fh.CONNACK,
            fh.PUBLISH,
            fh.PUBACK,
            fh.PUBREC,
            fh.PUBREL,
            fh.PUBCOMP,
            fh.SUBSCRIBE,
            fh.SUBACK,
            fh.UNSUBSCRIBE,
            fh.UNSUBACK,
            fh.DISCONNECT,
            fh.AUTH,
            fh.WILL_PROPERTIES,
        }
    ),
    PROP_MAXIMUM_PACKET_SIZE: frozenset({fh.CONNECT, fh.CONNACK}),
    PROP_WILDCARD_SUB_AVAILABLE: frozenset({fh.CONNACK}),
    PROP_SUB_ID_AVAILABLE: frozenset({fh.CONNACK}),
    PROP_SHARED_SUB_AVAILABLE: frozenset({fh.CONNACK}),
}


@dataclass
class Mods:
    """Broker-internal encode controls for v5 compliance (packets.go:144-148)."""

    max_size: int = 0
    disallow_problem_info: bool = False
    allow_response_info: bool = False


@dataclass
class UserProperty:
    """Arbitrary key-value pair [MQTT-1.5.7-1]."""

    key: str = ""
    val: str = ""


@dataclass
class Properties:
    """All v5 properties. Zero-valid properties carry a presence flag
    (``*_flag``) per MQTT v5 §2.2.2.2, mirroring properties.go:86-124."""

    correlation_data: bytes = b""
    subscription_identifier: list[int] = field(default_factory=list)
    authentication_data: bytes = b""
    user: list[UserProperty] = field(default_factory=list)
    content_type: str = ""
    response_topic: str = ""
    assigned_client_id: str = ""
    authentication_method: str = ""
    response_info: str = ""
    server_reference: str = ""
    reason_string: str = ""
    message_expiry_interval: int = 0
    session_expiry_interval: int = 0
    will_delay_interval: int = 0
    maximum_packet_size: int = 0
    server_keep_alive: int = 0
    receive_maximum: int = 0
    topic_alias_maximum: int = 0
    topic_alias: int = 0
    payload_format: int = 0
    payload_format_flag: bool = False
    session_expiry_interval_flag: bool = False
    server_keep_alive_flag: bool = False
    request_problem_info: int = 0
    request_problem_info_flag: bool = False
    request_response_info: int = 0
    topic_alias_flag: bool = False
    maximum_qos: int = 0
    maximum_qos_flag: bool = False
    retain_available: int = 0
    retain_available_flag: bool = False
    wildcard_sub_available: int = 0
    wildcard_sub_available_flag: bool = False
    sub_id_available: int = 0
    sub_id_available_flag: bool = False
    shared_sub_available: int = 0
    shared_sub_available_flag: bool = False

    def copy(self, allow_transfer: bool) -> "Properties":
        """Value copy; drops TopicAlias unless transfer allowed [MQTT-3.3.2-7].

        Implemented as a ``__dict__`` copy with explicit resets — this runs
        twice per ``Packet.copy`` on the publish fan-out hot path, where a
        33-kwarg dataclass construction costs ~4x as much.
        """
        pr = Properties.__new__(Properties)
        d = self.__dict__.copy()
        pr.__dict__ = d
        if not allow_transfer:
            d["topic_alias"] = 0
            d["topic_alias_flag"] = False
        # mutable members get value copies; empty ones get fresh defaults
        # (never share a list/bytes buffer with the source)
        d["correlation_data"] = (
            bytes(self.correlation_data) if self.correlation_data else b""
        )  # [MQTT-3.3.2-16]
        d["subscription_identifier"] = (
            list(self.subscription_identifier) if self.subscription_identifier else []
        )
        d["authentication_data"] = (
            bytes(self.authentication_data) if self.authentication_data else b""
        )
        d["user"] = (
            [UserProperty(u.key, u.val) for u in self.user] if self.user else []
        )  # [MQTT-3.3.2-17]
        return pr

    def _can_encode(self, pkt: int, k: int) -> bool:
        return pkt in VALID_PACKET_PROPERTIES.get(k, ())

    def encode(self, pkt: int, mods: Mods, out: bytearray, n: int) -> None:
        """Append the property-length varint + property bytes for packet type
        ``pkt`` to ``out``; ``n`` is the encoded size so far (for max-size
        gating of reason string / user properties)."""
        buf = bytearray()
        can = self._can_encode
        if can(pkt, PROP_PAYLOAD_FORMAT) and self.payload_format_flag:
            buf.append(PROP_PAYLOAD_FORMAT)
            buf.append(self.payload_format)
        if can(pkt, PROP_MESSAGE_EXPIRY_INTERVAL) and self.message_expiry_interval > 0:
            buf.append(PROP_MESSAGE_EXPIRY_INTERVAL)
            buf += encode_uint32(self.message_expiry_interval)
        if can(pkt, PROP_CONTENT_TYPE) and self.content_type:
            buf.append(PROP_CONTENT_TYPE)
            buf += encode_string(self.content_type)  # [MQTT-3.3.2-19]
        if (
            mods.allow_response_info
            and can(pkt, PROP_RESPONSE_TOPIC)  # [MQTT-3.3.2-14]
            and self.response_topic
            and not any(c in self.response_topic for c in "+#")  # [MQTT-3.1.2-28]
        ):
            buf.append(PROP_RESPONSE_TOPIC)
            buf += encode_string(self.response_topic)  # [MQTT-3.3.2-13]
        if mods.allow_response_info and can(pkt, PROP_CORRELATION_DATA) and self.correlation_data:
            buf.append(PROP_CORRELATION_DATA)
            buf += encode_bytes(self.correlation_data)
        if can(pkt, PROP_SUBSCRIPTION_IDENTIFIER) and self.subscription_identifier:
            for v in self.subscription_identifier:
                if v > 0:
                    buf.append(PROP_SUBSCRIPTION_IDENTIFIER)
                    encode_length(buf, v)
        if can(pkt, PROP_SESSION_EXPIRY_INTERVAL) and self.session_expiry_interval_flag:
            buf.append(PROP_SESSION_EXPIRY_INTERVAL)  # [MQTT-3.14.2-2]
            buf += encode_uint32(self.session_expiry_interval)
        if can(pkt, PROP_ASSIGNED_CLIENT_ID) and self.assigned_client_id:
            buf.append(PROP_ASSIGNED_CLIENT_ID)
            buf += encode_string(self.assigned_client_id)
        if can(pkt, PROP_SERVER_KEEP_ALIVE) and self.server_keep_alive_flag:
            buf.append(PROP_SERVER_KEEP_ALIVE)
            buf += encode_uint16(self.server_keep_alive)
        if can(pkt, PROP_AUTHENTICATION_METHOD) and self.authentication_method:
            buf.append(PROP_AUTHENTICATION_METHOD)
            buf += encode_string(self.authentication_method)
        if can(pkt, PROP_AUTHENTICATION_DATA) and self.authentication_data:
            buf.append(PROP_AUTHENTICATION_DATA)
            buf += encode_bytes(self.authentication_data)
        if can(pkt, PROP_REQUEST_PROBLEM_INFO) and self.request_problem_info_flag:
            buf.append(PROP_REQUEST_PROBLEM_INFO)
            buf.append(self.request_problem_info)
        if can(pkt, PROP_WILL_DELAY_INTERVAL) and self.will_delay_interval > 0:
            buf.append(PROP_WILL_DELAY_INTERVAL)
            buf += encode_uint32(self.will_delay_interval)
        if can(pkt, PROP_REQUEST_RESPONSE_INFO) and self.request_response_info > 0:
            buf.append(PROP_REQUEST_RESPONSE_INFO)
            buf.append(self.request_response_info)
        if mods.allow_response_info and can(pkt, PROP_RESPONSE_INFO) and self.response_info:
            buf.append(PROP_RESPONSE_INFO)  # [MQTT-3.1.2-28]
            buf += encode_string(self.response_info)
        if can(pkt, PROP_SERVER_REFERENCE) and self.server_reference:
            buf.append(PROP_SERVER_REFERENCE)
            buf += encode_string(self.server_reference)
        # [MQTT-3.2.2-19] [MQTT-3.14.2-3] [MQTT-3.4.2-2] [MQTT-3.5.2-2]
        # [MQTT-3.6.2-2] [MQTT-3.9.2-1] [MQTT-3.11.2-1] [MQTT-3.15.2-2]
        if not mods.disallow_problem_info and can(pkt, PROP_REASON_STRING) and self.reason_string:
            b = encode_string(self.reason_string)
            if mods.max_size == 0 or n + len(b) + 1 < mods.max_size:
                buf.append(PROP_REASON_STRING)
                buf += b
        if can(pkt, PROP_RECEIVE_MAXIMUM) and self.receive_maximum > 0:
            buf.append(PROP_RECEIVE_MAXIMUM)
            buf += encode_uint16(self.receive_maximum)
        if can(pkt, PROP_TOPIC_ALIAS_MAXIMUM) and self.topic_alias_maximum > 0:
            buf.append(PROP_TOPIC_ALIAS_MAXIMUM)
            buf += encode_uint16(self.topic_alias_maximum)
        if can(pkt, PROP_TOPIC_ALIAS) and self.topic_alias_flag and self.topic_alias > 0:
            buf.append(PROP_TOPIC_ALIAS)  # [MQTT-3.3.2-8]
            buf += encode_uint16(self.topic_alias)
        if can(pkt, PROP_MAXIMUM_QOS) and self.maximum_qos_flag and self.maximum_qos < 2:
            buf.append(PROP_MAXIMUM_QOS)
            buf.append(self.maximum_qos)
        if can(pkt, PROP_RETAIN_AVAILABLE) and self.retain_available_flag:
            buf.append(PROP_RETAIN_AVAILABLE)
            buf.append(self.retain_available)
        if not mods.disallow_problem_info and can(pkt, PROP_USER):
            pb = bytearray()
            for u in self.user:
                pb.append(PROP_USER)
                pb += encode_string(u.key)
                pb += encode_string(u.val)
            # [MQTT-3.2.2-20] [MQTT-3.14.2-4] [MQTT-3.4.2-3] [MQTT-3.5.2-3]
            if mods.max_size == 0 or n + len(pb) + 1 < mods.max_size:
                buf += pb
        if can(pkt, PROP_MAXIMUM_PACKET_SIZE) and self.maximum_packet_size > 0:
            buf.append(PROP_MAXIMUM_PACKET_SIZE)
            buf += encode_uint32(self.maximum_packet_size)
        if can(pkt, PROP_WILDCARD_SUB_AVAILABLE) and self.wildcard_sub_available_flag:
            buf.append(PROP_WILDCARD_SUB_AVAILABLE)
            buf.append(self.wildcard_sub_available)
        if can(pkt, PROP_SUB_ID_AVAILABLE) and self.sub_id_available_flag:
            buf.append(PROP_SUB_ID_AVAILABLE)
            buf.append(self.sub_id_available)
        if can(pkt, PROP_SHARED_SUB_AVAILABLE) and self.shared_sub_available_flag:
            buf.append(PROP_SHARED_SUB_AVAILABLE)
            buf.append(self.shared_sub_available)
        encode_length(out, len(buf))
        out += buf  # [MQTT-3.1.3-10]

    def decode(self, pkt: int, buf: bytes, offset: int = 0) -> int:
        """Decode the property block starting at ``offset``; returns the
        offset of the first byte after the block. Raises on unknown property
        ids or ids invalid for ``pkt`` (properties.go:389-391)."""
        n, offset = decode_length(buf, offset)
        if n == 0:
            return offset
        # Callers advance by the declared block length even if the inner walk
        # consumed a different amount (reference properties.go:372-480 returns
        # the declared length + varint size).
        end = offset + n
        while offset < end:
            k, offset = decode_byte(buf, offset)
            if pkt not in VALID_PACKET_PROPERTIES.get(k, ()):
                raise ERR_PROTOCOL_VIOLATION_UNSUPPORTED_PROPERTY.wrap(
                    f"property type {k} not valid for packet type {pkt}"
                )
            if k == PROP_PAYLOAD_FORMAT:
                self.payload_format, offset = decode_byte(buf, offset)
                self.payload_format_flag = True
            elif k == PROP_MESSAGE_EXPIRY_INTERVAL:
                self.message_expiry_interval, offset = decode_uint32(buf, offset)
            elif k == PROP_CONTENT_TYPE:
                self.content_type, offset = decode_string(buf, offset)
            elif k == PROP_RESPONSE_TOPIC:
                self.response_topic, offset = decode_string(buf, offset)
            elif k == PROP_CORRELATION_DATA:
                self.correlation_data, offset = decode_bytes(buf, offset)
            elif k == PROP_SUBSCRIPTION_IDENTIFIER:
                v, offset = decode_length(buf, offset)
                self.subscription_identifier.append(v)
            elif k == PROP_SESSION_EXPIRY_INTERVAL:
                self.session_expiry_interval, offset = decode_uint32(buf, offset)
                self.session_expiry_interval_flag = True
            elif k == PROP_ASSIGNED_CLIENT_ID:
                self.assigned_client_id, offset = decode_string(buf, offset)
            elif k == PROP_SERVER_KEEP_ALIVE:
                self.server_keep_alive, offset = decode_uint16(buf, offset)
                self.server_keep_alive_flag = True
            elif k == PROP_AUTHENTICATION_METHOD:
                self.authentication_method, offset = decode_string(buf, offset)
            elif k == PROP_AUTHENTICATION_DATA:
                self.authentication_data, offset = decode_bytes(buf, offset)
            elif k == PROP_REQUEST_PROBLEM_INFO:
                self.request_problem_info, offset = decode_byte(buf, offset)
                self.request_problem_info_flag = True
            elif k == PROP_WILL_DELAY_INTERVAL:
                self.will_delay_interval, offset = decode_uint32(buf, offset)
            elif k == PROP_REQUEST_RESPONSE_INFO:
                self.request_response_info, offset = decode_byte(buf, offset)
            elif k == PROP_RESPONSE_INFO:
                self.response_info, offset = decode_string(buf, offset)
            elif k == PROP_SERVER_REFERENCE:
                self.server_reference, offset = decode_string(buf, offset)
            elif k == PROP_REASON_STRING:
                self.reason_string, offset = decode_string(buf, offset)
            elif k == PROP_RECEIVE_MAXIMUM:
                self.receive_maximum, offset = decode_uint16(buf, offset)
            elif k == PROP_TOPIC_ALIAS_MAXIMUM:
                self.topic_alias_maximum, offset = decode_uint16(buf, offset)
            elif k == PROP_TOPIC_ALIAS:
                self.topic_alias, offset = decode_uint16(buf, offset)
                self.topic_alias_flag = True
            elif k == PROP_MAXIMUM_QOS:
                self.maximum_qos, offset = decode_byte(buf, offset)
                self.maximum_qos_flag = True
            elif k == PROP_RETAIN_AVAILABLE:
                self.retain_available, offset = decode_byte(buf, offset)
                self.retain_available_flag = True
            elif k == PROP_USER:
                key, offset = decode_string(buf, offset)
                val, offset = decode_string(buf, offset)
                self.user.append(UserProperty(key, val))
            elif k == PROP_MAXIMUM_PACKET_SIZE:
                self.maximum_packet_size, offset = decode_uint32(buf, offset)
            elif k == PROP_WILDCARD_SUB_AVAILABLE:
                self.wildcard_sub_available, offset = decode_byte(buf, offset)
                self.wildcard_sub_available_flag = True
            elif k == PROP_SUB_ID_AVAILABLE:
                self.sub_id_available, offset = decode_byte(buf, offset)
                self.sub_id_available_flag = True
            elif k == PROP_SHARED_SUB_AVAILABLE:
                self.shared_sub_available, offset = decode_byte(buf, offset)
                self.shared_sub_available_flag = True
        return end
