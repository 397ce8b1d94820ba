"""Serializable DTOs shared by all persistence hooks, plus store key
prefixes.

A copy of the JAX package's (reference ``hooks/storage/storage.go:15-199``).
Every storage hook (``memory``, ``sqlite``, ``redis``, ``logkv``) mirrors
broker state through these shapes; ``Serve()`` restores the five datasets from them on boot
(server.go:1554-1692).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ...packets import (
    PUBLISH,
    FixedHeader,
    Packet,
    Properties,
    UserProperty,
)
from ...system import Info

SUBSCRIPTION_KEY = "SUB"  # unique key to denote subscriptions in the store
SYS_INFO_KEY = "SYS"  # unique key to denote server system info
RETAINED_KEY = "RET"  # unique key to denote retained messages
INFLIGHT_KEY = "IFM"  # unique key to denote inflight messages
CLIENT_KEY = "CL"  # unique key to denote clients


@dataclass
class ClientProperties:
    """Serializable client properties (storage.go:46-58)."""

    session_expiry_interval: int = 0
    session_expiry_interval_flag: bool = False
    authentication_method: str = ""
    authentication_data: bytes = b""
    request_problem_info: int = 0
    request_problem_info_flag: bool = False
    request_response_info: int = 0
    receive_maximum: int = 0
    topic_alias_maximum: int = 0
    user: list[UserProperty] = field(default_factory=list)
    maximum_packet_size: int = 0


@dataclass
class ClientWill:
    """Serializable will/LWT (storage.go:61-71)."""

    payload: bytes = b""
    user: list[UserProperty] = field(default_factory=list)
    topic_name: str = ""
    flag: int = 0
    will_delay_interval: int = 0
    qos: int = 0
    retain: bool = False


@dataclass
class Client:
    """Serializable client session (storage.go:33-43)."""

    id: str = ""
    t: str = CLIENT_KEY
    remote: str = ""
    listener: str = ""
    username: bytes = b""
    clean: bool = False
    protocol_version: int = 0
    properties: ClientProperties = field(default_factory=ClientProperties)
    will: ClientWill = field(default_factory=ClientWill)


@dataclass
class MessageProperties:
    """Serializable publish properties (storage.go:100-123)."""

    correlation_data: bytes = b""
    subscription_identifier: list[int] = field(default_factory=list)
    user: list[UserProperty] = field(default_factory=list)
    content_type: str = ""
    response_topic: str = ""
    message_expiry_interval: int = 0
    topic_alias: int = 0
    payload_format: int = 0
    payload_format_flag: bool = False


@dataclass
class Message:
    """A serializable publish packet: retained or inflight
    (storage.go:85-153)."""

    t: str = ""
    client: str = ""
    id: str = ""
    origin: str = ""
    topic_name: str = ""
    payload: bytes = b""
    properties: MessageProperties = field(default_factory=MessageProperties)
    created: int = 0
    sent: int = 0
    packet_id: int = 0
    fixed_header_type: int = PUBLISH
    qos: int = 0
    dup: bool = False
    retain: bool = False
    protocol_version: int = 0
    expiry: int = 0

    def to_packet(self) -> Packet:
        """Reconstruct the wire packet (storage.go:126-153)."""
        pk = Packet(
            fixed_header=FixedHeader(
                type=self.fixed_header_type,
                qos=self.qos,
                dup=self.dup,
                retain=self.retain,
            ),
            payload=self.payload,
            topic_name=self.topic_name,
            origin=self.origin,
            packet_id=self.packet_id,
            protocol_version=self.protocol_version,
            created=self.created,
            expiry=self.expiry,
            properties=Properties(
                correlation_data=self.properties.correlation_data,
                subscription_identifier=list(self.properties.subscription_identifier),
                user=list(self.properties.user),
                content_type=self.properties.content_type,
                response_topic=self.properties.response_topic,
                message_expiry_interval=self.properties.message_expiry_interval,
                topic_alias=self.properties.topic_alias,
                payload_format=self.properties.payload_format,
                payload_format_flag=self.properties.payload_format_flag,
            ),
        )
        return pk


@dataclass
class Subscription:
    """A serializable client subscription (storage.go:156-179).

    ``filter`` is the BASE filter (any MQTT+ predicate suffix already
    stripped); ``predicates`` carries the suffix source texts so a
    restart re-registers the rules (``predicates``)."""

    t: str = SUBSCRIPTION_KEY
    client: str = ""
    filter: str = ""
    identifier: int = 0
    retain_handling: int = 0
    qos: int = 0
    retain_as_published: bool = False
    no_local: bool = False
    predicates: list = field(default_factory=list)


@dataclass
class SystemInfo:
    """Serializable $SYS info snapshot (storage.go:182-199). The version
    lives inside ``info`` (the reference embeds system.Info, so there is a
    single Version field)."""

    t: str = SYS_INFO_KEY
    info: Info = field(default_factory=Info)

    def as_dict(self) -> dict:
        return asdict(self)
