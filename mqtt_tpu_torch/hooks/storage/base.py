"""The shared write-through storage hook: every session / subscription /
retained / inflight / $SYS change mirrors to a KV backend as it happens, and
the five ``stored_*`` readers restore them on boot.

A copy of the JAX package's, after the reference's storage hooks (badger/bolt/pebble/
redis all implement the same event set — e.g. hooks/storage/badger/
badger.go:85-105 Provides, :173+ handlers); here the event logic lives once
in :class:`StorageHook` and backends implement only ``_set/_get/_del/_iter``.
"""

from __future__ import annotations

import base64
import json
from dataclasses import asdict, fields, is_dataclass
from typing import Any, Iterable, Optional

from ...packets import ERR_SESSION_TAKEN_OVER, Packet, UserProperty
from ...system import Info
from .. import (
    ON_CLIENT_EXPIRED,
    ON_DISCONNECT,
    ON_QOS_COMPLETE,
    ON_QOS_DROPPED,
    ON_QOS_PUBLISH,
    ON_RETAINED_EXPIRED,
    ON_RETAIN_MESSAGE,
    ON_SESSION_ESTABLISHED,
    ON_SUBSCRIBED,
    ON_SYS_INFO_TICK,
    ON_UNSUBSCRIBED,
    ON_WILL_SENT,
    STORED_CLIENTS,
    STORED_INFLIGHT_MESSAGES,
    STORED_RETAINED_MESSAGES,
    STORED_SUBSCRIPTIONS,
    STORED_SYS_INFO,
    Hook,
)
from . import (
    CLIENT_KEY,
    INFLIGHT_KEY,
    RETAINED_KEY,
    SUBSCRIPTION_KEY,
    SYS_INFO_KEY,
    Client,
    ClientProperties,
    ClientWill,
    Message,
    MessageProperties,
    Subscription,
    SystemInfo,
)

_PROVIDED = frozenset(
    {
        ON_SESSION_ESTABLISHED,
        ON_DISCONNECT,
        ON_SUBSCRIBED,
        ON_UNSUBSCRIBED,
        ON_RETAIN_MESSAGE,
        ON_WILL_SENT,
        ON_QOS_PUBLISH,
        ON_QOS_COMPLETE,
        ON_QOS_DROPPED,
        ON_SYS_INFO_TICK,
        ON_CLIENT_EXPIRED,
        ON_RETAINED_EXPIRED,
        STORED_CLIENTS,
        STORED_INFLIGHT_MESSAGES,
        STORED_RETAINED_MESSAGES,
        STORED_SUBSCRIPTIONS,
        STORED_SYS_INFO,
    }
)


# -- json serde for the DTO dataclasses (bytes as base64) ------------------


def _encode(obj: Any) -> Any:
    if is_dataclass(obj):
        return {k: _encode(v) for k, v in asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode()}
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__b64__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b64__"])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def dumps(obj: Any) -> bytes:
    return json.dumps(_encode(obj)).encode()


def _users(raw: list) -> list[UserProperty]:
    return [UserProperty(u["key"], u["val"]) for u in raw or []]


def client_from_dict(d: dict) -> Client:
    p = d.get("properties") or {}
    w = d.get("will") or {}
    return Client(
        id=d.get("id", ""),
        remote=d.get("remote", ""),
        listener=d.get("listener", ""),
        username=d.get("username", b""),
        clean=d.get("clean", False),
        protocol_version=d.get("protocol_version", 0),
        properties=ClientProperties(
            session_expiry_interval=p.get("session_expiry_interval", 0),
            session_expiry_interval_flag=p.get("session_expiry_interval_flag", False),
            authentication_method=p.get("authentication_method", ""),
            authentication_data=p.get("authentication_data", b""),
            request_problem_info=p.get("request_problem_info", 0),
            request_problem_info_flag=p.get("request_problem_info_flag", False),
            request_response_info=p.get("request_response_info", 0),
            receive_maximum=p.get("receive_maximum", 0),
            topic_alias_maximum=p.get("topic_alias_maximum", 0),
            user=_users(p.get("user")),
            maximum_packet_size=p.get("maximum_packet_size", 0),
        ),
        will=ClientWill(
            payload=w.get("payload", b""),
            user=_users(w.get("user")),
            topic_name=w.get("topic_name", ""),
            flag=w.get("flag", 0),
            will_delay_interval=w.get("will_delay_interval", 0),
            qos=w.get("qos", 0),
            retain=w.get("retain", False),
        ),
    )


def message_from_dict(d: dict) -> Message:
    p = d.get("properties") or {}
    return Message(
        t=d.get("t", ""),
        client=d.get("client", ""),
        id=d.get("id", ""),
        origin=d.get("origin", ""),
        topic_name=d.get("topic_name", ""),
        payload=d.get("payload", b""),
        created=d.get("created", 0),
        sent=d.get("sent", 0),
        packet_id=d.get("packet_id", 0),
        fixed_header_type=d.get("fixed_header_type", 3),
        qos=d.get("qos", 0),
        dup=d.get("dup", False),
        retain=d.get("retain", False),
        protocol_version=d.get("protocol_version", 0),
        expiry=d.get("expiry", 0),
        properties=MessageProperties(
            correlation_data=p.get("correlation_data", b""),
            subscription_identifier=list(p.get("subscription_identifier") or []),
            user=_users(p.get("user")),
            content_type=p.get("content_type", ""),
            response_topic=p.get("response_topic", ""),
            message_expiry_interval=p.get("message_expiry_interval", 0),
            topic_alias=p.get("topic_alias", 0),
            payload_format=p.get("payload_format", 0),
            payload_format_flag=p.get("payload_format_flag", False),
        ),
    )


def subscription_from_dict(d: dict) -> Subscription:
    return Subscription(
        client=d.get("client", ""),
        filter=d.get("filter", ""),
        identifier=d.get("identifier", 0),
        retain_handling=d.get("retain_handling", 0),
        qos=d.get("qos", 0),
        retain_as_published=d.get("retain_as_published", False),
        no_local=d.get("no_local", False),
        predicates=list(d.get("predicates") or []),
    )


def sys_info_from_dict(d: dict) -> SystemInfo:
    info = d.get("info") or {}
    # dataclass FIELDS, not __dict__: Info carries a non-field monotonic
    # uptime anchor (system.Info.__post_init__) that must not round-trip
    return SystemInfo(
        info=Info(**{f.name: info.get(f.name, 0) for f in fields(Info)})
    )


class StorageHook(Hook):
    """The write-through event logic over an abstract KV store."""

    def id(self) -> str:
        return "storage-base"

    def provides(self, b: int) -> bool:
        return b in _PROVIDED

    # backends implement these four -----------------------------------------

    def _set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def _get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def _del(self, key: str) -> None:
        raise NotImplementedError

    def _iter(self, prefix: str) -> Iterable[bytes]:
        raise NotImplementedError

    # keys (badger.go:29-51) -------------------------------------------------

    @staticmethod
    def _client_key(cl) -> str:
        return CLIENT_KEY + "_" + cl.id

    @staticmethod
    def _sub_key(cl, filter: str) -> str:
        return SUBSCRIPTION_KEY + "_" + cl.id + ":" + filter

    @staticmethod
    def _retained_key(topic: str) -> str:
        return RETAINED_KEY + "_" + topic

    @staticmethod
    def _inflight_key(cl, pk: Packet) -> str:
        return INFLIGHT_KEY + "_" + cl.id + ":" + str(pk.packet_id)

    # events -----------------------------------------------------------------

    def _update_client(self, cl) -> None:
        props = cl.properties.props.copy(False)
        will = cl.properties.will
        record = Client(
            id=cl.id,
            remote=cl.net.remote,
            listener=cl.net.listener,
            username=cl.properties.username,
            clean=cl.properties.clean,
            protocol_version=cl.properties.protocol_version,
            properties=ClientProperties(
                session_expiry_interval=props.session_expiry_interval,
                session_expiry_interval_flag=props.session_expiry_interval_flag,
                authentication_method=props.authentication_method,
                authentication_data=props.authentication_data,
                request_problem_info=props.request_problem_info,
                request_problem_info_flag=props.request_problem_info_flag,
                request_response_info=props.request_response_info,
                receive_maximum=props.receive_maximum,
                topic_alias_maximum=props.topic_alias_maximum,
                user=props.user,
                maximum_packet_size=props.maximum_packet_size,
            ),
            will=ClientWill(
                payload=will.payload,
                user=will.user,
                topic_name=will.topic_name,
                flag=will.flag,
                will_delay_interval=will.will_delay_interval,
                qos=will.qos,
                retain=will.retain,
            ),
        )
        self._set(self._client_key(cl), dumps(record))

    def on_session_established(self, cl, pk: Packet) -> None:
        self._update_client(cl)

    def on_will_sent(self, cl, pk: Packet) -> None:
        self._update_client(cl)

    def on_disconnect(self, cl, err: Optional[Exception], expire: bool) -> None:
        self._update_client(cl)
        if not expire:
            return
        if cl.stop_cause == ERR_SESSION_TAKEN_OVER:
            return
        self._del(self._client_key(cl))

    def on_client_expired(self, cl) -> None:
        self._del(self._client_key(cl))

    def on_subscribed(self, cl, pk: Packet, reason_codes: bytes) -> None:
        for i, f in enumerate(pk.filters):
            record = Subscription(
                client=cl.id,
                qos=reason_codes[i],
                filter=f.filter,
                identifier=f.identifier,
                no_local=f.no_local,
                retain_handling=f.retain_handling,
                retain_as_published=f.retain_as_published,
                predicates=list(getattr(f, "predicates", ()) or ()),
            )
            self._set(self._sub_key(cl, f.filter), dumps(record))

    def on_unsubscribed(self, cl, pk: Packet) -> None:
        for f in pk.filters:
            self._del(self._sub_key(cl, f.filter))

    def _message_record(self, t: str, cl_id: str, pk: Packet, key: str) -> Message:
        props = pk.properties.copy(False)
        return Message(
            t=t,
            id=key,
            client=cl_id,
            origin=pk.origin,
            topic_name=pk.topic_name,
            payload=pk.payload,
            created=pk.created,
            packet_id=pk.packet_id,
            fixed_header_type=pk.fixed_header.type,
            qos=pk.fixed_header.qos,
            dup=pk.fixed_header.dup,
            retain=pk.fixed_header.retain,
            protocol_version=pk.protocol_version,
            expiry=pk.expiry,
            properties=MessageProperties(
                payload_format=props.payload_format,
                payload_format_flag=props.payload_format_flag,
                message_expiry_interval=props.message_expiry_interval,
                content_type=props.content_type,
                response_topic=props.response_topic,
                correlation_data=props.correlation_data,
                subscription_identifier=props.subscription_identifier,
                topic_alias=props.topic_alias,
                user=props.user,
            ),
        )

    def on_retain_message(self, cl, pk: Packet, r: int) -> None:
        key = self._retained_key(pk.topic_name)
        if r == -1:
            self._del(key)
            return
        self._set(key, dumps(self._message_record(RETAINED_KEY, cl.id if cl else "", pk, key)))

    def on_retained_expired(self, topic: str) -> None:
        self._del(self._retained_key(topic))

    def on_qos_publish(self, cl, pk: Packet, sent: int, resends: int) -> None:
        key = self._inflight_key(cl, pk)
        record = self._message_record(INFLIGHT_KEY, cl.id, pk, key)
        record.sent = sent
        self._set(key, dumps(record))

    def on_qos_complete(self, cl, pk: Packet) -> None:
        self._del(self._inflight_key(cl, pk))

    def on_qos_dropped(self, cl, pk: Packet) -> None:
        self.on_qos_complete(cl, pk)

    def on_sys_info_tick(self, info: Info) -> None:
        self._set(SYS_INFO_KEY, dumps(SystemInfo(info=info)))

    # restore readers --------------------------------------------------------

    def stored_clients(self) -> list:
        return [client_from_dict(_decode(json.loads(v))) for v in self._iter(CLIENT_KEY)]

    def stored_subscriptions(self) -> list:
        return [
            subscription_from_dict(_decode(json.loads(v)))
            for v in self._iter(SUBSCRIPTION_KEY)
        ]

    def stored_retained_messages(self) -> list:
        return [message_from_dict(_decode(json.loads(v))) for v in self._iter(RETAINED_KEY)]

    def stored_inflight_messages(self) -> list:
        return [message_from_dict(_decode(json.loads(v))) for v in self._iter(INFLIGHT_KEY)]

    def stored_sys_info(self):
        v = self._get(SYS_INFO_KEY)
        if v is None:
            return None
        return sys_info_from_dict(_decode(json.loads(v)))
