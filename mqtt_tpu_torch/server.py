"""The broker server, first cut: the options, the values the server hands
its clients, and the fan-out's selection and per-subscriber delivery.

Copies from the JAX package's ``server`` module: ``Compatibilities`` and
``Capabilities`` (server.go:46-93), ``Options`` cut to the fields that the
port's clients and fan-out read (with the JAX defaults), ``_Ops`` (the
values a ``Client`` reads: options, ``Info``, ``Hooks`` and the logger;
the overload governor, telemetry, the read-side scan gate and the QoS 0
fast publish stay ``None`` until the planes that set them are ported),
``_FrameCache`` (one encode per publish for every shared-frame target),
and the raw-frame parsers ``publish_frame_body_offset`` and
``publish_frame_topic``.

The fan-out's two steps are here as functions over ``_Ops``, so that the
next slice moves them into ``Server`` as its methods:
``fan_out_targets`` is the selection of ``Server._fan_out`` (a lazy view
consumed through ``targets()`` or materialized, the
``on_select_subscribers`` seam, ``select_shared``,
``merge_shared_selected``, the inline handlers), and ``publish_to_client``
with ``shared_frame_ok``, ``enqueue_frame`` and ``stamp_outbound`` is
``Server.publish_to_client`` (server.go:1023-1113) onto the client's
outbound queue. The predicate, encrypted and batched fan-out legs come
with ``Server``.

``Server`` itself (lifecycle, CONNECT, dispatch, QoS flows, listeners,
the auth and storage hooks) arrives in the next slice of the port.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import packets as pkts
from .hooks import Hooks
from .native import accel
from .packets import (
    CODE_DISCONNECT,
    ERR_NOT_AUTHORIZED,
    ERR_PENDING_CLIENT_WRITES_EXCEEDED,
    ERR_QUOTA_EXCEEDED,
    Code,
    Packet,
    Subscription,
)
from .system import Info
from .topics import NS_CHAR, ns_local
from .utils.loopwitness import DEFAULT_LOOP_PLANE as _LOOP_PLANE
from .utils.mempool import get_buffer, put_buffer

MAX_INT64 = (1 << 63) - 1
MAX_UINT32 = (1 << 32) - 1


@dataclass
class Compatibilities:
    """Compatibility-mode flags (server.go:86-93)."""

    obscure_not_authorized: bool = False
    passive_client_disconnect: bool = False
    always_return_response_info: bool = False
    restore_sys_info_on_restart: bool = False
    no_inherited_properties_on_ack: bool = False


@dataclass
class Capabilities:
    """Server features and limits (server.go:46-84)."""

    maximum_clients: int = MAX_INT64
    maximum_message_expiry_interval: int = 60 * 60 * 24
    maximum_client_writes_pending: int = 1024 * 8
    maximum_session_expiry_interval: int = MAX_UINT32
    maximum_packet_size: int = 0
    maximum_packet_id: int = 0xFFFF
    receive_maximum: int = 1024
    maximum_inflight: int = 1024 * 8
    topic_alias_maximum: int = 0xFFFF
    shared_sub_available: int = 1
    minimum_protocol_version: int = 3
    compatibilities: Compatibilities = field(default_factory=Compatibilities)
    maximum_qos: int = 2
    retain_available: int = 1
    wildcard_sub_available: int = 1
    sub_id_available: int = 1


@dataclass
class Options:
    """Configurable server options (server.go:96-131), cut to the fields
    the port's clients and fan-out read."""

    capabilities: Capabilities = field(default_factory=Capabilities)
    logger: Optional[logging.Logger] = None

    def ensure_defaults(self) -> None:
        """Sane defaults when unset (server.go:208-235)."""
        self.capabilities.maximum_packet_id = 0xFFFF  # spec maximum
        if self.capabilities.maximum_inflight == 0:
            self.capabilities.maximum_inflight = 1024 * 8
        if self.logger is None:
            self.logger = logging.getLogger("mqtt_tpu_torch")


def publish_frame_body_offset(frame: bytes) -> int:
    """Offset of a raw PUBLISH frame's variable header (skips the fixed
    header's remaining-length varint). The caller guarantees a frame the
    scanner accepted, so the varint terminates within 4 bytes."""
    off = 1
    while frame[off] & 0x80:
        off += 1
    return off + 1


def publish_frame_topic(frame: bytes):
    """``(topic, body_offset)`` parsed from a raw PUBLISH frame, or None
    when the frame is truncated or the topic is not valid UTF-8: the one
    shared parse for every fast-path delivery leg."""
    body_offset = publish_frame_body_offset(frame)
    n = len(frame)
    if body_offset + 2 > n:
        return None
    tl = (frame[body_offset] << 8) | frame[body_offset + 1]
    t0 = body_offset + 2
    if n < t0 + tl:
        return None
    try:
        return frame[t0 : t0 + tl].decode("utf-8"), body_offset
    except UnicodeDecodeError:
        return None


class _FrameCache:
    """One-encode-per-publish outbound frames for the QoS0 fan-out fast
    path: every eligible subscriber of a publish shares the same wire
    bytes, keyed by (protocol version, effective retain flag). The copy
    drops inbound topic aliases exactly like the per-subscriber slow path
    ([MQTT-3.3.2-7] via ``Packet.copy``)."""

    __slots__ = ("pk", "frames", "telemetry")

    def __init__(self, pk: "Packet", telemetry: Optional[Any] = None) -> None:
        self.pk = pk
        self.frames: dict[tuple[int, bool], bytes] = {}
        self.telemetry = telemetry

    def get(self, version: int, retain: bool) -> bytes:
        key = (version, bool(retain))
        data = self.frames.get(key)
        if data is None:
            # a real encode (cache hits share the bytes): fan-out
            # amplification accounting counts exactly these
            if self.telemetry is not None:
                self.telemetry.publish_encodes.inc()
            out = self.pk.copy(False)
            out.fixed_header.retain = bool(retain)
            out.protocol_version = version
            if out.expiry > 0:
                # the send-time expiry rewrite [MQTT-3.3.2-6], computed once
                # per publish instead of per subscriber write
                out.properties.message_expiry_interval = max(
                    1, out.expiry - int(time.time())
                )
            buf = get_buffer()
            try:
                pkts.ENCODERS[pkts.PUBLISH](out, buf)
                data = bytes(buf)
            finally:
                put_buffer(buf)
            self.frames[key] = data
        return data


class _Ops:
    """Server values propagated to clients (server.go:159-164).
    ``fast_publish`` is the server's QoS0 frame-passthrough entry point
    (None until the server wires it)."""

    def __init__(self, options: Options, info: Info, hooks: Hooks, log: logging.Logger) -> None:
        self.options = options
        self.info = info
        self.hooks = hooks
        self.log = log
        self.fast_publish: Optional[Callable[..., bool]] = None
        self.fast_publish_eligible: Optional[Callable[..., bool]] = None
        # the overload governor; None = ungoverned. Clients consult it
        # for the THROTTLE read-delay verdict.
        self.overload: Optional[Any] = None
        # the telemetry plane; None = uninstrumented. Clients consult it
        # for the publish stage clock and the sampled outbound queue-wait
        # stamps.
        self.telemetry: Optional[Any] = None
        # read-side scan coalescer (clients.ScanGate); None = per-socket
        # scans. The server sets it when its scan coalescing is on.
        self.scan_gate: Optional[Any] = None


def fan_out_targets(ops: _Ops, pk: Packet, subscribers, inline_client=None):
    """The delivery targets of one matched publish, ``(client id,
    Subscription)`` pairs, selected as ``Server._fan_out`` selects them
    (server.go:1000-1021): a lazy ``SubscribersView`` with no shared or
    inline entries is consumed through its ``targets()`` plan, any other
    is materialized; then the ``on_select_subscribers`` seam,
    ``select_shared`` unless a hook selected, ``merge_shared_selected``,
    and the inline handlers, called with ``inline_client``."""
    if type(subscribers) is accel().SubscribersView:
        if not subscribers.has_shared and not subscribers.has_inline:
            return subscribers.targets()
        subscribers = subscribers.materialize()
    if subscribers.shared:
        subscribers = ops.hooks.on_select_subscribers(subscribers, pk)
        if not subscribers.shared_selected:
            subscribers.select_shared()
        subscribers.merge_shared_selected()
    for inline_sub in subscribers.inline_subscriptions.values():
        inline_sub.handler(inline_client, inline_sub, pk)
    return subscribers.subscriptions.items()


def shared_frame_ok(props, sub: Subscription) -> bool:
    """Target eligibility for shared-frame delivery (nothing forces a
    per-subscriber rewrite of the encoded publish): no positive
    subscription identifiers, no outbound aliasing, no size cap."""
    ids = sub.identifiers
    return (
        props.props.topic_alias_maximum == 0
        and props.props.maximum_packet_size == 0
        and not (ids and any(v > 0 for v in ids.values()))
    )


def stamp_outbound(ops: _Ops, tcl) -> None:
    """Sampled outbound queue-wait accounting: every successful enqueue
    bumps the client's sequence; 1-in-N also records the enqueue time,
    and the write loop matches the sequence on dequeue to observe the
    wait."""
    st = tcl.state
    st.out_seq += 1
    tele = ops.telemetry
    if tele is not None and tele.sample_outbound():
        st.out_stamps.append((st.out_seq, time.perf_counter()))


def enqueue_frame(ops: _Ops, tcl, data: bytes, pk_source, count_delivery: bool = True) -> bool:
    """Queue a pre-encoded frame on a target's bounded outbound queue;
    False = dropped (queue full) with the shared drop accounting.
    ``pk_source()`` materializes the Packet for on_publish_dropped;
    ``count_delivery`` keeps $SYS housekeeping out of the fan-out
    accounting."""
    try:
        tcl.state.outbound.put_nowait(data)
        tcl.state.outbound_full_since = None
        stamp_outbound(ops, tcl)
        if count_delivery and ops.telemetry is not None:
            ops.telemetry.fanout_deliveries.inc()
        return True
    except asyncio.QueueFull:
        if tcl.state.outbound_full_since is None:
            # slow-consumer eviction clock (overload SHED posture)
            tcl.state.outbound_full_since = time.monotonic()
        ops.info.messages_dropped += 1
        ops.hooks.on_publish_dropped(tcl, pk_source())
        return False


def publish_to_client(ops: _Ops, cl, sub: Subscription, pk: Packet, fast: Optional[_FrameCache] = None) -> Packet:
    """Deliver one publish to one subscriber (server.go:1023-1113): onto
    its outbound queue, which its write loop drains.

    A namespace-scoped ``pk`` is delivered under its tenant-LOCAL topic:
    the ACL, aliasing, and the wire all see what the client subscribed
    to."""
    if sub.no_local and pk.origin == cl.id:
        return pk  # [MQTT-3.8.3-3]

    if _LOOP_PLANE.active:
        w = _LOOP_PLANE.witness
        if w is not None:
            eff = pk.fixed_header.qos
            if eff > sub.qos:
                eff = sub.qos
            if eff > 0 or cl.properties.props.topic_alias_maximum > 0:
                # this delivery mutates loop-affine per-client state
                # (packet ids / inflight / outbound aliases)
                w.check_owner("client_state", "owner_touch", cl.net.loop, detail=cl.id)
    topic = pk.topic_name
    if topic[:1] == NS_CHAR:
        topic = ns_local(topic)

    # zero-valued identifiers never reach the wire (properties.py encodes
    # only v > 0), so they don't disqualify the shared frame
    if fast is not None and shared_frame_ok(cl.properties, sub):
        if not ops.hooks.on_acl_check(cl, topic, False):
            raise ERR_NOT_AUTHORIZED()
        retain = pk.fixed_header.retain and (
            sub.fwd_retained_flag or (cl.properties.protocol_version == 5 and sub.retain_as_published)
        )
        data = fast.get(cl.properties.protocol_version, retain)
        if cl.net.writer is None or cl.closed:
            raise CODE_DISCONNECT()
        if not enqueue_frame(ops, cl, data, lambda: pk, count_delivery=not topic.startswith("$SYS")):
            raise ERR_PENDING_CLIENT_WRITES_EXCEEDED()
        return pk

    out = pk.copy(False)
    out.topic_name = topic
    if not ops.hooks.on_acl_check(cl, topic, False):
        raise ERR_NOT_AUTHORIZED()
    if not sub.fwd_retained_flag and (
        (cl.properties.protocol_version == 5 and not sub.retain_as_published)
        or cl.properties.protocol_version < 5
    ):  # ![MQTT-3.3.1-13] [v3 MQTT-3.3.1-9]
        out.fixed_header.retain = False  # [MQTT-3.3.1-12]

    if sub.identifiers:  # [MQTT-3.3.4-3]
        out.properties.subscription_identifier = sorted(sub.identifiers.values())  # [MQTT-3.3.4-4] ![MQTT-3.3.4-5]

    caps = ops.options.capabilities
    if out.fixed_header.qos > sub.qos:
        out.fixed_header.qos = sub.qos
    if out.fixed_header.qos > caps.maximum_qos:
        out.fixed_header.qos = caps.maximum_qos  # [MQTT-3.2.2-9]

    if cl.properties.props.topic_alias_maximum > 0:
        alias, alias_exists = cl.state.topic_aliases.outbound.set(topic)
        out.properties.topic_alias = alias
        if alias > 0:
            out.properties.topic_alias_flag = True
            if alias_exists:
                out.topic_name = ""

    if out.fixed_header.qos > 0:
        if len(cl.state.inflight) >= caps.maximum_inflight:
            ops.info.inflight_dropped += 1
            ops.log.warning("client store quota reached: client=%s listener=%s", cl.id, cl.net.listener)
            raise ERR_QUOTA_EXCEEDED()
        try:
            i = cl.next_packet_id()  # [MQTT-4.3.2-1] [MQTT-4.3.3-1]
        except Code:
            ops.hooks.on_packet_id_exhausted(cl, pk)
            ops.info.inflight_dropped += 1
            ops.log.warning("packet ids exhausted: client=%s listener=%s", cl.id, cl.net.listener)
            raise ERR_QUOTA_EXCEEDED() from None

        out.packet_id = i & 0xFFFF  # [MQTT-2.2.1-4]
        sent_quota = cl.state.inflight.send_quota

        if cl.state.inflight.set(out):  # [MQTT-4.3.2-3] [MQTT-4.3.3-3]
            ops.info.inflight += 1
            ops.hooks.on_qos_publish(cl, out, out.created, 0)
            cl.state.inflight.decrease_send_quota()

        if sent_quota == 0 and cl.state.inflight.maximum_send_quota > 0:
            out.expiry = -1  # mark for immediate resend once quota frees
            cl.state.inflight.set(out)
            return out

    if cl.net.writer is None or cl.closed:
        raise CODE_DISCONNECT()

    try:
        cl.state.outbound.put_nowait(out)
        cl.state.outbound_full_since = None
        stamp_outbound(ops, cl)
    except asyncio.QueueFull:
        if cl.state.outbound_full_since is None:
            # slow-consumer eviction clock (overload SHED posture)
            cl.state.outbound_full_since = time.monotonic()
        ops.info.messages_dropped += 1
        ops.hooks.on_publish_dropped(cl, pk)
        if out.fixed_header.qos > 0:
            cl.state.inflight.delete(out.packet_id)  # rollback inflight
            cl.state.inflight.increase_send_quota()
        raise ERR_PENDING_CLIENT_WRITES_EXCEEDED() from None

    return out


__all__ = [
    "Capabilities",
    "Compatibilities",
    "MAX_INT64",
    "MAX_UINT32",
    "Options",
    "enqueue_frame",
    "fan_out_targets",
    "publish_frame_body_offset",
    "publish_frame_topic",
    "publish_to_client",
    "shared_frame_ok",
    "stamp_outbound",
]
