"""Per-client connection state machine: buffered async reads, a single
writer task draining a bounded outbound queue, packet-id allocation,
keepalive deadlines, topic aliases, and session state.

Behavioral parity with reference ``clients.go``. The reference's
goroutine-per-connection becomes one asyncio reader task plus one writer
task per client; the bounded ``outbound`` channel becomes an
``asyncio.Queue`` whose ``put_nowait``-full path reproduces the reference's
drop-on-slow-consumer semantics (server.go:1099-1110).

A copy of the JAX package's module. ``Client.ops`` carries the server's
overload governor and telemetry plane (``server._Ops``; None when
switched off): the read loop counts each window's publishes for the
governor, takes its read delay and stamps the sampled publishes' decode
stage, and the write paths feed the amplification counters.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

from . import packets as pkts
from .inflight import Inflight
from .packets import (
    ERR_PACKET_TOO_LARGE,
    ERR_QUOTA_EXCEEDED,
    Code,
    FixedHeader,
    Packet,
    Properties,
    UserProperty,
)
from .topics import OutboundTopicAliases, Subscriptions, TopicAliases
from .utils import LockedMap
from .utils.loopwitness import DEFAULT_LOOP_PLANE as _LOOP_PLANE
from .utils.mempool import get_buffer, put_buffer

DEFAULT_KEEPALIVE = 10  # default connection keepalive seconds (clients.go:25)
DEFAULT_CLIENT_PROTOCOL_VERSION = 4  # (clients.go:26)
MINIMUM_KEEPALIVE = 5  # below this a warning is logged (clients.go:27)


class ConnectionClosedError(Exception):
    """The client connection is not open (reference ErrConnectionClosed)."""


class OutboundQueue:
    """A thread-safe bounded outbound queue with asyncio.Queue's
    data-plane surface (``put_nowait``/``QueueFull``, awaitable
    ``get``, ``full``/``qsize``/``empty``).

    asyncio.Queue is loop-affine: ``put_nowait`` wakes waiters with a
    plain ``call_soon``, which is illegal from any other thread. Under
    an event-loop shard fabric a publisher's fan-out
    runs on ITS shard's loop and enqueues onto subscribers owned by
    OTHER shards — so the queue itself goes thread-safe: a lock-guarded
    deque plus a single-consumer wakeup future that cross-thread
    producers resolve via ``call_soon_threadsafe`` on the consumer's
    loop. Single-loop brokers pay one uncontended lock acquire per
    enqueue/dequeue and keep identical semantics.
    """

    __slots__ = ("maxsize", "_items", "_lock", "_waiter", "_witness_loop")

    def __init__(self, maxsize: int = 0) -> None:
        self.maxsize = maxsize
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        # the single consumer's parked (loop, future), or None; the
        # write loop is the only get() caller, so one slot suffices
        self._waiter: Optional[tuple] = None
        # owning-loop identity stamped by the first witnessed get()
        # (utils.loopwitness); None while unobserved/disarmed
        self._witness_loop: Optional[asyncio.AbstractEventLoop] = None

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)

    @staticmethod
    def _wake(fut: "asyncio.Future") -> None:
        if not fut.done():
            fut.set_result(None)

    def put_nowait(self, item: Any) -> None:
        """Enqueue from ANY thread; raises ``asyncio.QueueFull`` past
        the bound (the drop-on-slow-consumer contract is unchanged)."""
        plane = _LOOP_PLANE
        if plane.active:
            w = plane.witness
            if w is not None:
                w.note_crossing(
                    "outbound_queue", "put_local", "put_cross",
                    self._witness_loop,
                )
        wake = None
        with self._lock:
            if 0 < self.maxsize <= len(self._items):
                raise asyncio.QueueFull()
            self._items.append(item)
            if self._waiter is not None:
                wake, self._waiter = self._waiter, None
        if wake is not None:
            loop, fut = wake
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if loop is running:
                self._wake(fut)
            else:
                try:
                    loop.call_soon_threadsafe(self._wake, fut)
                except RuntimeError:
                    pass  # consumer loop closed; the writer task is gone

    async def get(self) -> Any:
        """Dequeue (single consumer: the client's write loop)."""
        plane = _LOOP_PLANE
        if plane.active:
            w = plane.witness
            if w is not None:
                if self._witness_loop is None:
                    self._witness_loop = asyncio.get_running_loop()
                w.check_owner(
                    "outbound_queue", "get_owner", self._witness_loop
                )
        while True:
            with self._lock:
                if self._items:
                    return self._items.popleft()
                loop = asyncio.get_running_loop()
                fut: asyncio.Future = loop.create_future()
                self._waiter = (loop, fut)
            try:
                await fut
            except asyncio.CancelledError:
                with self._lock:
                    if self._waiter is not None and self._waiter[1] is fut:
                        self._waiter = None
                raise


class ScanGate:
    """Coalesce frame scans from read loops that wake in the same
    event-loop tick into ONE native multi-buffer call (read-side decode
    batching: mqtt_native.mqtt_frame_scan_multi).

    Read loops register their buffer and await a future; a
    ``call_soon`` flush runs after every currently-ready callback (i.e.
    after every read loop that woke this tick has registered), scans
    all buffers in one GIL-released pass, and resolves the futures.
    Single-scanner ticks pay one loop-callback hop and nothing else. A
    failed native build fails every pending scan with ``NativeError``
    (the JAX package falls back to per-buffer Python scans). Opt-in: the
    server sets it on ``ops.scan_gate`` or a client's ``scan_gate``."""

    def __init__(self) -> None:
        self._pending: list = []
        self._scheduled = False
        self.batches = 0  # flush calls issued (observability)
        self.scans = 0  # buffers scanned through the gate

    def scan(
        self, buf: bytearray, max_frames: int, max_packet_size: int
    ) -> "asyncio.Future":
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((buf, fut))
        self._max_frames = max_frames
        self._max_packet_size = max_packet_size
        if not self._scheduled:
            self._scheduled = True
            loop.call_soon(self._flush)
        return fut

    def _flush(self) -> None:
        from .native import frame_scan_multi

        self._scheduled = False
        pending, self._pending = self._pending, []
        if not pending:
            return
        self.batches += 1
        self.scans += len(pending)
        try:
            results = frame_scan_multi(
                [buf for buf, _ in pending],
                max_frames=self._max_frames,
                max_packet_size=self._max_packet_size,
            )
        except Exception as e:
            for _buf, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_buf, fut), res in zip(pending, results):
            if not fut.done():
                fut.set_result(res)


@dataclass
class Will:
    """Last will and testament details (clients.go:132-140)."""

    payload: bytes = b""
    user: list[UserProperty] = field(default_factory=list)
    topic_name: str = ""
    flag: int = 0  # 0/1; cleared once the will is sent
    will_delay_interval: int = 0
    qos: int = 0
    retain: bool = False


class ClientConnection:
    """Transport state for one client (clients.go:113-120)."""

    def __init__(
        self,
        reader: Optional[asyncio.StreamReader] = None,
        writer: Optional[asyncio.StreamWriter] = None,
    ) -> None:
        self.reader = reader
        self.writer = writer
        self.remote = ""
        self.listener = ""
        self.inline = False
        # the asyncio loop OWNING this transport (set at attach): under
        # the shard fabric every transport write/close must happen on
        # it; None (inline clients, unattached tests) means loop-local
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        if writer is not None:
            peer = writer.get_extra_info("peername")
            if peer:
                self.remote = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else str(peer)


class ClientProperties:
    """Properties defining client behaviour (clients.go:123-129)."""

    def __init__(self) -> None:
        self.props = Properties()
        self.will = Will()
        self.username = b""
        self.protocol_version = DEFAULT_CLIENT_PROTOCOL_VERSION
        self.clean = False


class ClientState:
    """Operational state of one client (clients.go:143-158)."""

    def __init__(self, topic_alias_maximum: int, max_writes_pending: int) -> None:
        self.topic_aliases = TopicAliases(topic_alias_maximum)
        self.inflight = Inflight()
        self.subscriptions = Subscriptions()  # filter -> Subscription (client mirror)
        self.disconnected = 0  # unix ts of disconnect, for expiry
        # Packet on the per-subscriber path, raw bytes on the shared
        # QoS0 frame fast path (clients._write_loop dispatches on type);
        # thread-safe so a fan-out on another loop can enqueue directly
        self.outbound: OutboundQueue = OutboundQueue(
            maxsize=max_writes_pending
        )
        self.keepalive = DEFAULT_KEEPALIVE
        self.server_keepalive = False
        self.packet_id = 0  # current highest allocated packet id
        self.stop_cause: Optional[Exception] = None
        self.is_taken_over = False
        self.open = True
        # monotonic ts the outbound queue was first found full (None =
        # not full); the overload governor's slow-consumer eviction
        # sweep compares it against the grace window
        self.outbound_full_since: Optional[float] = None
        # monotonic ts the client's backlog (transport write buffer past
        # its limit, or a still-full outbound queue) was first observed
        # by the overload sweep; cleared the moment it drains
        self.backlog_over_since: Optional[float] = None
        # transport buffer size at the last overload sweep: a consumer
        # whose buffer SHRANK since then is draining (slow, not stalled)
        # and must not accumulate eviction grace
        self.sweep_buffered = 0
        # outbound queue-wait sampling (server._stamp_outbound): every
        # successful enqueue bumps out_seq, sampled enqueues park (seq, t) here and
        # the write loop matches out_deq against the head to observe the
        # wait. Bounded: evicted stamps are just lost samples.
        self.out_seq = 0
        self.out_deq = 0
        self.out_stamps: collections.deque = collections.deque(maxlen=64)
        # write-path accounting: bytes and socket-write calls this
        # client's outbound legs have issued, the per-client face of the
        # aggregate outbound bytes and writes counters
        self.out_bytes = 0
        self.out_writes = 0

    @property
    def outbound_qty(self) -> int:
        """Queued outbound publishes — delegated to the thread-safe
        queue's own count. A bare ``+=`` mirror would lose updates when
        other loops' threads enqueue concurrently, and this
        count gates the direct-socket flush eligibility
        (server._flush_variant), where an undercount could reorder
        frames past still-queued ones."""
        return self.outbound.qsize()


class Client:
    """A client known by the broker (clients.go:103-110)."""

    def __init__(self, reader, writer, ops) -> None:
        self.ops = ops
        self.id = ""
        self.properties = ClientProperties()
        self.state = ClientState(
            ops.options.capabilities.topic_alias_maximum,
            ops.options.capabilities.maximum_client_writes_pending,
        )
        self.net = ClientConnection(reader, writer)
        self._deadline: Optional[float] = None  # monotonic keepalive deadline
        self._writer_task: Optional[asyncio.Task] = None
        # per-evaluation-window publish counter for the overload
        # governor's THROTTLE read-delay verdict;
        # the read loop counts, read_delay() resets on window roll
        self._pub_epoch = -1
        self._pub_count = 0
        # priority-weighted shedding (the overload governor): the class and
        # its shed/publish-quota multiplier, resolved at CONNECT from
        # Options.overload_priority_users / overload_priority_classes
        # (server._assign_priority_class); 1.0 = the flat default. The
        # governor reads the weight on every admit/read_delay verdict,
        # so it lives here as a plain attribute, not a config lookup.
        self.priority_class = ""
        self.priority_weight = 1.0
        # the tenant this client resolved to at CONNECT
        # (tenancy.Tenant) or None for the global namespace;
        # set once by server._resolve_tenant, read on every publish /
        # subscribe to decide namespace scoping
        self.tenant: Optional[Any] = None
        # the owning shard's read-side ScanGate: set
        # at attach when the fabric is on; None falls back to the
        # server-wide gate (ops.scan_gate) or per-socket scans
        self.scan_gate: Optional[ScanGate] = None
        # the attach-handler task serving this connection (set by
        # server.attach_client): the cross-shard takeover quiesce
        # awaits it on the owning loop so the old session's disconnect
        # epilogue fully runs before state migrates
        self._handler_task: Optional[asyncio.Task] = None

    # -- lifecycle ---------------------------------------------------------

    def start_write_loop(self) -> None:
        """Spawn the single writer task draining the outbound queue
        (clients.go:192-205)."""
        self._writer_task = asyncio.get_running_loop().create_task(self._write_loop())

    async def _write_loop(self) -> None:
        st = self.state
        while True:
            pk = await st.outbound.get()
            st.out_deq += 1
            stamps = st.out_stamps
            if stamps:
                # resync past stamps evicted by the deque bound, then
                # observe the matching sampled enqueue's queue wait
                while stamps and stamps[0][0] < st.out_deq:
                    stamps.popleft()
                if stamps and stamps[0][0] == st.out_deq:
                    _, t0 = stamps.popleft()
                    tele = getattr(self.ops, "telemetry", None)
                    if tele is not None:
                        tele.outbound_wait.observe(time.perf_counter() - t0)
            try:
                if type(pk) is bytes:  # pre-encoded qos0 fan-out frame
                    self.write_frame(pk)
                else:
                    self.write_packet(pk)
            except Exception as e:
                self.ops.log.debug("failed publishing packet to %s: %s", self.id, e)

    def write_frame(self, data: bytes) -> None:
        """Write a pre-encoded PUBLISH frame (the server's qos0 fan-out
        fast path — shared bytes, one encode per publish). The fast path
        is disabled whenever on_packet_encode/on_packet_sent hooks are
        attached, so skipping them here never hides a hook call."""
        if self.closed:
            raise ConnectionClosedError()
        if self.net.writer is None:
            return
        self.net.writer.write(data)
        self.ops.info.bytes_sent += len(data)
        self.ops.info.packets_sent += 1
        self.ops.info.messages_sent += 1
        st = self.state
        st.out_bytes += len(data)
        st.out_writes += 1
        tele = getattr(self.ops, "telemetry", None)
        if tele is not None:
            # io accounting only here: the DELIVERY count for a shared
            # frame is stamped by server._enqueue_frame, which still
            # knows the topic (this pre-encoded frame does not) and so
            # can keep $SYS housekeeping out of the amplification math
            tele.outbound_bytes.inc(len(data))
            tele.outbound_writes.inc()

    def parse_connect(self, lid: str, pk: Packet) -> None:
        """Absorb CONNECT parameters into client state (clients.go:208-257)."""
        self.net.listener = lid
        self.properties.protocol_version = pk.protocol_version
        self.properties.username = pk.connect.username
        self.properties.clean = pk.connect.clean
        self.properties.props = pk.properties.copy(False)

        caps = self.ops.options.capabilities
        if self.properties.props.receive_maximum > caps.maximum_inflight:  # 3.3.4 Non-normative
            self.properties.props.receive_maximum = caps.maximum_inflight

        if 0 < pk.connect.keepalive <= MINIMUM_KEEPALIVE:
            # keepalive 0 DISABLES the mechanism [MQTT-3.1.2-22] — a
            # deliberate choice (mostly-idle device fleets), not a
            # too-small value worth one warning per ramped connection
            self.ops.log.warning(
                "client keepalive is below minimum recommended value: client=%s keepalive=%d recommended=%d",
                self.id,
                pk.connect.keepalive,
                MINIMUM_KEEPALIVE,
            )

        self.state.keepalive = pk.connect.keepalive  # [MQTT-3.2.2-22]
        self.state.inflight.reset_receive_quota(caps.receive_maximum)  # server per-client max
        self.state.inflight.reset_send_quota(self.properties.props.receive_maximum)  # client max
        self.state.topic_aliases.outbound = OutboundTopicAliases(
            self.properties.props.topic_alias_maximum
        )

        self.id = pk.connect.client_identifier
        if self.id == "":
            self.id = uuid.uuid4().hex[:20]  # [MQTT-3.1.3-6] [MQTT-3.1.3-7]
            self.properties.props.assigned_client_id = self.id

        if pk.connect.will_flag:
            self.properties.will = Will(
                qos=pk.connect.will_qos,
                retain=pk.connect.will_retain,
                payload=pk.connect.will_payload,
                topic_name=pk.connect.will_topic,
                will_delay_interval=pk.connect.will_properties.will_delay_interval,
                user=pk.connect.will_properties.user,
                flag=1,
            )
            if (
                pk.properties.session_expiry_interval_flag
                and pk.properties.session_expiry_interval
                < pk.connect.will_properties.will_delay_interval
            ):
                self.properties.will.will_delay_interval = pk.properties.session_expiry_interval

    def refresh_deadline(self, keepalive: int) -> None:
        """Arm the read deadline at keepalive x 1.5 [MQTT-3.1.2-22]
        (clients.go:260-269); 0 disables it."""
        self._deadline = time.monotonic() + keepalive * 1.5 if keepalive > 0 else None

    def next_packet_id(self) -> int:
        """The next unused packet id; raises ERR_QUOTA_EXCEEDED when all ids
        are inflight (clients.go:274-299)."""
        i = self.state.packet_id
        started = i
        overflowed = False
        maximum = self.ops.options.capabilities.maximum_packet_id
        while True:
            if overflowed and i == started:
                raise ERR_QUOTA_EXCEEDED()
            if i >= maximum:
                overflowed = True
                i = 0
                continue
            i += 1
            if self.state.inflight.get(i & 0xFFFF) is None:
                self.state.packet_id = i
                return i

    def resend_inflight_messages(self, force: bool) -> None:
        """Resend pending inflight messages with DUP [MQTT-3.3.1-1/-3]
        (clients.go:302-327)."""
        if len(self.state.inflight) == 0:
            return
        for tk in self.state.inflight.get_all(False):
            if tk.fixed_header.type == pkts.PUBLISH:
                tk.fixed_header.dup = True
            self.ops.hooks.on_qos_publish(self, tk, tk.created, 0)
            self.write_packet(tk)
            if tk.fixed_header.type in (pkts.PUBACK, pkts.PUBCOMP):
                if self.state.inflight.delete(tk.packet_id):
                    self.ops.hooks.on_qos_complete(self, tk)
                    self.ops.info.inflight -= 1

    def clear_inflights(self) -> None:
        """Drop all inflight messages, e.g. clean-session disconnect
        (clients.go:330-337)."""
        for tk in self.state.inflight.get_all(False):
            if self.state.inflight.delete(tk.packet_id):
                self.ops.hooks.on_qos_dropped(self, tk)
                self.ops.info.inflight -= 1

    def clear_expired_inflights(self, now: int, maximum_expiry: int) -> list[int]:
        """Drop expired inflight messages [MQTT-3.3.2-5] (clients.go:340-359)."""
        deleted = []
        for tk in self.state.inflight.get_all(False):
            expired = tk.protocol_version == 5 and 0 < tk.expiry < now
            enforced = maximum_expiry > 0 and now - tk.created > maximum_expiry
            if expired or enforced:
                if self.state.inflight.delete(tk.packet_id):
                    self.ops.hooks.on_qos_dropped(self, tk)
                    self.ops.info.inflight -= 1
                    deleted.append(tk.packet_id)
        return deleted

    async def read(self, packet_handler: Callable[["Client", Packet], Optional[Awaitable]]) -> None:
        """The blocking per-packet read loop (clients.go:363-388); raises on
        connection error, keepalive timeout, or a handler error.

        Packets are framed in bulk: each socket read drains everything
        available, the native frame scanner (``native.frame_scan``) splits
        it into complete packets, and each is decoded straight from the
        buffer: one await per socket read instead of one per header byte.
        """
        from .native import MAX_FRAMES_PER_SCAN, frame_scan, varint_decode

        caps = self.ops.options.capabilities
        fast_eligible = self.ops.fast_publish_eligible
        fast_publish = self.ops.fast_publish
        telemetry = getattr(self.ops, "telemetry", None)
        # the shard's own gate wins (per-shard decode batching is
        # default-on inside the fabric); the server-wide gate serves the
        # single-loop opt-in (ops.scan_gate)
        scan_gate = self.scan_gate or getattr(self.ops, "scan_gate", None)
        rbuf = bytearray()
        deferred: Optional[list] = None
        self.refresh_deadline(self.state.keepalive)
        while True:
            if self.closed:
                return
            if scan_gate is not None:
                # read-side decode batching: every read loop
                # that woke this tick lands in ONE native scan call
                frames, consumed, err = await scan_gate.scan(
                    rbuf, MAX_FRAMES_PER_SCAN, caps.maximum_packet_size
                )
            else:
                frames, consumed, err = frame_scan(
                    rbuf, max_frames=MAX_FRAMES_PER_SCAN,
                    max_packet_size=caps.maximum_packet_size,
                )
            # account for and process every complete packet
            start = 0
            for f in frames:
                fstart = start
                fend = f.body_offset + f.remaining
                self.ops.info.bytes_received += (f.body_offset - start) + f.remaining
                start = fend
                if (f.first_byte >> 4) == pkts.PUBLISH:
                    # overload-governor accounting: publishes this window
                    # (both the fast-path and decode legs land here)
                    self._pub_count += 1
                # QoS0 v4 PUBLISH passthrough (flags all zero): deliver the
                # frame bytes without materializing a Packet when the
                # server proves nothing can observe the difference. The
                # session gate runs BEFORE any bytes are copied.
                if (
                    f.first_byte == 0x30
                    and fast_publish is not None
                    and fast_eligible(self)
                ):
                    frame = bytes(rbuf[fstart:fend])
                    if fast_publish(self, frame, f.body_offset - fstart):
                        continue
                    body = frame[f.body_offset - fstart :]
                else:
                    body = bytes(rbuf[f.body_offset : fend])
                # telemetry stage clock: 1-in-N publishes get stamped
                # through decode -> admission -> staging -> fanout; the
                # clock rides on the packet
                clock = None
                if telemetry is not None and (f.first_byte >> 4) == pkts.PUBLISH:
                    clock = telemetry.publish_clock()
                fh = FixedHeader()
                fh.decode(f.first_byte)
                fh.remaining = f.remaining
                pk = self._decode_body(fh, body)
                if clock is not None:
                    clock.stamp("decode")
                    # dynamic rider, not a Packet field: the clock never
                    # touches the wire or dataclass equality
                    setattr(pk, "_tclock", clock)
                result = packet_handler(self, pk)
                if asyncio.iscoroutine(result):
                    # deferred (staged-publish) completions: schedule now,
                    # await after the whole scan — every publish in this
                    # socket read reaches the staging batch before we block
                    # on any of them, so one pipelining client still fills
                    # device batches instead of paying a round trip each
                    if deferred is None:
                        deferred = []
                    deferred.append(asyncio.get_running_loop().create_task(result))
                if self.closed:
                    break
            if deferred is not None:
                err0: Optional[BaseException] = None
                for t in deferred:
                    try:
                        await t
                    except BaseException as e:
                        err0 = err0 or e
                deferred = None
                if err0 is not None:
                    raise err0
            if self.closed:
                return
            del rbuf[:consumed]
            if err == -2:
                raise ERR_PACKET_TOO_LARGE()  # [MQTT-3.2.2-15]
            if err == -1:
                # replay the per-byte path for the precise reason code
                FixedHeader().decode(rbuf[0])  # raises for bad header bytes
                raise pkts.ERR_MALFORMED_VARIABLE_BYTE_INTEGER()
            if len(frames) == MAX_FRAMES_PER_SCAN:
                continue  # more complete packets may still be buffered
            if frames:
                # progress made — extend the keepalive deadline. A trickle
                # of partial-packet bytes deliberately does NOT extend it.
                self.refresh_deadline(self.state.keepalive)
            overload = self.ops.overload
            if overload is not None and not self.net.inline:
                # THROTTLE lever: an over-quota publisher's next socket
                # read is delayed, so the kernel's TCP window pushes
                # back on it — the QoS0 analog of v5 receive-maximum
                delay = overload.read_delay(self)
                if delay > 0:
                    await asyncio.sleep(delay)
            data = await self._read_more(self._missing_bytes(rbuf, varint_decode))
            if not data:
                raise ConnectionClosedError()
            rbuf += data

    @staticmethod
    def _missing_bytes(rbuf: bytearray, varint_decode) -> int:
        """How many more bytes complete the partial packet at the head of
        the buffer (0 = unknown): lets a huge body arrive in one readexactly
        instead of 64 KiB nibbles that would rescan the buffer each time."""
        if len(rbuf) < 2:
            return 0
        try:
            remaining, vb = varint_decode(bytes(rbuf[1:5]))
        except ValueError:
            return 0
        if vb == 0:
            return 0
        return max(0, 1 + vb + remaining - len(rbuf))

    def _decode_body(self, fh: FixedHeader, body: bytes) -> Packet:
        """Decode one framed packet body and run the on_packet_read chain
        (the bulk-path core of read_packet, clients.go:462-520)."""
        self.ops.info.packets_received += 1
        pk = Packet(fixed_header=fh, protocol_version=self.properties.protocol_version)
        decoder = pkts.DECODERS.get(fh.type)
        if decoder is None:
            raise pkts.ERR_NO_VALID_PACKET_AVAILABLE()
        decoder(pk, body)
        if fh.type == pkts.PUBLISH:
            self.ops.info.messages_received += 1
        return self.ops.hooks.on_packet_read(self, pk)

    async def _read_more(self, need: int = 0) -> bytes:
        """One bulk socket read honoring the keepalive deadline. ``need``>0
        waits for exactly that many bytes (completing a known partial
        packet); otherwise reads whatever is available up to 64 KiB."""
        if self.net.reader is None:
            raise ConnectionClosedError()
        if need > 0:
            coro = self.net.reader.readexactly(need)
        else:
            coro = self.net.reader.read(65536)
        if self._deadline is None:
            return await coro
        timeout = self._deadline - time.monotonic()
        if timeout <= 0:
            coro.close()
            raise asyncio.TimeoutError()
        return await asyncio.wait_for(coro, timeout)

    def stop(self, err: Optional[Exception] = None) -> None:
        """Idempotently end the client: close the transport, cancel the
        writer task, record the stop cause and time (clients.go:391-407).

        Task.cancel and transport.close are loop-affine: when another
        shard's loop owns this connection (cross-shard takeover, the
        main loop's drain) the teardown is marshaled to the owner via
        ``call_soon_threadsafe``; the closed flag flips immediately
        either way, so every data-plane gate sees the stop at once."""
        if not self.state.open:
            return
        self.state.open = False
        if err is not None:
            self.state.stop_cause = err
        loop = self.net.loop
        marshaled = False
        if loop is not None and loop.is_running():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if loop is not running:
                try:
                    loop.call_soon_threadsafe(self._stop_teardown)
                    marshaled = True
                except RuntimeError:
                    marshaled = False  # owner loop died first
        if not marshaled:
            self._stop_teardown()
        # brokerlint: ok=R3 session-expiry bookkeeping is wall-clock (persists across restarts)
        self.state.disconnected = int(time.time())

    def _stop_teardown(self) -> None:
        """The loop-affine half of stop(): cancel the writer task and
        close the transport on the loop that owns them."""
        if self._writer_task is not None:
            self._writer_task.cancel()
        if self.net.writer is not None:
            try:
                self.net.writer.close()
            except Exception:  # brokerlint: ok=R4 teardown; the transport is already dead and close() has no one to report to
                pass

    @property
    def stop_cause(self) -> Optional[Exception]:
        return self.state.stop_cause

    @property
    def stop_time(self) -> int:
        return self.state.disconnected

    @property
    def closed(self) -> bool:
        return not self.state.open

    @property
    def is_taken_over(self) -> bool:
        return self.state.is_taken_over

    # -- wire io -----------------------------------------------------------

    async def _read_exactly(self, n: int) -> bytes:
        if self.net.reader is None:
            raise ConnectionClosedError()
        if self._deadline is None:
            return await self.net.reader.readexactly(n)
        timeout = self._deadline - time.monotonic()
        if timeout <= 0:
            raise asyncio.TimeoutError()
        return await asyncio.wait_for(self.net.reader.readexactly(n), timeout)

    async def read_fixed_header(self, fh: FixedHeader) -> None:
        """Read and validate the next packet's fixed header, enforcing the
        maximum packet size [MQTT-3.2.2-15] (clients.go:432-459)."""
        b = await self._read_exactly(1)
        fh.decode(b[0])
        remaining = 0
        multiplier = 0
        bu = 1
        while True:
            eb = (await self._read_exactly(1))[0]
            bu += 1
            remaining |= (eb & 127) << multiplier
            if remaining > pkts.MAX_VARINT:
                raise pkts.ERR_MALFORMED_VARIABLE_BYTE_INTEGER()
            if (eb & 128) == 0:
                break
            multiplier += 7
        fh.remaining = remaining
        caps = self.ops.options.capabilities
        if caps.maximum_packet_size > 0 and remaining + 1 > caps.maximum_packet_size:
            raise ERR_PACKET_TOO_LARGE()  # [MQTT-3.2.2-15]
        self.ops.info.bytes_received += bu

    async def read_packet(self, fh: FixedHeader) -> Packet:
        """Read and decode a packet body, then run the on_packet_read
        modifier chain (clients.go:462-520)."""
        self.ops.info.packets_received += 1
        pk = Packet(fixed_header=fh, protocol_version=self.properties.protocol_version)
        body = await self._read_exactly(fh.remaining) if fh.remaining else b""
        self.ops.info.bytes_received += len(body)
        decoder = pkts.DECODERS.get(fh.type)
        if decoder is None:
            raise pkts.ERR_NO_VALID_PACKET_AVAILABLE()
        decoder(pk, body)
        if fh.type == pkts.PUBLISH:
            self.ops.info.messages_received += 1
        return self.ops.hooks.on_packet_read(self, pk)

    def write_packet(self, pk: Packet) -> None:
        """Encode and write a packet to the client transport
        (clients.go:523-642)."""
        if self.closed:
            raise ConnectionClosedError()
        if self.net.writer is None:
            return
        if pk.expiry > 0:
            expiry = pk.expiry - int(time.time())  # brokerlint: ok=R3 message expiry is an absolute wall-clock stamp
            if expiry < 1:
                expiry = 1
            pk.properties.message_expiry_interval = expiry  # [MQTT-3.3.2-6]

        pk.protocol_version = self.properties.protocol_version
        if pk.mods.max_size == 0:  # NB used to embed client packet sizes in tests
            pk.mods.max_size = self.properties.props.maximum_packet_size

        if (
            self.properties.props.request_problem_info_flag
            and self.properties.props.request_problem_info == 0
        ):
            pk.mods.disallow_problem_info = True  # [MQTT-3.1.2-29]

        if (
            pk.fixed_header.type != pkts.CONNACK
            or self.properties.props.request_response_info == 1
            or self.ops.options.capabilities.compatibilities.always_return_response_info
        ):
            pk.mods.allow_response_info = True  # [MQTT-3.1.2-28]

        pk = self.ops.hooks.on_packet_encode(self, pk)

        buf = get_buffer()
        try:
            pkts.ENCODERS[pk.fixed_header.type](pk, buf)
            if pk.mods.max_size > 0 and len(buf) > pk.mods.max_size:
                raise ERR_PACKET_TOO_LARGE()  # [MQTT-3.1.2-24] [MQTT-3.1.2-25]
            data = bytes(buf)
        finally:
            put_buffer(buf)

        self.net.writer.write(data)

        self.ops.info.bytes_sent += len(data)
        self.ops.info.packets_sent += 1
        st = self.state
        st.out_bytes += len(data)
        st.out_writes += 1
        tele = getattr(self.ops, "telemetry", None)
        if tele is not None:
            tele.outbound_bytes.inc(len(data))
            tele.outbound_writes.inc()
        if pk.fixed_header.type == pkts.PUBLISH:
            self.ops.info.messages_sent += 1
            if tele is not None and not pk.topic_name.startswith("$SYS"):
                # a per-subscriber encode: the amplification numerator
                # (an encode-once fan-out drives this to ~1 per inbound
                # publish). $SYS housekeeping fan-out is
                # excluded — it recurs every interval with no inbound
                # publish behind it and would inflate the ratio without
                # bound; retained deliveries and QoS retransmits DO
                # count (they are real write-path encode work).
                tele.publish_encodes.inc()
                tele.fanout_deliveries.inc()
        self.ops.hooks.on_packet_sent(self, pk, data)


class Clients(LockedMap[str, Client]):
    """Clients known by the broker, keyed on client id (clients.go:36-100).

    Lock-plane adopted (utils.locked): every fan-out delivery
    does a ``get`` per subscriber, so this is the hottest single lock in
    the broker."""

    def __init__(self) -> None:
        super().__init__(name="clients")

    def add_client(self, cl: Client) -> None:
        self.add(cl.id, cl)

    def get_by_listener(self, id_: str) -> list[Client]:
        with self._lock:
            return [
                c for c in self.internal.values() if c.net.listener == id_ and not c.closed
            ]
