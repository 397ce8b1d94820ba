"""An in-repo mqtt-stresser analog: broker-level publish/receive throughput.

A copy of the JAX package's ``mqtt_tpu/stress.py`` over the port's codec,
broker and cluster, with the same flags and environment names
(``MQTT_TPU_WORKER``, ``MQTT_TPU_WORKER_PORTS``, ``MQTT_TPU_LINK_SHAPE``
and the rest), plus ``--device``: the card the served broker's device
planes run on ("cuda" by default; ``--serve`` exits at start, naming
CUDA, where there is no card). Each cluster worker the launcher spawns
opens its own CUDA context. One departure: a served broker (and the
cluster launcher) also stops, and exits 0, on SIGTERM, where the JAX one
stops only when its stdin closes.

The reference's headline broker benchmark is mqtt-stresser: N concurrent
clients, each subscribed to its own topic, publishing M QoS0 messages and
receiving them back; per-client publish and receive rates are aggregated
as min/median/max. This module reproduces that workload over real TCP
sockets using this package's own codec, so the numbers exercise the full
data plane: framing, decode, ACL hook, trie match, per-subscriber
copy/encode, bounded outbound queue, write coalescing.

Usage:
    python -m mqtt_tpu_torch.stress --serve --device-matcher   # the broker
    python -m mqtt_tpu_torch.stress --broker 127.0.0.1:1883 -c 10 -m 1000
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import time

from .packets import (
    CONNACK,
    CONNECT,
    PUBLISH,
    SUBACK,
    SUBSCRIBE,
    ConnectParams,
    FixedHeader,
    Packet,
    Subscription,
    encode_packet,
)


def _connect_bytes(client_id: str, version: int = 4, keepalive: int = 120) -> bytes:
    return encode_packet(
        Packet(
            fixed_header=FixedHeader(type=CONNECT),
            protocol_version=version,
            connect=ConnectParams(
                protocol_name=b"MQTT",
                clean=True,
                keepalive=keepalive,
                client_identifier=client_id,
            ),
        )
    )


def _subscribe_bytes(pid: int, topic: str, qos: int = 0) -> bytes:
    return encode_packet(
        Packet(
            fixed_header=FixedHeader(type=SUBSCRIBE, qos=1),
            protocol_version=4,
            packet_id=pid,
            filters=[Subscription(filter=topic, qos=qos)],
        )
    )


def _publish_bytes(topic: str, payload: bytes, qos: int = 0, pid: int = 0) -> bytes:
    return encode_packet(
        Packet(
            fixed_header=FixedHeader(type=PUBLISH, qos=qos),
            protocol_version=4,
            topic_name=topic,
            payload=payload,
            packet_id=pid,
        )
    )


def _publish_chunk(topic: str, payload: bytes, count: int, qos: int,
                   pid0: int) -> tuple[bytes, int]:
    """``count`` back-to-back PUBLISH frames in one buffer. QoS0 frames
    are byte-identical; QoS1 frames cycle distinct packet ids starting
    at ``pid0`` by patching the 2-byte id over one template encode (the
    generator must not pay a per-message encode it is trying to measure
    on the broker). Returns ``(buffer, next_pid)``."""
    if qos == 0:
        return _publish_bytes(topic, payload) * count, pid0
    template = bytearray(_publish_bytes(topic, payload, qos=qos, pid=1))
    off = 1
    while template[off] & 0x80:
        off += 1
    id_off = off + 1 + 2 + len(topic.encode("utf-8"))
    out = bytearray()
    pid = pid0
    for _ in range(count):
        template[id_off] = (pid >> 8) & 0xFF
        template[id_off + 1] = pid & 0xFF
        out += template
        pid = pid + 1 if pid < 0xFFFF else 1
    return bytes(out), pid


async def _read_packet_type(reader) -> int:
    """Read one packet off the wire, return its type (frames discarded)."""
    first = (await reader.readexactly(1))[0]
    remaining = 0
    shift = 0
    while True:
        b = (await reader.readexactly(1))[0]
        remaining |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if remaining:
        await reader.readexactly(remaining)
    return first >> 4


def _scan_frames(buf: bytearray):
    """``(frames, consumed)`` for the COMPLETE MQTT frames at the head
    of ``buf`` — each frame as ``(first_byte, body_start, body_end)``;
    the caller deletes ``buf[:consumed]``. The one raw scanner every
    bulk reader in this module shares (publish counter, ack reader,
    storm subscriber), so the varint rules live in one place."""
    frames = []
    pos = 0
    n = len(buf)
    while True:
        if pos + 2 > n:
            break
        remaining = 0
        shift = 0
        vend = pos + 1
        ok = True
        while True:
            if vend >= n:
                ok = False
                break
            b = buf[vend]
            vend += 1
            remaining |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 21:
                # 4-continuation-byte cap, matching the broker-side
                # scanner: a malformed stream must error, not grow
                # remaining unboundedly and mis-frame what follows
                raise ValueError("malformed varint in stress stream")
        if not ok or vend + remaining > n:
            break
        frames.append((buf[pos], vend, vend + remaining))
        pos = vend + remaining
    return frames, pos


async def _count_publishes(reader, want: int, writer=None) -> None:
    """Count inbound PUBLISH frames (bulk reads, minimal parsing).

    Drains whatever the socket has and walks complete frames in the
    buffer — the load generator must not be the bottleneck it is
    measuring (three awaits per frame was costing more than the broker's
    own per-message path on a shared core). With ``writer`` given, QoS1
    deliveries are PUBACKed (one batched write per read chunk) so the
    broker's inflight store drains — the QoS1 matrix cells need a
    spec-complete subscriber, not a silent one."""
    got = 0
    buf = bytearray()
    while got < want:
        data = await reader.read(65536)
        if not data:
            raise asyncio.IncompleteReadError(b"", None)
        buf += data
        frames, consumed = _scan_frames(buf)
        acks = bytearray() if writer is not None else None
        for first, bs, be in frames:
            if (first >> 4) == PUBLISH:
                got += 1
                if acks is not None and (first >> 1) & 0x03 == 1:
                    # QoS1 delivery: topic-length-prefixed topic, then
                    # the packet id — echo it back as a PUBACK
                    tl = (buf[bs] << 8) | buf[bs + 1]
                    pid_at = bs + 2 + tl
                    if pid_at + 2 <= be:
                        acks += bytes(
                            (0x40, 0x02, buf[pid_at], buf[pid_at + 1])
                        )
        del buf[:consumed]
        if acks:
            writer.write(bytes(acks))


async def _worker(
    host: str, port: int, cid: str, n_msgs: int, payload: bytes,
    write_chunk: int, qos: int = 0,
) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_connect_bytes(cid))
        await writer.drain()
        assert await _read_packet_type(reader) == CONNACK
        topic = f"stress/{cid}"
        writer.write(_subscribe_bytes(1, topic, qos=qos))
        await writer.drain()
        assert await _read_packet_type(reader) == SUBACK

        recv_task = asyncio.ensure_future(
            _count_publishes(
                reader, n_msgs, writer=writer if qos > 0 else None
            )
        )
        pid = 1
        t0 = time.perf_counter()
        for i in range(0, n_msgs, write_chunk):
            chunk, pid = _publish_chunk(
                topic, payload, min(write_chunk, n_msgs - i), qos, pid
            )
            writer.write(chunk)
            await writer.drain()
        pub_s = time.perf_counter() - t0
        await recv_task
        recv_s = time.perf_counter() - t0
        return {
            "publish_per_sec": n_msgs / max(1e-9, pub_s),
            "receive_per_sec": n_msgs / max(1e-9, recv_s),
        }
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # brokerlint: ok=R4 load-generator teardown; the broker side logs real close errors
            pass


async def run_stress(
    host: str,
    port: int,
    n_clients: int,
    n_msgs: int,
    payload_size: int = 64,
    write_chunk: int = 64,
    timeout: float = 300.0,
    qos: int = 0,
) -> dict:
    """Run the N-client workload; returns mqtt-stresser-style aggregates.
    ``qos`` drives both the publish and subscription QoS (the matrix's
    QoS axis): QoS1 publishers carry cycling packet ids, QoS1
    subscribers PUBACK every delivery."""
    payload = b"x" * payload_size
    t0 = time.perf_counter()
    results = await asyncio.wait_for(
        asyncio.gather(
            *(
                _worker(
                    host, port, f"w{i}", n_msgs, payload, write_chunk,
                    qos=qos,
                )
                for i in range(n_clients)
            )
        ),
        timeout,
    )
    wall = time.perf_counter() - t0
    pub = sorted(r["publish_per_sec"] for r in results)
    recv = sorted(r["receive_per_sec"] for r in results)
    return {
        "clients": n_clients,
        "msgs_per_client": n_msgs,
        "qos": qos,
        "publish_median_per_sec": round(statistics.median(pub)),
        "publish_min_per_sec": round(pub[0]),
        "publish_max_per_sec": round(pub[-1]),
        "receive_median_per_sec": round(statistics.median(recv)),
        "receive_min_per_sec": round(recv[0]),
        "receive_max_per_sec": round(recv[-1]),
        "aggregate_msgs_per_sec": round(n_clients * n_msgs / wall),
        "wall_s": round(wall, 2),
    }


async def ramp_idle(
    host: str,
    port: int,
    n: int,
    client_prefix: str = "idle",
    batch: int = 200,
) -> list:
    """Attach ``n`` mostly-idle device connections (CONNECT, then
    silence; keepalive 0 so the broker never reaps them) — the
    connection-scale axis. Returns the writers; close them to drop the
    population."""
    writers: list = []

    async def one(i: int) -> None:
        r, w = await asyncio.open_connection(host, port)
        w.write(_connect_bytes(f"{client_prefix}-{i}", keepalive=0))
        await w.drain()
        await asyncio.wait_for(r.readexactly(4), 30)  # CONNACK
        writers.append(w)

    for base in range(0, n, batch):
        await asyncio.gather(
            *(one(i) for i in range(base, min(base + batch, n)))
        )
    return writers


async def run_flatness(
    host: str,
    port: int,
    clients_small: int = 10,
    clients_large: int = 100,
    msgs_small: int = 1000,
    msgs_large: int = 500,
    **kw,
) -> dict:
    """The per-client receive-rate FLATNESS probe: run the stresser
    workload at a small and a large client count against the same broker
    and report the ratio of per-client receive medians. A flat broker
    holds ~1.0; a broker whose per-connection cost grows with the
    connection count falls toward 0 as clients grow."""
    small = await run_stress(host, port, clients_small, msgs_small, **kw)
    large = await run_stress(host, port, clients_large, msgs_large, **kw)
    return {
        "clients": [clients_small, clients_large],
        "small": small,
        "large": large,
        # per-cell medians in one flat, diffable list (the matrix shape
        # rounds diff cell-by-cell): each cell is
        # keyed by (clients, qos) and carries ITS OWN medians instead of
        # only the cross-cell ratio
        "cells": [
            {
                "clients": r["clients"],
                "qos": r.get("qos", 0),
                "msgs_per_client": r["msgs_per_client"],
                "publish_median_per_sec": r["publish_median_per_sec"],
                "receive_median_per_sec": r["receive_median_per_sec"],
                "aggregate_msgs_per_sec": r["aggregate_msgs_per_sec"],
            }
            for r in (small, large)
        ],
        "receive_flatness_ratio": round(
            large["receive_median_per_sec"]
            / max(1e-9, small["receive_median_per_sec"]),
            4,
        ),
    }


# -- publish storm (overload-governor drill) ---------------------------------


async def _read_loop_acks(reader, want_acks: int, acks: dict, timeout: float) -> None:
    """Count PUBACK reason codes off one publisher's stream (0x00/0x10 =
    admitted, 0x97 = shed by the overload governor) until ``want_acks``
    arrive or the deadline passes."""
    deadline = time.perf_counter() + timeout
    buf = bytearray()
    got = 0
    while got < want_acks:
        budget = deadline - time.perf_counter()
        if budget <= 0:
            break
        try:
            data = await asyncio.wait_for(reader.read(65536), budget)
        except asyncio.TimeoutError:
            break
        if not data:
            acks["disconnected"] = acks.get("disconnected", 0) + 1
            break
        buf += data
        frames, consumed = _scan_frames(buf)
        for first, bs, be in frames:
            ptype = first >> 4
            if ptype == 4:  # PUBACK
                got += 1
                reason = buf[bs + 2] if be - bs > 2 else 0
                key = "shed" if reason == 0x97 else "admitted"
                acks[key] = acks.get(key, 0) + 1
            elif ptype == 14:  # DISCONNECT (e.g. 0x97 eviction)
                acks["disconnected"] = acks.get("disconnected", 0) + 1
        del buf[:consumed]


async def run_storm(
    host: str,
    port: int,
    publishers: int = 16,
    msgs_each: int = 2000,
    qos1_fraction: float = 0.5,
    payload_pad: int = 32,
    seed: int = 7,
    timeout: float = 120.0,
    drain_idle_s: float = 1.0,
) -> dict:
    """Offered-load >> sustainable publish storm against a live broker:
    N v5 publishers blast a seeded :class:`~mqtt_tpu_torch.faults.StormPlan`
    while one subscriber on ``storm/#`` measures what actually gets
    through. Returns offered/admitted/shed/delivered accounting and the
    admitted-traffic delivery p99 — the fields the overload governor is
    judged on."""
    from .faults import StormPlan, drive_storm

    plan = StormPlan(
        seed=seed,
        publishers=publishers,
        msgs_per_publisher=msgs_each,
        qos1_fraction=qos1_fraction,
        payload_pad=payload_pad,
    )
    schedules = plan.schedule()
    t_start = time.perf_counter()

    # the measuring subscriber (wildcard over every storm topic)
    sub_r, sub_w = await asyncio.open_connection(host, port)
    sub_w.write(_connect_bytes("storm-sub", version=5))
    await sub_w.drain()
    assert await _read_packet_type(sub_r) == CONNACK
    sub_w.write(
        encode_packet(
            Packet(
                fixed_header=FixedHeader(type=SUBSCRIBE, qos=1),
                protocol_version=5,
                packet_id=1,
                filters=[Subscription(filter="storm/#", qos=0)],
            )
        )
    )
    await sub_w.drain()
    assert await _read_packet_type(sub_r) == SUBACK

    conns = []
    send_times: dict[bytes, float] = {}
    for p in range(publishers):
        r, w = await asyncio.open_connection(host, port)
        w.write(_connect_bytes(f"storm-p{p}", version=5))
        await w.drain()
        assert await _read_packet_type(r) == CONNACK
        conns.append((r, w))

    # delivery accounting: payload tag -> receive latency
    latencies: list[float] = []
    delivered = [0]

    async def consume() -> None:
        buf = bytearray()
        while True:
            try:
                data = await asyncio.wait_for(sub_r.read(65536), drain_idle_s)
            except asyncio.TimeoutError:
                if done.is_set():
                    return  # storm over and the stream went quiet
                continue
            if not data:
                return
            buf += data
            frames, consumed = _scan_frames(buf)
            for first, bs, be in frames:
                if (first >> 4) == PUBLISH:
                    body = bytes(buf[bs:be])
                    # the payload tag (s<pub>-<seq>) sits right before
                    # the first '|'; the topic never contains one
                    sep = body.find(b"|")
                    if sep > 0:
                        start = body.rfind(b"s", 0, sep)
                        t0 = send_times.get(body[start:sep]) if start >= 0 else None
                        if t0:
                            latencies.append(time.perf_counter() - t0)
                    delivered[0] += 1
            del buf[:consumed]

    done = asyncio.Event()
    consumer = asyncio.ensure_future(consume())

    # per-publisher ack counters ride alongside the blast
    acks: dict = {}
    want_acks = [
        sum(1 for (_s, _t, _p, q) in schedules[p] if q) for p in range(publishers)
    ]
    ack_tasks = [
        asyncio.ensure_future(
            _read_loop_acks(conns[p][0], want_acks[p], acks, timeout)
        )
        for p in range(publishers)
    ]

    # the intake window: blast start until the broker has acked every
    # QoS1 publish (the blast itself is fire-and-forget socket writes,
    # so write-time alone would overstate the offered rate wildly)
    t0 = time.perf_counter()
    offered = await asyncio.wait_for(
        drive_storm([w for _r, w in conns], plan, stamp_times=send_times),
        timeout,
    )
    await asyncio.wait_for(asyncio.gather(*ack_tasks), timeout)
    storm_s = time.perf_counter() - t0
    done.set()
    try:
        await asyncio.wait_for(consumer, timeout)
    except asyncio.TimeoutError:
        consumer.cancel()

    for _r, w in conns + [(sub_r, sub_w)]:
        try:
            w.close()
        except Exception:  # brokerlint: ok=R4 load-generator teardown of many sockets; per-socket noise helps no one
            pass

    lat_sorted = sorted(latencies)
    p99 = (
        lat_sorted[min(len(lat_sorted) - 1, max(0, int(len(lat_sorted) * 0.99) - 1))]
        if lat_sorted
        else None
    )
    return {
        "publishers": publishers,
        "offered": offered,
        "offered_rate_per_sec": round(offered["total"] / max(1e-9, storm_s)),
        "storm_wall_s": round(storm_s, 2),
        "acked_admitted_qos1": acks.get("admitted", 0),
        "shed_qos1_0x97": acks.get("shed", 0),
        # client-visible sheds only: QoS0 sheds are silent drops, so the
        # broker-side governor gauge is the total (bench reads it)
        "shed_rate_qos1": round(
            acks.get("shed", 0) / max(1, offered["qos1"]), 4
        ),
        "delivered": delivered[0],
        "delivery_p99_ms": round(p99 * 1e3, 1) if p99 is not None else None,
        # >0 means the run was truncated (a publisher was evicted or its
        # stream dropped mid-blast): ack/shed counts undercount
        "publishers_disconnected": acks.get("disconnected", 0),
        "wall_s": round(time.perf_counter() - t_start, 2),
    }


# -- partition storm (mesh-federation drill) ---------------------------------


async def _read_cluster_sys(host: str, port: int, wait_s: float = 3.0) -> dict:
    """Subscribe ``$SYS/broker/cluster/#`` on one worker and collect the
    retained mesh gauges (topic suffix -> payload string) — the
    partition drill's observability leg: parked/replayed forwards and
    the split drop counters must be visible from the outside."""
    reader, writer = await asyncio.open_connection(host, port)
    gauges: dict = {}
    try:
        writer.write(_connect_bytes("partition-sys", version=4))
        await writer.drain()
        assert await _read_packet_type(reader) == CONNACK
        writer.write(_subscribe_bytes(1, "$SYS/broker/cluster/#"))
        await writer.drain()
        deadline = time.perf_counter() + wait_s
        buf = bytearray()
        while time.perf_counter() < deadline:
            budget = deadline - time.perf_counter()
            try:
                data = await asyncio.wait_for(reader.read(65536), max(0.05, budget))
            except asyncio.TimeoutError:
                continue
            if not data:
                break
            buf += data
            frames, consumed = _scan_frames(buf)
            for first, bs, be in frames:
                if (first >> 4) != PUBLISH:
                    continue
                body = bytes(buf[bs:be])
                if len(body) < 2:
                    continue
                tl = (body[0] << 8) | body[1]
                topic = body[2 : 2 + tl].decode("utf-8", "replace")
                rest = body[2 + tl :]
                # v4 QoS0: payload follows the topic directly
                gauges[topic.removeprefix("$SYS/broker/cluster/")] = (
                    rest.decode("utf-8", "replace")
                )
            del buf[:consumed]
    finally:
        writer.close()
    return gauges


async def run_partition(
    host: str,
    port: int,
    publishers: int = 8,
    msgs_each: int = 1000,
    seed: int = 11,
    sys_port: int = 0,
    **storm_kw,
) -> dict:
    """The partition-storm scenario (``--partition``): a seeded publish
    storm against a multi-worker mesh whose peer links are being severed
    mid-traffic (serve-side ``--flap-peer-s``), then a $SYS scrape of
    the mesh gauges. The pass criterion is LIVENESS plus accounting:
    delivery continues, nothing wedges, and every partition-time loss
    shows up in the parked/replayed/split-drop counters instead of
    vanishing."""
    out = await run_storm(
        host, port, publishers=publishers, msgs_each=msgs_each, seed=seed,
        **storm_kw,
    )
    out["cluster_sys"] = await _read_cluster_sys(host, sys_port or port)
    return out


# -- N-worker mesh drill (spanning-tree acceptance) -------------------------


def _puback_bytes(pid: int) -> bytes:
    return bytes((0x40, 0x02, (pid >> 8) & 0xFF, pid & 0xFF))


class _DrillSubscriber:
    """One per-worker drill subscriber: pinned to the worker's private
    port, subscribed ``drill/#`` QoS1 (plus, with ``predicate`` set, the
    MQTT+ filter ``drill-pred/#$GT{v:50}`` — the push-down drill's
    predicated interest), counting every delivered payload (the
    duplicate/loss ledger) and PUBACKing QoS1 deliveries so inflight
    windows never wedge the read."""

    def __init__(self, worker: int, predicate: bool = False) -> None:
        self.worker = worker
        self.predicate = predicate
        self.counts: dict = {}
        self.reader = None
        self.writer = None
        self._task = None

    async def start(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(host, port)
        self.writer.write(_connect_bytes(f"drill-sub-{self.worker}", version=4))
        await self.writer.drain()
        assert await _read_packet_type(self.reader) == CONNACK
        filters = [Subscription(filter="drill/#", qos=1)]
        if self.predicate:
            filters.append(
                Subscription(filter="drill-pred/#$GT{v:50}", qos=1)
            )
        self.writer.write(
            encode_packet(
                Packet(
                    fixed_header=FixedHeader(type=SUBSCRIBE, qos=1),
                    protocol_version=4,
                    packet_id=1,
                    filters=filters,
                )
            )
        )
        await self.writer.drain()
        assert await _read_packet_type(self.reader) == SUBACK
        self._task = asyncio.get_running_loop().create_task(
            self._collect(), name=f"drill-sub-{self.worker}"
        )

    async def _collect(self) -> None:
        buf = bytearray()
        while True:
            data = await self.reader.read(65536)
            if not data:
                return
            buf += data
            frames, consumed = _scan_frames(buf)
            for first, bs, be in frames:
                if (first >> 4) != PUBLISH:
                    continue
                qos = (first >> 1) & 3
                body = bytes(buf[bs:be])
                if len(body) < 2:
                    continue
                tl = (body[0] << 8) | body[1]
                topic = body[2 : 2 + tl]
                rest = body[2 + tl :]
                if qos and len(rest) >= 2:
                    pid = (rest[0] << 8) | rest[1]
                    payload = rest[2:]
                    self.writer.write(_puback_bytes(pid))
                else:
                    payload = rest
                if topic.startswith(b"drill/") or topic.startswith(
                    b"drill-pred/"
                ):
                    key = bytes(payload)
                    self.counts[key] = self.counts.get(key, 0) + 1
            del buf[:consumed]

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, ConnectionError, OSError):
                pass
        if self.writer is not None:
            self.writer.close()


async def _drill_publish(
    host: str,
    port: int,
    pub_id: int,
    tag: str,
    msgs: int,
    qos: int = 1,
    payloads: Optional[list] = None,
    topic: str = "",
) -> list:
    """Publish ``msgs`` uniquely-tagged QoS1 payloads from one drill
    publisher (pinned to whatever worker owns ``port``); returns the
    payloads sent. Payloads are namespaced by PUBLISHER id, not worker,
    so the same script against brokers of different worker counts — the
    single-worker oracle — produces byte-identical expected sets.
    PUBACKs are drained concurrently so the broker's inflight ledger
    never stalls the writes — and COUNTED: the publisher holds its
    connection open until every QoS1 publish is acked (PUBACK n proves
    the broker fully processed publish n), so closing can never strand
    the batch tail in a starved worker's receive buffer."""
    reader, writer = await asyncio.open_connection(host, port)
    sent = []
    acked = 0
    try:
        writer.write(_connect_bytes(f"drill-pub-{tag}-{pub_id}", version=4))
        await writer.drain()
        assert await _read_packet_type(reader) == CONNACK

        async def drain_acks() -> None:
            nonlocal acked
            try:
                while True:
                    if await _read_packet_type(reader) == 4:  # PUBACK
                        acked += 1
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                pass

        ack_task = asyncio.get_running_loop().create_task(drain_acks())
        if payloads is not None:
            msgs = len(payloads)
        for i in range(msgs):
            payload = (
                payloads[i]
                if payloads is not None
                else f"{tag}:{pub_id}:{i}".encode()
            )
            writer.write(
                encode_packet(
                    Packet(
                        fixed_header=FixedHeader(type=PUBLISH, qos=qos),
                        protocol_version=4,
                        topic_name=topic or f"drill/{tag}/{pub_id}",
                        packet_id=(i % 65535) + 1 if qos else 0,
                        payload=payload,
                    )
                )
            )
            sent.append(payload)
            if i % 16 == 15:
                await writer.drain()
        await writer.drain()
        # block on full acknowledgement, not a fixed grace sleep: on a
        # CPU-oversubscribed box the broker can take seconds to read the
        # tail of the blast, and an early close races its read loop
        deadline = time.perf_counter() + (60.0 if qos else 1.0)
        while qos and acked < msgs and time.perf_counter() < deadline:
            await asyncio.sleep(0.05)
        ack_task.cancel()
    finally:
        writer.close()
    return sent


def _drill_port(port: int, workers: int, worker: int) -> int:
    """The per-worker private port (MQTT_TPU_WORKER_PORTS=1 layout); a
    single-worker oracle broker has no private ports."""
    return port + 1 + worker if workers > 1 else port


async def run_mesh_drill(
    host: str,
    port: int,
    workers: int,
    storm_msgs: int = 40,
    storm_publishers: int = 4,
    verify_msgs: int = 20,
    verify_publishers: int = 4,
    settle_s: float = 3.0,
    verify_timeout_s: float = 30.0,
    scrape: bool = True,
    pred_msgs: int = 0,
) -> dict:
    """The N-worker mesh acceptance drill (``--mesh-drill``), run
    against a broker started with ``--workers N`` (+ ``--topology tree
    --flap-peer-s S --flap-for-s T`` for the partition-storm leg and
    env ``MQTT_TPU_WORKER_PORTS=1`` for the per-worker pinning):

    1. one subscriber per worker on its private port (``drill/#`` QoS1);
    2. STORM: publishers pinned across workers blast unique QoS1
       payloads while the launcher's link flaps cut tree edges;
    3. HEAL: the flap schedule ends (``--flap-for-s``) and the drill
       BLOCKS on observed convergence — every worker's links match its
       wanted set, parks drained, one epoch mesh-wide (scraped, not
       assumed; ``healed`` reports the gate's verdict);
    4. PROBE: uniquely-tagged probes from every verify worker until
       every subscriber has seen one from each — a healed LINK is not
       yet a healed ROUTE (``_probe_routes``);
    5. VERIFY: a fresh tagged batch — every subscriber must converge to
       every verify payload, exactly once (the post-heal oracle);
    6. a per-worker ``$SYS/broker/cluster`` scrape (links, control
       bytes, duplicate-suppression counters — the O(degree) numbers).

    Duplicates are counted across BOTH phases: the storm may lose QoS0
    and even QoS1 forwards (counted drops — the documented best-effort
    posture), but a payload arriving TWICE at one subscriber is a
    routing loop or a replayed park escaping the suppression window,
    and fails the drill.

    With ``pred_msgs > 0`` a PREDICATE leg follows the verify batch:
    every subscriber also holds ``drill-pred/#$GT{v:50}`` and the
    verify publishers blast JSON payloads alternating above/below the
    threshold to ``drill-pred/...`` topics (a base no plain ``drill/#``
    interest covers, so the only cross-edge interest is the interned
    predicate digest). PASSING payloads must converge everywhere
    exactly once; a FAILING payload delivered ANYWHERE is a push-down
    or engine soundness bug (``pred_leaks``), and the scrape's
    ``tree/predicate_filtered`` sum proves edges actually cut the
    failing traffic instead of shipping it to die at the destination."""
    subs = [_DrillSubscriber(w, predicate=pred_msgs > 0) for w in range(workers)]
    for s in subs:
        await s.start(host, _drill_port(port, workers, s.worker))

    storm_sent: list = []
    step = max(1, workers // max(1, storm_publishers))
    storm_tasks = [
        _drill_publish(
            host, _drill_port(port, workers, (p * step) % workers),
            p, "a", storm_msgs,
        )
        for p in range(storm_publishers)
    ]
    for sent in await asyncio.gather(*storm_tasks):
        storm_sent.extend(sent)

    await asyncio.sleep(settle_s)
    healed, heal_wait = await _wait_healed(host, port, workers)
    route_converged, probe_attempts = await _probe_routes(
        host, port, workers, subs,
        [(p * step + 1) % workers for p in range(verify_publishers)],
    )

    verify_sent: list = []
    verify_tasks = [
        _drill_publish(
            host, _drill_port(port, workers, (p * step + 1) % workers),
            p, "b", verify_msgs,
        )
        for p in range(verify_publishers)
    ]
    for sent in await asyncio.gather(*verify_tasks):
        verify_sent.extend(sent)

    want = set(verify_sent)
    deadline = time.perf_counter() + verify_timeout_s
    while time.perf_counter() < deadline:
        if all(want <= set(s.counts) for s in subs):
            break
        await asyncio.sleep(0.1)

    pred_pass: list = []
    pred_fail: list = []
    if pred_msgs > 0:
        pred_tasks = []
        for p in range(verify_publishers):
            payloads = []
            for i in range(pred_msgs):
                # alternate around the $GT{v:50} threshold: odd i PASS,
                # even i FAIL (and must never be delivered anywhere)
                v = 90.0 + i if i % 2 else 10.0
                payload = json.dumps({"v": v, "tag": f"c:{p}:{i}"}).encode()
                payloads.append(payload)
                (pred_pass if v > 50 else pred_fail).append(payload)
            pred_tasks.append(
                _drill_publish(
                    host, _drill_port(port, workers, (p * step + 1) % workers),
                    p, "c", pred_msgs,
                    payloads=payloads, topic=f"drill-pred/c/{p}",
                )
            )
        await asyncio.gather(*pred_tasks)
        pwant = set(pred_pass)
        deadline = time.perf_counter() + verify_timeout_s
        while time.perf_counter() < deadline:
            if all(pwant <= set(s.counts) for s in subs):
                break
            await asyncio.sleep(0.1)

    report: dict = {
        "workers": workers,
        "storm_sent": len(storm_sent),
        # the heal-convergence gate the verify phase ran behind: False
        # means the mesh never quiesced and the verify numbers below
        # are storm numbers, not post-heal numbers
        "healed": healed,
        "heal_wait_s": round(heal_wait, 1),
        # the route-convergence gate behind the heal gate: False means
        # some (verify worker -> subscriber) route never carried a probe
        "route_converged": route_converged,
        "route_probe_attempts": probe_attempts,
        "verify_sent": len(verify_sent),
        "verify_complete": all(want <= set(s.counts) for s in subs),
        "verify_missing": {
            s.worker: len(want - set(s.counts)) for s in subs
            if want - set(s.counts)
        },
        # a count > 1 for any payload at any subscriber = a duplicate
        # delivery (loop / double-replay): the drill's zero assertion
        "dup_deliveries": sum(
            n - 1 for s in subs for n in s.counts.values() if n > 1
        ),
        "received_total": sum(sum(s.counts.values()) for s in subs),
        # the oracle comparison key: per-subscriber verify-phase
        # anomalies. complete + no dups + equal expected sets means the
        # delivered multisets are IDENTICAL to any other green run of
        # the same script — in particular the single-worker oracle's
        "verify_anomalies": {
            s.worker: {
                "missing": len(want - set(s.counts)),
                "dups": sum(
                    n - 1
                    for k, n in s.counts.items()
                    if k in want and n > 1
                ),
            }
            for s in subs
            if (want - set(s.counts))
            or any(n > 1 for k, n in s.counts.items() if k in want)
        },
    }
    if pred_msgs > 0:
        pwant = set(pred_pass)
        report["pred_sent"] = len(pred_pass) + len(pred_fail)
        report["pred_complete"] = all(pwant <= set(s.counts) for s in subs)
        report["pred_missing"] = {
            s.worker: len(pwant - set(s.counts)) for s in subs
            if pwant - set(s.counts)
        }
        # a below-threshold payload delivered to ANY subscriber: the
        # predicate plane (edge push-down or destination engine) passed
        # traffic it proved could not match — soundness, not loss
        report["pred_leaks"] = sum(
            s.counts.get(k, 0) for s in subs for k in pred_fail
        )
    for s in subs:
        await s.stop()
    if scrape:
        # the O(degree) gossip claim is about the steady-state per-worker
        # control-plane RATE, not cumulative bytes (a storm's election
        # floods are history, and both legs run different wall clocks):
        # sample control_bytes twice across a quiesced window and report
        # bytes/s per worker. The window swamps the 1s $SYS resend jitter.
        c0 = await _scrape_workers(host, port, workers)
        t0 = time.perf_counter()
        await asyncio.sleep(8.0)
        c1 = await _scrape_workers(host, port, workers)
        elapsed = time.perf_counter() - t0
        report["control_rate"] = {
            w: (
                int(c1[w]["control_bytes"]) - int(c0[w]["control_bytes"])
            ) / elapsed
            for w in range(workers)
            if "control_bytes" in c0.get(w, {})
            and "control_bytes" in c1.get(w, {})
        }
        report["cluster_sys"] = c1
        # mesh-wide predicate push-down effect: publishes an edge's
        # interned digests proved could not match any remote subscriber
        # and therefore never crossed the link (cross-edge bytes saved)
        report["predicate_filtered_total"] = sum(
            int(g.get("tree/predicate_filtered", 0))
            for g in c1.values()
            if isinstance(g, dict)
        )
        report["root_failovers_total"] = sum(
            int(g.get("tree/root_failovers", 0))
            for g in c1.values()
            if isinstance(g, dict)
        )
    return report


async def _wait_healed(
    host: str, port: int, workers: int, timeout_s: float = 90.0
) -> "tuple[bool, float]":
    """Block until the mesh reads HEALED from the outside — the drill's
    'partition storm + heal converges' gate, polled via the per-worker
    $SYS scrape: every worker's live link count matches its wanted set
    (tree neighbors, or N-1 all-pairs), no park buffer still holds
    frames, and (tree mode) every worker reports the same epoch.
    Returns (healed, seconds waited); on timeout the caller proceeds and
    the report carries healed=False (an assertable failure, not a
    hang)."""
    t0 = time.perf_counter()
    if workers <= 1:
        return True, 0.0
    while time.perf_counter() - t0 < timeout_s:
        sys_g = await _scrape_workers(host, port, workers)
        epochs = set()
        ok = True
        for w in range(workers):
            g = sys_g.get(w, {})
            if "peers" not in g:
                ok = False
                break
            if g.get("parked_forwards", "0") != "0":
                ok = False
                break
            if "tree/epoch" in g:
                epochs.add(g["tree/epoch"])
                if g.get("tree/links") != g.get("tree/neighbors"):
                    ok = False
                    break
            elif int(g["peers"]) < workers - 1:
                ok = False
                break
        if ok and len(epochs) <= 1:
            return True, time.perf_counter() - t0
        await asyncio.sleep(1.0)
    return False, time.perf_counter() - t0


async def _probe_routes(
    host: str,
    port: int,
    workers: int,
    subs: "list[_DrillSubscriber]",
    pub_workers: "list[int]",
    timeout_s: float = 60.0,
) -> "tuple[bool, int]":
    """Block until every (verify worker -> subscriber) ROUTE has carried
    a probe. A healed LINK is not yet a healed route: in all-pairs mode
    the presence resync that re-teaches a re-dialed peer this worker's
    filters can still be in flight when the link count converges, so a
    verify batch sent the moment ``_wait_healed`` returns can be dropped
    at a worker that does not yet know the remote interest (tree mode
    forwards conservatively on stale summaries, so it converges here
    almost immediately). Publishes one uniquely-tagged QoS1 probe per
    verify worker per attempt — unique payloads, so a probe delivered
    twice still counts as a real duplicate — until every subscriber has
    seen a probe from every publisher id, then the verify batch rides
    known-good routes. Returns (converged, attempts)."""
    deadline = time.perf_counter() + timeout_s
    attempt = 0
    while time.perf_counter() < deadline:
        await asyncio.gather(*[
            _drill_publish(
                host, _drill_port(port, workers, w), p, f"p{attempt}", 1
            )
            for p, w in enumerate(pub_workers)
        ])
        attempt += 1
        # give this attempt's probes a short spread window before the
        # next (re-)publication round
        spread = min(time.perf_counter() + 3.0, deadline)
        while time.perf_counter() < spread:
            missing = False
            for s in subs:
                seen = {
                    int(k.split(b":")[1].decode())
                    for k in s.counts
                    if k.startswith(b"p") and k.count(b":") == 2
                }
                if not set(range(len(pub_workers))) <= seen:
                    missing = True
                    break
            if not missing:
                return True, attempt
            await asyncio.sleep(0.2)
    return False, attempt


async def _scrape_workers(host: str, port: int, workers: int) -> dict:
    """Per-worker $SYS mesh-gauge scrape, chunked (32 concurrent
    retained-tree reads in one burst starve each other) with one retry
    pass for workers whose scrape came back incomplete."""
    out: dict = {w: {} for w in range(workers)}

    async def one(w: int, wait_s: float) -> None:
        try:
            out[w] = await _read_cluster_sys(
                host, _drill_port(port, workers, w), wait_s=wait_s
            )
        except (OSError, AssertionError, asyncio.IncompleteReadError) as e:
            out[w] = {"error": str(e)}

    pending = list(range(workers))
    for wait_s in (2.0, 4.0):  # first pass, then the retry sweep
        for i in range(0, len(pending), 8):
            await asyncio.gather(*(one(w, wait_s) for w in pending[i : i + 8]))
        pending = [w for w in pending if "peers" not in out[w]]
        if not pending:
            break
    return out


def broker_main(
    address: str,
    device_matcher: bool = False,
    workers: int = 1,
    flap_peer_s: float = 0.0,
    flap_for_s: float = 0.0,
    flap_workers: int = 1,
    topology: str = "",
    degree: int = 0,
    transport: str = "",
    cluster_base_port: int = 0,
    kill_root_after_s: float = 0.0,
    device: str = "cuda",
) -> None:
    """Run a bench broker on ``address`` until stdin closes or SIGTERM
    arrives (a driver's subprocess entry; prints READY once serving),
    its device planes on ``device``: "cuda" where there is no card exits
    at start, naming CUDA.

    ``workers > 1`` starts the multi-core data plane (``cluster``):
    this process becomes the launcher, spawning one worker process per
    core slot, each binding ``address`` with SO_REUSEPORT plus a private
    per-worker port (base+1+i) for deterministic testing, all joined by
    the forwarding mesh. ``topology``/``degree`` select the
    spanning-tree fabric mesh-wide; ``flap_for_s`` bounds the
    link-flap storm so a drill gets a guaranteed heal phase, and
    ``flap_workers`` spreads the flapping across the first K workers (a
    partition STORM, not one noisy neighbor).

    Cross-machine mode: ``transport="tcp"`` joins the mesh
    over TCP peer links on ``cluster_base_port + worker``; env
    ``MQTT_TPU_MACHINE_SPLIT=K`` declares workers ``< K`` one "machine"
    and the rest another, and ``MQTT_TPU_LINK_SHAPE`` (a LinkShape json)
    imposes a seeded WAN profile on every INTER-group inbound edge —
    intra-group links stay clean, exactly as two LAN-joined process
    groups over a shaped WAN would behave. ``kill_root_after_s`` SIGKILLs
    worker 0 (the deterministic tree root) that long after the mesh
    reports READY — the root-failover fast-path drill leg."""
    import os
    import signal
    import sys
    import threading

    from .cluster import maybe_attach_from_env
    from .ops.flat import resolve_device

    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        # a device plane on a card that is not there: never serve on the host
        raise SystemExit(
            f"mqtt_tpu_torch.stress: cannot serve on device {device!r}: {e}"
        ) from e
    wid_env = os.environ.get("MQTT_TPU_WORKER")
    if workers > 1 and wid_env is None:
        _cluster_launcher(
            address, device_matcher, workers, flap_peer_s,
            flap_for_s=flap_for_s, flap_workers=flap_workers,
            topology=topology, degree=degree, transport=transport,
            cluster_base_port=cluster_base_port,
            kill_root_after_s=kill_root_after_s, device=device,
        )
        return

    from .hooks.auth.allow_all import AllowHook
    from .listeners import Config
    from .listeners.tcp import TCP
    from .server import Options, Server

    async def main() -> None:
        opt_kw = {}
        sys_s = os.environ.get("MQTT_TPU_SYS_RESEND_S")
        if sys_s:
            # drill workers re-publish $SYS fast so the final scrape
            # reads fresh counters, not 30s-old ones
            opt_kw["sys_topic_resend_interval"] = int(sys_s)
        if os.environ.get("MQTT_TPU_OVERLOAD_CONTROL") == "0":
            # the mesh drill isolates ROUTING correctness: on a
            # CPU-oversubscribed runner the governor legitimately SHEDs
            # QoS1 publishes at the origin (invisible to the drill's v4
            # publishers — v4 PUBACK has no reason code), which reads as
            # a routing loss when it is the overload plane doing its job
            opt_kw["overload_control"] = False
        if os.environ.get("BENCH_LAZY", "1") == "0":
            # bench A/B knob: the serve-side broker honors
            # the same switch the in-process bench brokers use, so the
            # subprocess config-8 legs A/B cleanly too
            opt_kw["matcher_lazy_views"] = False
            opt_kw["fanout_batch"] = False
        shards = int(os.environ.get("MQTT_TPU_LOOP_SHARDS", "0") or 0)
        if os.environ.get("BENCH_SHARDS") == "1":
            # bench A/B knob: BENCH_SHARDS=1 forces the
            # single-loop front-end whatever MQTT_TPU_LOOP_SHARDS says,
            # so the cfg-8 connections matrix A/Bs the fabric cleanly
            shards = 1
        if shards > 1:
            opt_kw["loop_shards"] = shards
            accept = os.environ.get("MQTT_TPU_LOOP_SHARD_ACCEPT", "")
            if accept:
                opt_kw["loop_shard_accept"] = accept
        srv = Server(
            Options(device=device, device_matcher=device_matcher, **opt_kw)
        )
        srv.add_hook(AllowHook())
        clustered = wid_env is not None
        srv.add_listener(
            TCP(Config(type="tcp", id="bench", address=address, reuse_port=clustered))
        )
        cluster = maybe_attach_from_env(srv)
        if cluster is not None and os.environ.get("MQTT_TPU_WORKER_PORTS") == "1":
            # opt-in per-worker private ports (base+1+id): tests use them
            # to pin which worker a client lands on; production stays off
            # them (N extra non-REUSEPORT binds = N collision chances)
            host, port = address.rsplit(":", 1)
            private = f"{host}:{int(port) + 1 + cluster.worker_id}"
            srv.add_listener(
                TCP(Config(type="tcp", id=f"w{cluster.worker_id}", address=private))
            )
        await srv.serve()
        if cluster is not None:
            await cluster.start()
        shape_env = os.environ.get("MQTT_TPU_LINK_SHAPE", "")
        if cluster is not None and shape_env:
            # WAN link shaping: this worker shapes its INBOUND
            # edges from the other "machine" group (MQTT_TPU_MACHINE_SPLIT
            # = first group's size; no split = every edge shaped). Both
            # endpoints of an inter-group edge install the shaper, so the
            # full RTT is delay_s per direction.
            from .faults import LinkShape, shape_cluster_links

            cfg = json.loads(shape_env)
            split = int(os.environ.get("MQTT_TPU_MACHINE_SPLIT", "0") or 0)
            peers = None
            if split > 0:
                me = cluster.worker_id < split
                peers = [
                    p for p in range(cluster.n_workers)
                    if (p < split) != me
                ]
            shape_cluster_links(
                cluster,
                LinkShape(
                    seed=int(cfg.get("seed", 0)),
                    delay_s=float(cfg.get("delay_s", 0.0)),
                    jitter_s=float(cfg.get("jitter_s", 0.0)),
                    loss=float(cfg.get("loss", 0.0)),
                    rate_bytes_s=float(cfg.get("rate_bytes_s", 0.0)),
                ),
                peers=peers,
            )
        flap_task = None
        if cluster is not None and flap_peer_s > 0:
            # chaos self-injection (the --partition / --mesh-drill server
            # side): this worker severs one seeded-random live link every
            # interval — bounded by --flap-for-s (storm then heal) or
            # unbounded for the liveness-only partition drill
            from .faults import FlapPlan, drive_link_flaps, sever_peer_link

            async def _flap_loop() -> None:
                if flap_for_s > 0:
                    import os as _os

                    await drive_link_flaps(
                        cluster,
                        FlapPlan(
                            seed=1234 + cluster.worker_id,
                            interval_s=flap_peer_s,
                            duration_s=flap_for_s,
                            # a third of the draws are HELD cuts long
                            # enough to cross the partition threshold:
                            # re-elections actually fire mid-storm
                            partition_rate=float(
                                _os.environ.get(
                                    "MQTT_TPU_FLAP_PARTITION_RATE", "0.34"
                                )
                            ),
                            partition_hold_s=cluster.PING_INTERVAL_S
                            * (cluster.partition_pings + 2),
                        ),
                    )
                    return
                import random as _random

                rng = _random.Random(1234 + cluster.worker_id)
                while True:
                    await asyncio.sleep(flap_peer_s)
                    peers = list(cluster._writers)
                    if peers:
                        sever_peer_link(cluster, rng.choice(peers))

            flap_task = asyncio.get_running_loop().create_task(
                _flap_loop(), name="stress-peer-flap"
            )
        print("READY", flush=True)
        loop = asyncio.get_running_loop()
        # exit when the parent closes our stdin (robust to parent death)
        # or sends SIGTERM; the reader is a daemon thread, so a SIGTERM
        # exit never waits on a stdin that stays open
        stop = asyncio.Event()
        loop.add_signal_handler(signal.SIGTERM, stop.set)

        def _read_stdin() -> None:
            sys.stdin.read()
            try:
                loop.call_soon_threadsafe(stop.set)
            except RuntimeError:  # the loop already closed after a SIGTERM
                pass

        threading.Thread(
            target=_read_stdin, name="stress-stdin", daemon=True
        ).start()
        await stop.wait()
        if flap_task is not None:
            flap_task.cancel()
        if cluster is not None:
            await cluster.stop()
        await srv.close()

    asyncio.run(main())


def _cluster_launcher(
    address: str,
    device_matcher: bool,
    workers: int,
    flap_peer_s: float = 0.0,
    flap_for_s: float = 0.0,
    flap_workers: int = 1,
    topology: str = "",
    degree: int = 0,
    transport: str = "",
    cluster_base_port: int = 0,
    kill_root_after_s: float = 0.0,
    device: str = "cuda",
) -> None:
    """Spawn one worker subprocess per slot (each opens its own context
    on ``device``), relay READY when all workers serve, and shut them
    down when stdin closes or SIGTERM arrives. With
    ``MQTT_TPU_WORKER_LOG_DIR`` set, each worker's stderr streams to
    ``worker-N.log`` in that directory — the drill's failure artifacts.
    ``kill_root_after_s > 0`` SIGKILLs worker 0's process that long after
    READY: the kill -9 root death the failover fast path exists for (the
    mesh must promote the pre-agreed successor, worker 1)."""
    import os
    import signal
    import subprocess
    import sys
    import tempfile
    import threading

    from .cluster import worker_env

    def _on_term(_signum, _frame) -> None:
        raise SystemExit(0)  # the finally below stops the workers

    signal.signal(signal.SIGTERM, _on_term)
    sock_dir = tempfile.mkdtemp(prefix="mqtt-tpu-cluster-")
    log_dir = os.environ.get("MQTT_TPU_WORKER_LOG_DIR", "")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs = []
    logs = []
    try:
        for i in range(workers):
            env = dict(os.environ)
            env.update(
                worker_env(
                    i, workers, sock_dir, topology, degree,
                    transport=transport, base_port=cluster_base_port,
                )
            )
            cmd = [sys.executable, "-m", "mqtt_tpu_torch.stress", "--serve",
                   "--broker", address, "--device", device]
            if device_matcher:
                cmd.append("--device-matcher")
            if flap_peer_s > 0 and i < max(1, flap_workers):
                # a bounded set of flapping workers is a partition drill;
                # every worker flapping is a mesh that never converges
                cmd += ["--flap-peer-s", str(flap_peer_s)]
                if flap_for_s > 0:
                    cmd += ["--flap-for-s", str(flap_for_s)]
            stderr = None
            if log_dir:
                stderr = open(os.path.join(log_dir, f"worker-{i}.log"), "wb")
                logs.append(stderr)
            procs.append(
                subprocess.Popen(
                    cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=stderr, env=env,
                )
            )
        for p in procs:
            assert p.stdout.readline().strip() == b"READY"
        if kill_root_after_s > 0:
            t = threading.Timer(kill_root_after_s, procs[0].kill)
            t.daemon = True
            t.start()
        print("READY", flush=True)
        sys.stdin.read()  # parent closes stdin to stop us
    finally:
        for p in procs:
            try:
                p.stdin.close()
                p.wait(timeout=10)
            except Exception:
                p.kill()
        for f in logs:
            try:
                f.close()
            except OSError:
                pass
        import shutil

        shutil.rmtree(sock_dir, ignore_errors=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--broker", default="127.0.0.1:1883", help="host:port")
    p.add_argument("-c", "--clients", type=int, default=10)
    p.add_argument("-m", "--messages", type=int, default=1000)
    p.add_argument("--payload-size", type=int, default=64)
    p.add_argument("--serve", action="store_true", help="run the bench broker instead")
    p.add_argument("--device-matcher", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="serve mode: the card the broker's device planes run on "
        "(cuda, cuda:N or cpu; default cuda)",
    )
    p.add_argument(
        "--storm", action="store_true",
        help="publish-storm overload drill (the overload governor) instead of "
        "the throughput workload",
    )
    p.add_argument(
        "--flatness", action="store_true",
        help="per-client receive-rate flatness probe: the stress workload "
        "at 10 clients and at --clients, reporting the receive-median "
        "ratio",
    )
    p.add_argument(
        "--partition", action="store_true",
        help="partition-storm mesh drill: the storm workload plus a $SYS "
        "scrape of the cluster's parked/replayed/drop gauges (run the "
        "broker with --workers N --flap-peer-s S)",
    )
    p.add_argument(
        "--flap-peer-s", type=float, default=0.0,
        help="serve mode: sever one random live peer link every S seconds "
        "(the --partition drill's chaos source; see --flap-workers)",
    )
    p.add_argument(
        "--flap-for-s", type=float, default=0.0,
        help="serve mode: stop flapping after S seconds (a bounded "
        "partition STORM with a guaranteed heal phase — the --mesh-drill "
        "shape); 0 = flap until shutdown",
    )
    p.add_argument(
        "--flap-workers", type=int, default=1,
        help="serve mode: how many workers run the flap schedule "
        "(seeded independently per worker)",
    )
    p.add_argument(
        "--topology", default="",
        help="serve mode: cluster fabric — 'tree' routes over the "
        "epoch-stamped spanning tree (mesh_topology), empty/"
        "'mesh' keeps the all-pairs fabric",
    )
    p.add_argument(
        "--degree", type=int, default=0,
        help="serve mode: spanning-tree branching factor (0 = default)",
    )
    p.add_argument(
        "--transport", default="",
        help="serve mode: cluster peer transport — 'tcp' joins workers "
        "over TCP links (cross-machine mode), empty/'unix' "
        "keeps the on-box socket-dir fabric",
    )
    p.add_argument(
        "--cluster-base-port", type=int, default=0,
        help="serve mode, --transport tcp: worker i listens for peers on "
        "base+i (pick a range clear of the broker ports)",
    )
    p.add_argument(
        "--machine-split", type=int, default=0,
        help="serve mode: declare workers < K one 'machine' group and "
        "the rest another; with MQTT_TPU_LINK_SHAPE set, only INTER-group "
        "edges are shaped (exported to workers as MQTT_TPU_MACHINE_SPLIT)",
    )
    p.add_argument(
        "--shape-rtt-ms", type=float, default=0.0,
        help="serve mode: inter-group round-trip time in ms (half per "
        "direction; builds MQTT_TPU_LINK_SHAPE for the workers)",
    )
    p.add_argument(
        "--shape-jitter-ms", type=float, default=0.0,
        help="serve mode: per-frame uniform jitter in ms on shaped edges",
    )
    p.add_argument(
        "--shape-loss", type=float, default=0.0,
        help="serve mode: per-frame loss probability on shaped edges "
        "(TCP semantics: data frames arrive late, control frames drop)",
    )
    p.add_argument(
        "--shape-rate-kbps", type=float, default=0.0,
        help="serve mode: serialization bandwidth of shaped edges in "
        "kilobytes/s (0 = unlimited)",
    )
    p.add_argument(
        "--kill-root-after-s", type=float, default=0.0,
        help="serve mode: SIGKILL worker 0 (the tree root) this long "
        "after READY — the root-failover fast-path drill leg",
    )
    p.add_argument(
        "--mesh-drill", action="store_true",
        help="N-worker mesh acceptance drill: per-worker subscribers, a "
        "publish storm over the flapping mesh, then a post-heal verify "
        "batch that must arrive everywhere exactly once, plus per-worker "
        "$SYS scrapes (run the broker with --workers N --topology tree "
        "--flap-peer-s S --flap-for-s T and MQTT_TPU_WORKER_PORTS=1)",
    )
    p.add_argument(
        "--drill-workers", type=int, default=0,
        help="--mesh-drill: worker count of the broker under test "
        "(defaults to --workers)",
    )
    p.add_argument(
        "--drill-pred-msgs", type=int, default=0,
        help="--mesh-drill: add a predicate push-down leg — subscribers "
        "also hold drill-pred/#$GT{v:50} and this many JSON payloads per "
        "verify publisher alternate above/below the threshold; failing "
        "payloads must be edge-filtered, never delivered (0 = off)",
    )
    p.add_argument(
        "--sys-port", type=int, default=0,
        help="--partition: port for the $SYS mesh-gauge scrape (pin a "
        "specific worker's private port — re-dial counters live on the "
        "DIALING side, so the shared REUSEPORT port reads 0 half the time); "
        "0 = the storm port",
    )
    p.add_argument(
        "--workers", type=int, default=1,
        help="worker processes sharing the address via SO_REUSEPORT (multi-core)",
    )
    args = p.parse_args()
    host, port = args.broker.rsplit(":", 1)
    if args.serve:
        import os

        if args.machine_split > 0:
            os.environ["MQTT_TPU_MACHINE_SPLIT"] = str(args.machine_split)
        if args.shape_rtt_ms or args.shape_jitter_ms or args.shape_loss \
                or args.shape_rate_kbps:
            os.environ["MQTT_TPU_LINK_SHAPE"] = json.dumps(
                {
                    "seed": 4242,
                    "delay_s": args.shape_rtt_ms / 2e3,
                    "jitter_s": args.shape_jitter_ms / 1e3,
                    "loss": args.shape_loss,
                    "rate_bytes_s": args.shape_rate_kbps * 1e3,
                }
            )
        broker_main(
            args.broker,
            device_matcher=args.device_matcher,
            workers=args.workers,
            flap_peer_s=args.flap_peer_s,
            flap_for_s=args.flap_for_s,
            flap_workers=args.flap_workers,
            topology=args.topology,
            degree=args.degree,
            transport=args.transport,
            cluster_base_port=args.cluster_base_port,
            kill_root_after_s=args.kill_root_after_s,
            device=args.device,
        )
        return
    if args.mesh_drill:
        out = asyncio.run(
            run_mesh_drill(
                host, int(port), args.drill_workers or args.workers,
                pred_msgs=args.drill_pred_msgs,
            )
        )
        print(json.dumps(out))
        return
    if args.partition:
        out = asyncio.run(
            run_partition(
                host, int(port), args.clients, args.messages,
                sys_port=args.sys_port,
            )
        )
    elif args.flatness:
        out = asyncio.run(
            run_flatness(
                host, int(port),
                clients_large=args.clients,
                msgs_small=args.messages, msgs_large=args.messages,
            )
        )
    elif args.storm:
        out = asyncio.run(
            run_storm(host, int(port), args.clients, args.messages)
        )
    else:
        out = asyncio.run(
            run_stress(host, int(port), args.clients, args.messages, args.payload_size)
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
