"""Scenario lab: the workload/fault matrix as ONE reproducible gate.

A copy of the JAX package's ``mqtt_tpu/scenarios.py``: the same catalog
(seeds, objectives and params), drivers, oracle and gate, over the port's
broker. Every broker a driver builds runs its device planes on
``device`` ("cuda" unless the caller asks for the CPU; ``run_scenario``
and ``run_matrix`` raise where CUDA is absent). One departure: the JAX
drivers of ``payload_sweep`` and ``tenant_rekey`` push
``recrypt_device_min_blocks`` to 2^30, which keeps the JAX keystream on
its host path off an accelerator; the port's keep the default (4), so on
the card their re-encryption and the re-key's re-seal run as the
keystream kernel (``ops.recrypt``), and on the CPU as its plain version.
The lab writes no history file of its own: callers keep the result
documents.

Every scenario is a declarative :class:`ScenarioSpec` — fleet shape,
traffic mix, seeded fault script, SLO objectives, pass/fail oracles —
executed by one runner that composes the machinery the repo already has:

- the broker itself boots in-process on a real TCP listener (port 0,
  so parallel runs never collide);
- traffic drives through wire-true MQTT clients (:class:`ScenarioClient`
  speaks the full QoS0/1/2 state machine, wills, v5 properties);
- faults come from ``faults`` (seeded storms, ``drop_fleet`` mass
  disconnects) and the durable plane's kill -9 crash-image pattern;
- the GATE is the SLO engine: each spec names burn-rate objectives over
  the scenario's own delivery-oracle counters
  (``mqtt_tpu_scenario_*_total``), and the verdict is "no objective
  breached" — the same alerting math production runs, pointed at a
  reproducible drill.

Determinism: every scenario runs from its spec seed (``run_scenario``
accepts an override) — fault victims, payload padding, and key material
all draw from that one ``random.Random``, so a red run replays exactly.

The epoch re-key protocol exercised by ``tenant_rekey``: clients that
opt into rotation stamp every nonce with the epoch tag they seal under
(``tenancy.epoch_tag_nonce``) — inert before the first rotation, and
the unambiguous drain discriminator after it.
"""

from __future__ import annotations

import asyncio
import json
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

from . import packets as pkts
from .packets import (
    CONNACK,
    PINGRESP,
    PUBACK,
    PUBCOMP,
    PUBLISH,
    PUBREC,
    PUBREL,
    SUBACK,
    ConnectParams,
    FixedHeader,
    Packet,
    Properties,
    Subscription,
    decode_length,
    decode_packet,
    encode_packet,
)
from .slo import SLOEngine, parse_objectives

__all__ = [
    "SCENARIOS",
    "ScenarioBroker",
    "ScenarioClient",
    "ScenarioSpec",
    "DeliveryOracle",
    "run_scenario",
    "run_matrix",
    "scenario_names",
]

# one whole-scenario watchdog: a wedged drill must fail, not hang
RUN_TIMEOUT_S = 180.0
# synthetic gate span: the delivery oracle settles its counters, then
# the SLO engine sees exactly two snapshots GATE_SPAN_S apart — inside
# both burn windows of every catalog objective, so one bad event burns
GATE_SPAN_S = 3.0

_IO_TIMEOUT = 15.0


# -- declarative specs -------------------------------------------------------


@dataclass(frozen=True)
class ScenarioSpec:
    """One catalog row: everything a run needs except the driver code.

    ``objectives`` are SLO objective spec strings (the ``slo`` grammar)
    — the gate; ``params`` the fleet/traffic/fault shape the driver
    reads; ``smoke`` marks the cheap rows (``scenario_names(smoke_only=
    True)``)."""

    name: str
    title: str
    seed: int
    objectives: tuple[str, ...]
    params: dict = field(default_factory=dict)
    smoke: bool = False


# -- the delivery oracle -----------------------------------------------------


class DeliveryOracle:
    """Exactly-once bookkeeping for one scenario: drivers declare every
    delivery they expect (a hashable key per (subscriber, message)) and
    record every delivery that arrives; ``settle`` publishes the verdict
    as ``mqtt_tpu_scenario_*_total`` counters for the SLO gate.

    A delivery nobody expected (a leaked will, a post-retirement
    ciphertext) counts as a duplicate — a message that should not have
    happened is budget spend, not a free event."""

    def __init__(self, scenario: str) -> None:
        self.scenario = scenario
        self.expected: set = set()
        self.got: dict = {}
        self.faults = 0  # injected fault events (drops, stale sends)

    def expect(self, key: Any) -> None:
        self.expected.add(key)

    def deliver(self, key: Any) -> None:
        self.got[key] = self.got.get(key, 0) + 1

    def fault(self, n: int = 1) -> None:
        self.faults += n

    def gaps(self) -> int:
        return sum(1 for k in self.expected if k not in self.got)

    def complete(self) -> bool:
        return self.gaps() == 0

    def summary(self) -> dict:
        dups = sum(c - 1 for k, c in self.got.items() if k in self.expected)
        unexpected = sum(
            c for k, c in self.got.items() if k not in self.expected
        )
        return {
            "expected": len(self.expected),
            "delivered": sum(self.got.values()),
            "gaps": self.gaps(),
            "duplicates": dups + unexpected,
            "faults": self.faults,
        }

    def settle(self, registry: Any) -> dict:
        """Publish the final tallies as labeled counters on the
        scenario broker's registry — the families the catalog's SLO
        objectives (slo.RATIO_SLIS ``scenario_gap``/``scenario_dup``)
        name."""
        s = self.summary()
        lab = {"scenario": self.scenario}
        registry.counter(
            "mqtt_tpu_scenario_expected_total",
            "Deliveries the scenario oracle expected",
            **lab,
        ).inc(s["expected"])
        registry.counter(
            "mqtt_tpu_scenario_delivered_total",
            "Deliveries the scenario oracle observed",
            **lab,
        ).inc(s["delivered"])
        registry.counter(
            "mqtt_tpu_scenario_gaps_total",
            "Expected deliveries that never arrived (lost messages)",
            **lab,
        ).inc(s["gaps"])
        registry.counter(
            "mqtt_tpu_scenario_duplicates_total",
            "Repeat or unexpected deliveries (exactly-once violations)",
            **lab,
        ).inc(s["duplicates"])
        registry.counter(
            "mqtt_tpu_scenario_faults_total",
            "Fault events the scenario script injected",
            **lab,
        ).inc(s["faults"])
        return s


class ScenarioGate:
    """The SLO verdict over one scenario: a dedicated engine on the
    broker's own telemetry registry, driven by a synthetic clock so the
    burn windows close deterministically — baseline tick at t=0, the
    settled counters at t=GATE_SPAN_S, breach iff the spec's budget is
    burnt in both windows (the engine's production entry rule)."""

    def __init__(self, telemetry: Any, objective_specs: tuple) -> None:
        self._now = 0.0
        self.engine = SLOEngine(
            telemetry,
            parse_objectives(list(objective_specs)),
            clock=lambda: self._now,
        )
        self.engine.evaluate()

    def verdict(self) -> tuple[bool, list]:
        self._now += GATE_SPAN_S
        self.engine.evaluate()
        rows = list(self.engine.state().values())
        return (not any(r["breached"] for r in rows)), rows


# -- in-process broker + wire-true client ------------------------------------


class ScenarioBroker:
    """One in-process broker on a real localhost TCP listener. Port 0:
    the kernel assigns, ``start`` reads the bound port back, parallel
    labs never collide. Add hooks (storage, auth) between construction
    and ``start``. Without ``options`` the broker runs its device planes
    on ``device``."""

    def __init__(
        self,
        options: Optional[Any] = None,
        listener_id: str = "scn",
        device: str = "cuda",
    ) -> None:
        from .hooks.auth import AllowHook
        from .listeners import Config as LConfig
        from .listeners.tcp import TCP
        from .server import Options, Server

        self.server = Server(
            options or Options(inline_client=False, device=device)
        )
        self.server.add_hook(AllowHook())
        self._lid = listener_id
        self.server.add_listener(
            TCP(LConfig(type="tcp", id=listener_id, address="127.0.0.1:0"))
        )
        self.port = 0

    async def start(self) -> "ScenarioBroker":
        await self.server.serve()
        addr = self.server.listeners.get(self._lid).address()
        self.port = int(addr.rsplit(":", 1)[1])
        return self

    async def stop(self) -> None:
        await self.server.close()

    def total_inflight(self) -> int:
        """The broker-side inflight oracle: QoS windows still open
        across every session (the QoS2 scenario requires 0 after the
        fleet settles — exactly-once AND fully drained)."""
        with self.server.clients._lock:
            sessions = list(self.server.clients.internal.values())
        return sum(len(cl.state.inflight) for cl in sessions)


async def _read_packet(
    reader: asyncio.StreamReader, version: int, timeout: float = _IO_TIMEOUT
) -> Packet:
    first = await asyncio.wait_for(reader.readexactly(1), timeout)
    buf = bytearray(first)
    while True:
        b = await asyncio.wait_for(reader.readexactly(1), timeout)
        buf += b
        if not (b[0] & 0x80):
            break
    remaining, _ = decode_length(bytes(buf), 1)
    if remaining:
        buf += await asyncio.wait_for(reader.readexactly(remaining), timeout)
    return decode_packet(bytes(buf), version)


class ScenarioClient:
    """A wire-true MQTT client for scenario drivers: real TCP, real
    frames, the full QoS1/QoS2 acknowledgment state machine on both
    directions, wills with v5 delay intervals.

    Inbound QoS2 follows method A (deliver on PUBLISH, guard repeats by
    packet id until PUBREL releases the window); ``withhold_pubcomp``
    freezes the receiver mid-window — the kill -9 scenario's way of
    pinning broker-side QoS2 state for the crash image."""

    def __init__(
        self,
        port: int,
        cid: str,
        version: int = 4,
        host: str = "127.0.0.1",
    ) -> None:
        self.port = port
        self.cid = cid
        self.version = version
        self.host = host
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.on_publish: Optional[Callable[[str, bytes, Packet], None]] = None
        self.withhold_pubcomp = False
        self.pubrel_seen: set[int] = set()
        self.session_present = False
        self._incoming: set[int] = set()  # inbound QoS2 windows mid-flight
        self._acks: dict[tuple[int, int], asyncio.Future] = {}
        self._pid = 0
        self._pump: Optional[asyncio.Task] = None

    # -- connection lifecycle ---------------------------------------------

    async def connect(
        self,
        clean: bool = True,
        keepalive: int = 120,
        will: Optional[tuple] = None,
        will_delay: int = 0,
    ) -> bool:
        """CONNECT and start the pump; returns session-present. ``will``
        is ``(topic, payload, qos, retain)``; a non-zero ``will_delay``
        needs version 5 (the delay rides the will properties)."""
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port
        )
        cp = ConnectParams(
            protocol_name=b"MQTT",
            clean=clean,
            keepalive=keepalive,
            client_identifier=self.cid,
        )
        if will is not None:
            cp.will_flag = True
            cp.will_topic = will[0]
            cp.will_payload = will[1]
            cp.will_qos = will[2] if len(will) > 2 else 0
            cp.will_retain = bool(will[3]) if len(will) > 3 else False
            if will_delay:
                props = Properties()
                props.will_delay_interval = will_delay
                cp.will_properties = props
        pk = Packet(
            fixed_header=FixedHeader(type=pkts.CONNECT),
            protocol_version=self.version,
            connect=cp,
        )
        self.writer.write(encode_packet(pk))
        await self.writer.drain()
        ack = await _read_packet(self.reader, self.version)
        if ack.fixed_header.type != CONNACK or ack.reason_code != 0:
            raise RuntimeError(
                f"{self.cid}: CONNACK code {ack.reason_code:#x}"
            )
        self.session_present = bool(getattr(ack, "session_present", False))
        self._pump = asyncio.get_running_loop().create_task(self._pump_loop())
        return self.session_present

    async def disconnect(self) -> None:
        """Graceful DISCONNECT then close (wills must NOT fire)."""
        if self.writer is not None:
            self.writer.write(
                encode_packet(
                    Packet(
                        fixed_header=FixedHeader(type=pkts.DISCONNECT),
                        protocol_version=self.version,
                    )
                )
            )
            await self.writer.drain()
        await self.close()

    def abort(self) -> None:
        """TCP-RST teardown, the shape ``faults.drop_fleet`` leaves."""
        if self.writer is not None:
            self.writer.transport.abort()

    async def close(self) -> None:
        if self._pump is not None and not self._pump.done():
            self._pump.cancel()
            try:
                await self._pump
            except (asyncio.CancelledError, Exception):  # noqa: BLE001  # brokerlint: ok=R4 teardown must swallow any transport error shape
                pass
        if self.writer is not None:
            try:
                self.writer.close()
            except (OSError, RuntimeError):
                pass

    # -- wire state machine -----------------------------------------------

    def _send(self, ptype: int, pid: int, qos: int = 0) -> None:
        assert self.writer is not None
        self.writer.write(
            encode_packet(
                Packet(
                    fixed_header=FixedHeader(type=ptype, qos=qos),
                    protocol_version=self.version,
                    packet_id=pid,
                )
            )
        )

    def _future(self, ptype: int, pid: int) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._acks[(ptype, pid)] = fut
        return fut

    def _resolve(self, ptype: int, pid: int, pk: Packet) -> None:
        fut = self._acks.pop((ptype, pid), None)
        if fut is not None and not fut.done():
            fut.set_result(pk)  # brokerlint: ok=R12 pump and submitters share the client's one lab loop

    async def _pump_loop(self) -> None:
        assert self.reader is not None
        try:
            while True:
                pk = await _read_packet(self.reader, self.version, 3600.0)
                t = pk.fixed_header.type
                if t == PUBLISH:
                    self._on_inbound_publish(pk)
                elif t in (PUBACK, PUBREC, PUBCOMP, SUBACK):
                    self._resolve(t, pk.packet_id, pk)
                elif t == PUBREL:
                    self.pubrel_seen.add(pk.packet_id)
                    self._incoming.discard(pk.packet_id)
                    if not self.withhold_pubcomp:
                        self._send(PUBCOMP, pk.packet_id)
                elif t == PINGRESP:
                    pass
        except (
            asyncio.CancelledError,
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            ConnectionError,
            OSError,
        ):
            return

    def _on_inbound_publish(self, pk: Packet) -> None:
        qos = pk.fixed_header.qos
        deliver = True
        if qos == 2:
            if pk.packet_id in self._incoming:
                deliver = False  # broker DUP redelivery of an open window
            else:
                self._incoming.add(pk.packet_id)
            self._send(PUBREC, pk.packet_id)
        elif qos == 1:
            self._send(PUBACK, pk.packet_id)
        if deliver and self.on_publish is not None:
            self.on_publish(pk.topic_name, bytes(pk.payload), pk)

    def next_pid(self) -> int:
        self._pid = self._pid % 65000 + 1
        return self._pid

    async def subscribe(self, flt: str, qos: int = 0) -> None:
        assert self.writer is not None
        pid = self.next_pid()
        fut = self._future(SUBACK, pid)
        self.writer.write(
            encode_packet(
                Packet(
                    fixed_header=FixedHeader(type=pkts.SUBSCRIBE, qos=1),
                    protocol_version=self.version,
                    packet_id=pid,
                    filters=[Subscription(filter=flt, qos=qos)],
                )
            )
        )
        await self.writer.drain()
        await asyncio.wait_for(fut, _IO_TIMEOUT)

    async def publish(
        self,
        topic: str,
        payload: bytes,
        qos: int = 0,
        retain: bool = False,
    ) -> None:
        """PUBLISH and run the ack cycle to completion: QoS1 waits for
        PUBACK; QoS2 waits PUBREC, sends PUBREL, waits PUBCOMP."""
        assert self.writer is not None
        pid = self.next_pid() if qos else 0
        rec = self._future(PUBREC, pid) if qos == 2 else None
        ack = self._future(PUBACK, pid) if qos == 1 else None
        self.writer.write(
            encode_packet(
                Packet(
                    fixed_header=FixedHeader(
                        type=PUBLISH, qos=qos, retain=retain
                    ),
                    protocol_version=self.version,
                    topic_name=topic,
                    packet_id=pid,
                    payload=payload,
                )
            )
        )
        await self.writer.drain()
        if ack is not None:
            await asyncio.wait_for(ack, _IO_TIMEOUT)
        if rec is not None:
            await asyncio.wait_for(rec, _IO_TIMEOUT)
            comp = self._future(PUBCOMP, pid)
            self._send(PUBREL, pid, qos=1)
            await self.writer.drain()
            await asyncio.wait_for(comp, _IO_TIMEOUT)


# -- run context + helpers ---------------------------------------------------


class ScenarioRun:
    """Mutable state one driver threads through: the seeded rng, the
    delivery oracle, driver metrics, structural ``require`` failures,
    and the SLO gate (armed on the scenario's broker, closed at
    ``settle``)."""

    def __init__(
        self, spec: ScenarioSpec, rng: random.Random, device: str = "cuda"
    ) -> None:
        self.spec = spec
        self.rng = rng
        self.device = device  # every broker the driver builds runs here
        self.oracle = DeliveryOracle(spec.name)
        self.metrics: dict = {}
        self.failures: list[str] = []
        self._gate: Optional[ScenarioGate] = None
        self._slo_passed = True
        self._slo_rows: list = []

    def gate(self, server: Any) -> None:
        self._gate = ScenarioGate(server.telemetry, self.spec.objectives)

    def require(self, cond: bool, msg: str) -> None:
        if not cond:
            self.failures.append(msg)

    def settle(self, server: Any) -> dict:
        s = self.oracle.settle(server.telemetry.registry)
        if self._gate is not None:
            self._slo_passed, self._slo_rows = self._gate.verdict()
        return s

    def result(self, wall_s: float, seed_used: int) -> dict:
        s = self.oracle.summary()
        return {
            "scenario": self.spec.name,
            "title": self.spec.title,
            "seed": seed_used,
            "smoke": self.spec.smoke,
            "passed": self._slo_passed and not self.failures,
            "oracle": s,
            "slo": {"passed": self._slo_passed, "objectives": self._slo_rows},
            "failures": list(self.failures),
            "metrics": dict(self.metrics),
            "wall_s": round(wall_s, 3),
        }


async def _await_complete(
    oracle: DeliveryOracle, timeout: float = 20.0, grace: float = 0.15
) -> None:
    """Poll until every expected delivery landed (or timeout — the gap
    then shows in the settled counters), plus a short grace window so a
    late duplicate still gets counted."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if oracle.complete():
            break
        await asyncio.sleep(0.02)
    await asyncio.sleep(grace)


async def _wait_for(
    cond: Callable[[], bool], timeout: float = 10.0
) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.02)
    return False


def _body(tag: str, size: int, rng: random.Random) -> bytes:
    """A self-describing payload: ``tag:`` header, deterministic pad to
    ``size`` bytes (the oracle key parses back out of the prefix)."""
    head = (tag + ":").encode()
    if len(head) >= size:
        return head
    block = bytes(rng.getrandbits(8) for _ in range(64))
    pad = (block * (size // 64 + 1))[: size - len(head)]
    return head + pad


def _tag_of(payload: bytes) -> str:
    return payload.split(b":", 1)[0].decode("utf-8", "replace")


# -- scenario drivers --------------------------------------------------------


async def _drive_payload_sweep(run: ScenarioRun) -> None:
    """The payload ladder, 16B -> 1MB, through BOTH delivery paths: the
    encode-once plaintext fan-out and the per-subscriber recrypt path
    (client-side sealed publishes re-keyed to each subscriber). The
    re-encryption keeps the default ``recrypt_device_min_blocks``: the
    keystream kernel on the card (the JAX driver pushes it high)."""
    from .server import Options

    p = run.spec.params
    sizes = list(p["sizes"])
    rc_sizes = list(p["recrypt_sizes"])
    msgs = int(p["msgs_per_size"])
    fanout = int(p["fanout"])

    def recorder(cid: str, opener: Optional[Callable[[bytes], bytes]] = None):
        def on_pub(topic: str, payload: bytes, pk: Packet) -> None:
            body = opener(payload) if opener is not None else payload
            tag = _tag_of(body)
            run.oracle.deliver((cid, tag, len(body)))

        return on_pub

    # leg 1: encode-once plaintext fan-out (the full ladder)
    b = await ScenarioBroker(device=run.device).start()
    clients: list[ScenarioClient] = []
    try:
        for i in range(fanout):
            c = ScenarioClient(b.port, f"swp-s{i}")
            await c.connect()
            c.on_publish = recorder(c.cid)
            await c.subscribe("sweep/#", qos=1)
            clients.append(c)
        pub = ScenarioClient(b.port, "swp-pub")
        await pub.connect()
        clients.append(pub)
        sent_bytes = 0
        for size in sizes:
            for i in range(msgs):
                body = _body(f"p{size}.{i}", size, run.rng)
                for c in clients[:fanout]:
                    run.oracle.expect((c.cid, f"p{size}.{i}", len(body)))
                await pub.publish(f"sweep/{size}", body, qos=1)
                sent_bytes += len(body)
        await _await_complete(run.oracle)
    finally:
        for c in clients:
            await c.close()
        await b.stop()

    # leg 2: the recrypt ladder on a tenancy broker — the gate arms here
    key_pub = bytes(run.rng.getrandbits(8) for _ in range(16))
    key_sub = [
        bytes(run.rng.getrandbits(8) for _ in range(16)) for _ in range(fanout)
    ]
    cids = [f"swp-e{i}" for i in range(fanout)]
    tenants = {
        "lab": {
            "encrypted": ["sealed/"],
            "keys": {
                "swp-epub": key_pub.hex(),
                **{c: k.hex() for c, k in zip(cids, key_sub)},
            },
        }
    }
    users = {c: "lab" for c in cids + ["swp-epub"]}
    b2 = await ScenarioBroker(
        Options(
            inline_client=False,
            tenancy=True,
            tenants=tenants,
            tenant_users=users,
            device=run.device,
        )
    ).start()
    run.gate(b2.server)
    eng = b2.server._recrypt
    clients = []
    try:
        for i in range(fanout):
            c = ScenarioClient(b2.port, cids[i])
            await c.connect()
            key = key_sub[i]
            c.on_publish = recorder(
                c.cid, opener=lambda w, k=key: eng.open_with_key(k, w)
            )
            await c.subscribe("sealed/#", qos=1)
            clients.append(c)
        pub = ScenarioClient(b2.port, "swp-epub")
        await pub.connect()
        clients.append(pub)
        for size in rc_sizes:
            for i in range(msgs):
                body = _body(f"e{size}.{i}", size, run.rng)
                for cid in cids:
                    run.oracle.expect((cid, f"e{size}.{i}", len(body)))
                wire = eng.seal_with_key(key_pub, body)
                await pub.publish(f"sealed/{size}", wire, qos=1)
                sent_bytes += len(body)
        await _await_complete(run.oracle)
        run.require(
            eng.oracle_mismatches == 0,
            f"recrypt oracle mismatches: {eng.oracle_mismatches}",
        )
        run.metrics.update(
            {
                "sizes": len(sizes),
                "recrypt_sizes": len(rc_sizes),
                "max_payload_bytes": max(sizes),
                "sent_bytes": sent_bytes,
                "recrypt_fanouts": eng.fanouts,
            }
        )
        run.settle(b2.server)
    finally:
        for c in clients:
            await c.close()
        await b2.stop()


async def _drive_mixed_fleet(run: ScenarioRun) -> None:
    """The 1% chatty / 99% idle fleet: one publisher hammers a shared
    topic while the idle majority holds subscriptions open — the fan-out
    must stay exactly-once for every idle session."""
    p = run.spec.params
    idle = int(p["idle"])
    msgs = int(p["msgs"])
    size = int(p["payload"])

    b = await ScenarioBroker(device=run.device).start()
    run.gate(b.server)
    clients: list[ScenarioClient] = []
    try:
        for i in range(idle):
            c = ScenarioClient(b.port, f"mf-i{i}")
            await c.connect(keepalive=600)
            c.on_publish = (
                lambda topic, payload, pk, cid=c.cid: run.oracle.deliver(
                    (cid, _tag_of(payload))
                )
            )
            await c.subscribe("fleet/#", qos=1)
            clients.append(c)
        chatty = ScenarioClient(b.port, "mf-chatty")
        await chatty.connect()
        clients.append(chatty)
        t0 = time.perf_counter()
        for seq in range(msgs):
            body = _body(f"m{seq}", size, run.rng)
            for c in clients[:idle]:
                run.oracle.expect((c.cid, f"m{seq}"))
            await chatty.publish("fleet/chat", body, qos=1)
        await _await_complete(run.oracle)
        wall = time.perf_counter() - t0
        run.metrics.update(
            {
                "fleet": idle + 1,
                "msgs": msgs,
                "deliveries_per_sec": round(idle * msgs / max(wall, 1e-6)),
            }
        )
        run.settle(b.server)
    finally:
        for c in clients:
            await c.close()
        await b.stop()


async def _drive_qos2_fanout(run: ScenarioRun) -> None:
    """QoS2 exactly-once at fan-out, two legs:

    1. the wide leg — ``fanout`` QoS2 subscribers across a sharded
       front-end (``loop_shards``), every PUBREC/PUBREL/PUBCOMP cycle
       runs to completion, the broker-side inflight oracle must read 0;
    2. the kill -9 leg — durable sessions freeze mid-window (receivers
       withhold PUBCOMP), the store image is copied the way a crash
       leaves it, and the next broker life restores the windows through
       the batched inflight plane and finishes the cycle with ZERO
       repeat deliveries."""
    from .hooks.storage.logkv import LogKVOptions, LogKVStore
    from .server import Options

    p = run.spec.params
    fanout = int(p["fanout"])
    msgs = int(p["msgs"])
    shards = int(p["shards"])
    d_subs = int(p["durable_subs"])
    d_msgs = int(p["durable_msgs"])

    # -- leg 1: wide fan-out across loop shards ---------------------------
    b = await ScenarioBroker(
        Options(inline_client=False, loop_shards=shards, device=run.device)
    ).start()
    # the gate arms on the wide leg's broker and closes there too — the
    # oracle spans both legs, so settle() must hit the SAME registry the
    # engine snapshots (the registry outlives the closed server)
    run.gate(b.server)
    gate_server = b.server
    clients: list[ScenarioClient] = []
    try:
        for i in range(fanout):
            c = ScenarioClient(b.port, f"q2-s{i}")
            await c.connect(keepalive=600)
            c.on_publish = (
                lambda topic, payload, pk, cid=c.cid: run.oracle.deliver(
                    (cid, _tag_of(payload))
                )
            )
            await c.subscribe("q2/t", qos=2)
            clients.append(c)
        pub = ScenarioClient(b.port, "q2-pub")
        await pub.connect()
        clients.append(pub)
        t0 = time.perf_counter()
        for seq in range(msgs):
            for c in clients[:fanout]:
                run.oracle.expect((c.cid, f"q{seq}"))
            await pub.publish("q2/t", _body(f"q{seq}", 96, run.rng), qos=2)
        await _await_complete(run.oracle)
        drained = await _wait_for(lambda: b.total_inflight() == 0)
        run.require(
            drained, f"inflight windows not drained: {b.total_inflight()}"
        )
        run.metrics.update(
            {
                "fanout": fanout,
                "qos2_deliveries": fanout * msgs,
                "qos2_deliveries_per_sec": round(
                    fanout * msgs / max(time.perf_counter() - t0, 1e-6)
                ),
            }
        )
    finally:
        for c in clients:
            await c.close()
        await b.stop()

    # -- leg 2: kill -9 mid-window, resume through the restored plane -----
    tmp = tempfile.mkdtemp(prefix="scn-q2-")  # brokerlint: ok=R11 lab harness setup on the lab's own loop, no broker traffic yet
    path = tmp + "/kv"
    crash = tmp + "/kv-crash-image"
    try:
        b1 = ScenarioBroker(Options(inline_client=False, device=run.device))
        store = LogKVStore()
        b1.server.add_hook(store, LogKVOptions(path=path, gc_interval=0))
        await b1.start()
        subs: list[ScenarioClient] = []
        try:
            for i in range(d_subs):
                c = ScenarioClient(b1.port, f"dq2-{i}")
                await c.connect(clean=False, keepalive=600)
                c.withhold_pubcomp = True
                c.on_publish = (
                    lambda topic, payload, pk, cid=c.cid: run.oracle.deliver(
                        (cid, _tag_of(payload))
                    )
                )
                await c.subscribe("dur/q2", qos=2)
                subs.append(c)
            pub = ScenarioClient(b1.port, "dq2-pub")
            await pub.connect()
            for seq in range(d_msgs):
                for c in subs:
                    run.oracle.expect((c.cid, f"d{seq}"))
                await pub.publish(
                    "dur/q2", _body(f"d{seq}", 64, run.rng), qos=2
                )
            # every receiver has PUBREC'd and seen PUBREL; the withheld
            # PUBCOMP pins the broker-side window open
            froze = await _wait_for(
                lambda: all(len(c.pubrel_seen) >= d_msgs for c in subs)
            )
            run.require(froze, "QoS2 windows never reached PUBREL")
            store.sync()  # brokerlint: ok=R11 the freeze IS the scenario: traffic is withheld while the crash image is cut
            shutil.copytree(path, crash)  # the kill -9 freeze-frame
            await pub.close()
        finally:
            for c in subs:
                c.abort()
                await c.close()
            await b1.stop()
            store.stop()

        b2 = ScenarioBroker(Options(inline_client=False, device=run.device))
        b2.server.add_hook(
            LogKVStore(), LogKVOptions(path=crash, gc_interval=0)
        )
        await b2.start()  # serve() replays the crash image (read_store)
        restored = b2.server._durable["restored_inflight"]
        run.require(
            restored >= d_subs * d_msgs,
            f"restored_inflight {restored} < {d_subs * d_msgs}",
        )
        subs2: list[ScenarioClient] = []
        try:
            for i in range(d_subs):
                c = ScenarioClient(b2.port, f"dq2-{i}")
                present = await c.connect(clean=False, keepalive=600)
                run.require(
                    present, f"{c.cid}: no session-present on resume"
                )
                # any repeat PUBLISH here is an exactly-once violation:
                # the oracle already holds life 1's deliveries
                c.on_publish = (
                    lambda topic, payload, pk, cid=c.cid: run.oracle.deliver(
                        (cid, _tag_of(payload))
                    )
                )
                subs2.append(c)
            completed = await _wait_for(
                lambda: all(len(c.pubrel_seen) >= d_msgs for c in subs2)
            )
            run.require(
                completed, "resumed QoS2 windows never re-sent PUBREL"
            )
            drained = await _wait_for(lambda: b2.total_inflight() == 0)
            run.require(
                drained,
                f"restored windows not drained: {b2.total_inflight()}",
            )
            run.metrics["restored_inflight"] = restored
            run.settle(gate_server)
        finally:
            for c in subs2:
                await c.close()
            await b2.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # brokerlint: ok=R11 lab teardown, both broker lives already closed


async def _drive_will_storm(run: ScenarioRun) -> None:
    """The will-message storm: a seeded mass disconnect
    (``faults.drop_fleet``) rips ``victims`` transports out in one tick
    — every victim's will must fire (delayed wills after their interval)
    while the control groups stay silent: clean DISCONNECTs and session
    takeovers must NOT leak a will."""
    from .faults import drop_fleet

    p = run.spec.params
    fleet_n = int(p["fleet"])
    victims_n = int(p["victims"])
    delayed_n = int(p["delayed"])
    leavers_n = int(p["clean_leavers"])
    delay_s = int(p["will_delay_s"])

    b = await ScenarioBroker(device=run.device).start()
    run.gate(b.server)
    watcher = ScenarioClient(b.port, "will-watch")
    fleet: list[ScenarioClient] = []
    extra: list[ScenarioClient] = []
    try:
        await watcher.connect(keepalive=600)
        watcher.on_publish = lambda topic, payload, pk: run.oracle.deliver(
            ("will", topic)
        )
        await watcher.subscribe("wills/#", qos=1)

        for i in range(fleet_n):
            c = ScenarioClient(b.port, f"wf-{i}", version=5)
            await c.connect(
                keepalive=600,
                will=(f"wills/w{i}", c.cid.encode(), 1, False),
                will_delay=delay_s if i < delayed_n else 0,
            )
            fleet.append(c)

        # control group 1: clean leavers — DISCONNECT suppresses the will
        for i in range(leavers_n):
            c = ScenarioClient(b.port, f"wl-{i}", version=5)
            await c.connect(will=(f"wills/l{i}", b"leak", 1, False))
            await c.disconnect()

        # control group 2: session takeover — the second CONNECT on the
        # same id must not fire the first incarnation's will
        tk1 = ScenarioClient(b.port, "wt-0", version=5)
        await tk1.connect(will=("wills/t0", b"leak", 1, False))
        tk2 = ScenarioClient(b.port, "wt-0", version=5)
        await tk2.connect(will=("wills/t0", b"leak", 1, False))
        extra.extend([tk1, tk2])

        victims = drop_fleet(
            [c.writer for c in fleet], victims_n, run.rng.randrange(1 << 30)
        )
        run.oracle.fault(len(victims))
        for i in victims:
            run.oracle.expect(("will", f"wills/w{i}"))
        await _await_complete(
            run.oracle, timeout=delay_s + 8.0, grace=0.5
        )
        run.metrics.update(
            {
                "fleet": fleet_n,
                "victims": len(victims),
                "delayed_wills": sum(1 for i in victims if i < delayed_n),
            }
        )
        run.settle(b.server)
    finally:
        for c in [watcher, *fleet, *extra]:
            await c.close()
        await b.stop()


async def _drive_bridge_federation(run: ScenarioRun) -> None:
    """The 3-worker bridge topology: three in-process brokers joined by
    the cluster fabric, publishers on two workers, the subscriber on the
    third — every cross-worker delivery exactly once, zero forwards
    dropped."""
    from .cluster import Cluster

    p = run.spec.params
    workers = int(p["workers"])
    msgs = int(p["msgs_per_publisher"])

    sockdir = tempfile.mkdtemp(prefix="scn-fed-")  # brokerlint: ok=R11 lab harness setup on the lab's own loop, no broker traffic yet
    brokers: list[ScenarioBroker] = []
    clusters: list[Cluster] = []
    clients: list[ScenarioClient] = []
    try:
        for i in range(workers):
            brokers.append(
                await ScenarioBroker(
                    listener_id=f"fed{i}", device=run.device
                ).start()
            )
        for i, br in enumerate(brokers):
            c = Cluster(br.server, i, workers, sockdir)
            clusters.append(c)
            await c.start()
        meshed = await _wait_for(
            lambda: all(c.peer_count == workers - 1 for c in clusters)
        )
        run.require(meshed, "cluster peers never fully meshed")
        run.gate(brokers[-1].server)

        sub = ScenarioClient(brokers[-1].port, "fed-sub")
        await sub.connect(keepalive=600)
        sub.on_publish = lambda topic, payload, pk: run.oracle.deliver(
            _tag_of(payload)
        )
        await sub.subscribe("fed/#", qos=1)
        clients.append(sub)
        # the publishers' workers must see the subscriber's interest
        # before traffic starts (presence gossip, not a barrier)
        seen = await _wait_for(
            lambda: all(
                (workers - 1) in c._interested_peers("fed/x")
                for c in clusters[: workers - 1]
            )
        )
        run.require(seen, "subscriber presence never reached publishers")

        pubs = []
        for w in range(workers - 1):
            pc = ScenarioClient(brokers[w].port, f"fed-pub{w}")
            await pc.connect()
            pubs.append(pc)
            clients.append(pc)
        for seq in range(msgs):
            for w, pc in enumerate(pubs):
                run.oracle.expect(f"w{w}.{seq}")
                await pc.publish(
                    f"fed/w{w}", _body(f"w{w}.{seq}", 96, run.rng), qos=1
                )
        await _await_complete(run.oracle)
        dropped = sum(c.dropped_forwards for c in clusters)
        run.require(dropped == 0, f"{dropped} forwards dropped")
        run.metrics.update(
            {
                "workers": workers,
                "cross_worker_msgs": msgs * (workers - 1),
                "dropped_forwards": dropped,
            }
        )
        run.settle(brokers[-1].server)
    finally:
        for c in clients:
            await c.close()
        for c in clusters:
            await c.stop()
        for br in brokers:
            await br.stop()
        shutil.rmtree(sockdir, ignore_errors=True)  # brokerlint: ok=R11 lab teardown, all workers already closed


async def _drive_tenant_rekey(run: ScenarioRun) -> None:
    """The tentpole oracle: LIVE tenant re-key under sustained publish
    load with zero delivery gaps and zero old-key leaks.

    Protocol under test: the publisher stamps
    every nonce with the epoch tag it seals under
    (``tenancy.epoch_tag_nonce`` — inert pre-rotation); the broker
    stages the new generation, announces ``distributing`` on
    ``$SYS/broker/tenant/rekey``, re-seals retained ciphertext in
    batched dispatches, activates (``active`` notice carries the new
    epoch), and the publisher switches keys on that notice. In-flight
    old-epoch publishes keep decrypting through the drain; after
    ``retire_tenant_epoch`` they drop as stale and every delivery must
    carry the new epoch's tag."""
    from .server import Options
    from .tenancy import epoch_tag_nonce, nonce_epoch

    p = run.spec.params
    msgs = int(p["msgs"])
    rekey_at = int(p["rekey_at"])
    post_retire = int(p["post_retire_msgs"])
    stale_sends = int(p["stale_sends"])
    size = int(p["payload"])

    k0_pub = bytes(run.rng.getrandbits(8) for _ in range(16))
    k0_sub = bytes(run.rng.getrandbits(8) for _ in range(16))
    k1_pub = bytes(run.rng.getrandbits(8) for _ in range(16))
    k1_sub = bytes(run.rng.getrandbits(8) for _ in range(16))

    b = await ScenarioBroker(
        Options(
            inline_client=False,
            tenancy=True,
            tenants={
                "flt": {
                    "encrypted": ["sealed/"],
                    "keys": {"rk-pub": k0_pub.hex(), "rk-sub": k0_sub.hex()},
                }
            },
            tenant_users={"rk-pub": "flt", "rk-sub": "flt"},
            device=run.device,
        )
    ).start()
    run.gate(b.server)
    eng = b.server._recrypt
    sub_keys = {0: k0_sub, 1: k1_sub}
    epochs_seen: dict[int, Optional[int]] = {}
    retained_seen: list[Optional[int]] = []
    notices: list[dict] = []
    sub = ScenarioClient(b.port, "rk-sub")
    pub = ScenarioClient(b.port, "rk-pub")
    try:
        await sub.connect(keepalive=600)

        def on_sub(topic: str, payload: bytes, pk: Packet) -> None:
            epoch = nonce_epoch(payload[: eng.nonce_bytes])
            key = sub_keys.get(epoch if epoch is not None else 0)
            if key is None:
                return
            body = eng.open_with_key(key, payload)
            tag = _tag_of(body)
            if tag == "ret":
                retained_seen.append(epoch)
                return
            try:
                seq = int(tag[1:])
            except ValueError:
                return
            epochs_seen[seq] = epoch
            run.oracle.deliver(("seq", seq))

        sub.on_publish = on_sub
        await sub.subscribe("sealed/data", qos=1)

        await pub.connect(keepalive=600)
        pub.on_publish = lambda topic, payload, pk: notices.append(
            json.loads(payload)
        )
        await pub.subscribe("$SYS/broker/tenant/rekey", qos=0)

        # seal state the background publisher reads each tick: the
        # epoch tag is stamped from the START — inert before rotation,
        # the drain discriminator after it
        seal = {"key": k0_pub, "epoch": 0}

        async def publish_seq(seq: int) -> None:
            body = _body(f"s{seq}", size, run.rng)
            nonce = epoch_tag_nonce(eng.next_nonce(), seal["epoch"])
            wire = eng.seal_with_key(seal["key"], body, nonce=nonce)
            run.oracle.expect(("seq", seq))
            await pub.publish("sealed/data", wire, qos=1)

        # retained row pre-rotation (re-sealed across the rekey)
        ret_wire = eng.seal_with_key(
            k0_pub,
            _body("ret", size, run.rng),
            nonce=epoch_tag_nonce(eng.next_nonce(), 0),
        )
        await pub.publish("sealed/retained", ret_wire, qos=1, retain=True)

        for seq in range(rekey_at):
            await publish_seq(seq)

        # sustained load through the rotation
        done = asyncio.Event()

        async def pump_load() -> None:
            for seq in range(rekey_at, msgs):
                await publish_seq(seq)
                await asyncio.sleep(0.003)
            done.set()

        load = asyncio.get_running_loop().create_task(pump_load())
        await asyncio.sleep(0.02)
        res = b.server.rekey_tenant(
            "flt", {"rk-pub": k1_pub, "rk-sub": k1_sub}
        )
        # the publisher switches keys the way a real client would: on
        # the $SYS "active" notice, not on a side channel
        switched = await _wait_for(
            lambda: any(n.get("state") == "active" for n in notices)
        )
        run.require(switched, "no 'active' rekey notice observed")
        seal["key"] = k1_pub
        seal["epoch"] = res["epoch"]
        await done.wait()
        await load
        await _await_complete(run.oracle)

        # drain is complete: retire the old generation
        b.server.retire_tenant_epoch("flt", res["old_epoch"])
        retired = await _wait_for(
            lambda: any(n.get("state") == "retired" for n in notices)
        )
        run.require(retired, "no 'retired' rekey notice observed")

        # stale leg: old-epoch publishes past retirement must DROP
        stale_before = eng.stale_epoch_drops
        for i in range(stale_sends):
            body = _body(f"x{i}", size, run.rng)
            nonce = epoch_tag_nonce(eng.next_nonce(), 0)
            await pub.publish(
                "sealed/data", eng.seal_with_key(k0_pub, body, nonce=nonce),
                qos=1,
            )
            run.oracle.fault()
        dropped = await _wait_for(
            lambda: eng.stale_epoch_drops - stale_before >= stale_sends,
            timeout=5.0,
        )
        run.require(dropped, "stale old-epoch publishes were not dropped")

        # post-retirement traffic: every delivery must carry the new tag
        for seq in range(msgs, msgs + post_retire):
            await publish_seq(seq)
        await _await_complete(run.oracle)

        # retained survived the rotation re-sealed: a fresh subscription
        # decrypts it under the NEW generation
        await sub.subscribe("sealed/retained", qos=1)
        got_ret = await _wait_for(lambda: len(retained_seen) > 0)
        run.require(got_ret, "re-sealed retained message never delivered")
        run.require(
            all(e == res["epoch"] for e in retained_seen),
            f"retained delivered under epochs {retained_seen}",
        )
        run.require(res["resealed"] >= 1, "no retained payloads re-sealed")

        leaks = sum(
            1
            for seq, e in epochs_seen.items()
            if seq >= msgs and e != res["epoch"]
        )
        run.require(leaks == 0, f"{leaks} post-retirement old-key leaks")
        run.require(
            eng.oracle_mismatches == 0,
            f"recrypt oracle mismatches: {eng.oracle_mismatches}",
        )
        run.metrics.update(
            {
                "msgs": msgs + post_retire,
                "epoch": res["epoch"],
                "resealed": res["resealed"],
                "stale_drops": eng.stale_epoch_drops,
                "old_key_leaks": leaks,
                "rekeys": eng.rekeys,
            }
        )
        run.settle(b.server)
    finally:
        await sub.close()
        await pub.close()
        await b.stop()


# -- the catalog -------------------------------------------------------------

_GAP = "scenario_gap ratio < 0.1% over 5s"
_DUP = "scenario_dup ratio < 0.1% over 5s"

SCENARIOS: dict[str, ScenarioSpec] = {
    s.name: s
    for s in (
        ScenarioSpec(
            name="payload_sweep",
            title="payload ladder 16B-1MB, encode-once + recrypt paths",
            seed=101,
            objectives=(_GAP, _DUP),
            params={
                "sizes": (16, 256, 4096, 65536, 1 << 20),
                "recrypt_sizes": (16, 256, 4096, 65536),
                "msgs_per_size": 2,
                "fanout": 2,
            },
            smoke=True,
        ),
        ScenarioSpec(
            name="mixed_fleet",
            title="1% chatty / 99% idle fleet, exactly-once fan-out",
            seed=102,
            objectives=(_GAP, _DUP),
            params={"idle": 99, "msgs": 60, "payload": 240},
            smoke=True,
        ),
        ScenarioSpec(
            name="qos2_fanout",
            title="QoS2 exactly-once at 100-sub fan-out + kill -9 resume",
            seed=103,
            objectives=(_GAP, _DUP),
            params={
                "fanout": 100,
                "msgs": 5,
                "shards": 2,
                "durable_subs": 8,
                "durable_msgs": 2,
            },
        ),
        ScenarioSpec(
            name="will_storm",
            title="will storm on seeded mass disconnect, delay + takeover",
            seed=104,
            # small expected counts: one leaked or lost will must trip
            objectives=(
                "scenario_gap ratio < 1% over 5s",
                "scenario_dup ratio < 1% over 5s",
            ),
            params={
                "fleet": 40,
                "victims": 30,
                "delayed": 8,
                "clean_leavers": 10,
                "will_delay_s": 1,
            },
        ),
        ScenarioSpec(
            name="bridge_federation",
            title="3-worker bridge topology, cross-worker exactly-once",
            seed=105,
            objectives=(_GAP, _DUP),
            params={"workers": 3, "msgs_per_publisher": 40},
        ),
        ScenarioSpec(
            name="tenant_rekey",
            title="live tenant re-key: zero gaps, zero old-key leaks",
            seed=106,
            objectives=(
                _GAP,
                _DUP,
                "rekey_stale ratio < 5% over 5s",
            ),
            params={
                "msgs": 120,
                "rekey_at": 30,
                "post_retire_msgs": 10,
                "stale_sends": 2,
                "payload": 160,
            },
        ),
    )
}

_DRIVERS: dict[str, Callable[[ScenarioRun], Awaitable[None]]] = {
    "payload_sweep": _drive_payload_sweep,
    "mixed_fleet": _drive_mixed_fleet,
    "qos2_fanout": _drive_qos2_fanout,
    "will_storm": _drive_will_storm,
    "bridge_federation": _drive_bridge_federation,
    "tenant_rekey": _drive_tenant_rekey,
}


def scenario_names(smoke_only: bool = False) -> list[str]:
    return [
        n for n, s in SCENARIOS.items() if s.smoke or not smoke_only
    ]


def run_scenario(
    name: str, seed: Optional[int] = None, device: str = "cuda"
) -> dict:
    """Execute one catalog scenario end to end, its brokers' device
    planes on ``device``; returns the result document (oracle tallies,
    SLO verdict, driver metrics). Raises KeyError for an unknown name,
    and RuntimeError for "cuda" where there is no card."""
    from .ops.flat import resolve_device

    resolve_device(device)
    spec = SCENARIOS[name]
    seed_used = spec.seed if seed is None else seed
    rng = random.Random(seed_used)
    run = ScenarioRun(spec, rng, device=device)
    t0 = time.perf_counter()
    asyncio.run(
        asyncio.wait_for(_DRIVERS[name](run), timeout=RUN_TIMEOUT_S)
    )
    return run.result(time.perf_counter() - t0, seed_used)


def run_matrix(
    names: Optional[list[str]] = None,
    smoke_only: bool = False,
    seed: Optional[int] = None,
    device: str = "cuda",
) -> list[dict]:
    """Run a set of scenarios (default: the whole catalog, or the smoke
    rows) sequentially on ``device``; a crashed driver records as a
    failed run rather than aborting the matrix. "cuda" where there is no
    card raises before any row runs."""
    from .ops.flat import resolve_device

    resolve_device(device)
    out = []
    for name in names if names is not None else scenario_names(smoke_only):
        try:
            out.append(run_scenario(name, seed=seed, device=device))
        except Exception as e:  # noqa: BLE001  # brokerlint: ok=R4 one crashed scenario must not sink the matrix; the failure IS the result
            spec = SCENARIOS.get(name)
            out.append(
                {
                    "scenario": name,
                    "title": spec.title if spec else "",
                    "seed": seed if seed is not None else (
                        spec.seed if spec else 0
                    ),
                    "smoke": bool(spec and spec.smoke),
                    "passed": False,
                    "oracle": {},
                    "slo": {"passed": False, "objectives": []},
                    "failures": [f"driver crashed: {e!r}"],
                    "metrics": {},
                    "wall_s": 0.0,
                }
            )
    return out
