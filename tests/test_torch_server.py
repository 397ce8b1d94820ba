"""The port's broker (``mqtt_tpu_torch.server.Server``) held against the JAX
package's ``Server`` on the CPU.

Scripted sessions run over loopback TCP against a JAX ``Server`` and a
port ``Server`` with the same planes: the device matcher over the stage
(``max_levels`` 4, folds by hand, no background thread), predicated
subscriptions, and in one session an encrypted tenant namespace; the
port's planes on ``device="cpu"``. The clients are ``chip_smoke``'s
``WireClient``s sending frames built by hand; every byte each client
receives, connection by connection, must be equal in both packages. Each
step waits for the broker to have processed the packets it sent (a hook
counts ``on_packet_processed``) and for every outbound queue to drain, so
the streams do not depend on timing; wall-clock time is pinned, so
message-expiry rewrites do not either.

Then the restart path: both servers run ``read_store`` from one seeded
``MemoryStore`` (20,000 subscriptions, 64 clients, 500 retained, 100
inflight) and must agree on ``subscribers`` for 2,000 seeded topics, the
``_durable`` counters, the restored clients and their inflight; the
port's device matcher must agree with the trie. And the departures: a
failing matcher closes the publisher's connection with nothing
delivered, and ``Server(Options())`` raises without CUDA. Every socket
wait carries its own limit; nothing asserts a time.
"""

import asyncio
import random
import re
import time
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs
from mqtt_tpu.server import Options as JOptions
from chip_smoke import (
    P_ALIAS,
    P_ALIAS_MAX,
    P_MESSAGE_EXPIRY,
    P_SESSION_EXPIRY,
    P_SUB_ID,
    P_WILL_DELAY,
    PUBACK,
    PUBCOMP,
    PUBREC,
    PUBREL,
    WireClient,
    ack_frame,
    connect_frame,
    disconnect_frame,
    publish_frame,
    subscribe_frame,
    unsubscribe_frame,
)

NOW = 1_760_000_000.0  # the pinned wall clock (message-expiry rewrites read it)
LIMIT = 60.0  # seconds any one wait may take


def package(name: str):
    """The modules of one package that a session drives."""
    if name == "jax":
        from mqtt_tpu import hooks, listeners, server
        from mqtt_tpu.hooks import auth
        from mqtt_tpu.hooks.storage import memory
    else:
        from mqtt_tpu_torch import hooks, listeners, server
        from mqtt_tpu_torch.hooks import auth
        from mqtt_tpu_torch.hooks.storage import memory
    return SimpleNamespace(name=name, hooks=hooks, listeners=listeners, server=server, auth=auth, memory=memory)


# the default planes, switched off alike in both packages unless a case
# turns them on (``planes=True``)
PLANES_OFF = dict(telemetry=False, profile=False, slo=False, overload_control=False, device_stats=False)


def options(pkg, planes=False, **kw):
    """The sessions' configuration in each package: the device matcher
    (``max_levels`` 4, no background fold) without the breaker (the
    sessions run with it in ``test_sessions_with_the_breaker_equal_the_jax_server``),
    predicates on; the default planes (the governor, telemetry, tracing,
    the host profiler, SLOs, the per-card plane) off in both unless
    ``planes`` (``test_sessions_with_the_planes_on_equal_the_jax_server``);
    the port's planes on the CPU."""
    base = dict(device_matcher=True, matcher_opts={"max_levels": 4, "background": False}, gc_tuning=False,
                matcher_resilience=False)
    if not planes:
        base.update(PLANES_OFF)
    if pkg.name == "torch":
        base.update(device="cpu")
    base.update(kw)
    return pkg.server.Options(**base)


def counting_hook(hk):
    class Processed(hk.Hook):
        """Counts every packet the broker finished processing."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def id(self):
            return "processed"

        def provides(self, b):
            return b == hk.ON_PACKET_PROCESSED

        def on_packet_processed(self, cl, pk, err):
            self.n += 1

    return Processed()


class Broker:
    """One package's ``Server`` on a TCP listener at 127.0.0.1:0 and the
    session's ``WireClient``s."""

    def __init__(self, pkg, hooks=(), **opts) -> None:
        self.pkg = pkg
        self.srv = pkg.server.Server(options(pkg, **opts))
        self.count = counting_hook(pkg.hooks)
        self.srv.add_hook(self.count)
        for hook, conf in hooks:
            self.srv.add_hook(hook, conf)
        self.srv.add_listener(pkg.listeners.TCP(pkg.listeners.Config(type="tcp", id="t", address="127.0.0.1:0")))
        self.clients: dict = {}
        self.sent = 0

    async def start(self) -> None:
        await self.srv.serve()
        if self.srv._recrypt is not None:
            self.srv._recrypt.reseed_nonce(b"\x01\x02\x03\x04\x05\x06")
        host, port = self.srv.listeners.get("t").address().rsplit(":", 1)
        self.addr = (host, int(port))

    async def connect(self, name: str, version: int = 4, **kw) -> list:
        """Open a connection, send CONNECT, wait for the CONNACK (or the
        end of a refused connection)."""
        c = self.clients.get(name)
        if c is None:
            c = self.clients[name] = WireClient(name, version)
        c.version = version
        await c.open(*self.addr)
        c.send(connect_frame(name, version, **kw))
        frames = await c.wait_frames(1, LIMIT)
        await self.settle()
        return frames

    async def send(self, name: str, *frames: bytes) -> None:
        c = self.clients[name]
        for f in frames:
            c.send(f)
        self.sent += len(frames)
        await self.settle(c)

    async def settle(self, c=None) -> None:
        """Wait until every sent packet was processed (or the sender's
        connection ended) and every outbound queue drained."""
        deadline = time.monotonic() + LIMIT
        while self.count.n < self.sent and not (c is not None and c.task.done()):
            assert time.monotonic() < deadline, f"{self.count.n} of {self.sent} packets processed"
            await asyncio.sleep(0.002)
        self.sent = self.count.n  # a packet after a fatal one is never processed
        for _ in range(50):
            if all(cl.state.outbound.empty() for cl in self.srv.clients.get_all().values()):
                break
            await asyncio.sleep(0.002)
        for _ in range(5):
            await asyncio.sleep(0)

    async def drop(self, name: str) -> None:
        """End the connection from the client's side (EOF, no DISCONNECT)."""
        await self.clients[name].half_close(LIMIT)
        await self.settle()

    def fold(self) -> None:
        """Fold the matcher's overlay, so later publishes take the device
        route (``background`` is off)."""
        self.srv.matcher.flush()

    async def close(self) -> dict:
        """Disconnect every open client, stop the server; every client's
        bytes, one entry per connection."""
        for c in self.clients.values():
            if not c.task.done():
                c.send(disconnect_frame(c.version))
                await c.ended(LIMIT)
        await self.srv.close()
        return {name: [bytes(b) for b in c.conns] for name, c in self.clients.items()}


def run_both(script, hooks_of=lambda pkg: [], **opts):
    """The script's received bytes under each package, and each broker."""
    out = {}
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            b = Broker(pkg, hooks=hooks_of(pkg), **opts)
            await b.start()
            await script(b)
            return await b.close(), b

        out[name] = asyncio.run(main())
    return out


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


def allow(pkg):
    return [(pkg.auth.AllowHook(), None)]


async def script_core(b: Broker) -> None:
    """v3/v4/v5 sessions: wildcards, $share, no-local, retain handling,
    identifiers, predicates; QoS 0/1/2 with their acks, retained, aliases
    and message expiry; unsubscribe, ping, disconnect with and without the
    will, takeover, and the inflight resend on reconnect."""
    await b.connect("s3", 3)
    await b.connect("s4", 4, clean=False)
    await b.connect("s5", 5, props=[(P_ALIAS_MAX, 4), (P_SESSION_EXPIRY, 600)])
    await b.connect("g1", 4)
    await b.connect("g2", 5)
    await b.connect("w5", 5, will=("will/w5", b"gone", 1, True, [(P_WILL_DELAY, 0)]))
    await b.connect("w4", 4, will=("will/w4", b"bye", 0, False, ()))
    await b.connect("p4", 4)
    await b.connect("p5", 5, props=[(P_ALIAS_MAX, 2)])
    # retained before anyone subscribes
    await b.send("p4", publish_frame("a/b/c", b"r1", 1, 1, retain=True), publish_frame("x/y", b"r2", retain=True))
    await b.send("p5", publish_frame("m/t", b"r3", 2, 1, retain=True, version=5,
                                     props=[(P_MESSAGE_EXPIRY, 3600)]))
    await b.send("p5", ack_frame(PUBREL, 1))
    await b.send("s3", subscribe_frame(1, [("a/+/c", 1, 0), ("x/y", 0, 0)], 3))
    await b.send("s4", subscribe_frame(2, [("a/#", 2, 0), ("m/t", 1, 0), ("will/#", 1, 0)], 4))
    await b.send("s5", subscribe_frame(3, [("a/b/c", 2, 0x08), ("#", 0, 0x10), ("m/+", 1, 0x24)], 5,
                                       props=[(P_SUB_ID, 7)]))
    await b.send("s5", subscribe_frame(4, [("t/+/temp$GT{v:20}", 1, 0), ("will/w5", 1, 0)], 5,
                                       props=[(P_SUB_ID, 9)]))
    await b.send("g1", subscribe_frame(5, [("$share/grp/a/+/c", 1, 0), ("$share/grp/t/#", 0, 0)], 4))
    await b.send("g2", subscribe_frame(6, [("$share/grp/a/+/c", 1, 0), ("$share/grp/t/#", 0, 0)], 5))
    await b.send("p5", subscribe_frame(7, [("a/b/c", 1, 0x04)], 5))  # no local
    await b.send("s3", subscribe_frame(8, [("a/+/c", 1, 0)], 3))  # an existing filter: retained again
    b.fold()
    for i in range(6):
        await b.send("p4", publish_frame("a/b/c", b"q0-%d" % i))
        await b.send("p4", publish_frame("a/z/c", b"q1-%d" % i, 1, 10 + i))
        await b.send("p5", publish_frame("a/b/c", b"q2-%d" % i, 2, 20 + i, version=5,
                                         props=[(P_MESSAGE_EXPIRY, 30)]))
        await b.send("p5", ack_frame(PUBREL, 20 + i))
        await b.send("p5", publish_frame("t/k/temp", b'{"v": %d}' % (15 + 2 * i), 1, 40 + i, version=5))
        await b.send("p5", publish_frame("m/t" if i % 2 else "", b"alias-%d" % i, 0, version=5,
                                         props=[(P_ALIAS, 1)]))
    # the subscribers' acks: QoS 1 PUBACKs, QoS 2 PUBREC then PUBCOMP
    for pid in range(1, 6):
        await b.send("s4", ack_frame(PUBREC, pid), ack_frame(PUBACK, pid))
        await b.send("s4", ack_frame(PUBCOMP, pid))
        await b.send("s5", ack_frame(PUBACK, pid), ack_frame(PUBREC, pid + 10))
        await b.send("g1", ack_frame(PUBACK, pid))
    await b.send("s3", b"\xc0\x00")  # PINGREQ
    await b.send("s5", unsubscribe_frame(9, ["#", "nope/x"], 5))
    await b.send("s3", unsubscribe_frame(10, ["x/y"], 3))
    b.fold()
    await b.send("p4", publish_frame("x/y", b"after-unsub", 1, 60), publish_frame("m/t", b"after", 1, 61))
    # s4 leaves without acking, its session persists (clean off), and
    # comes back: the unacked QoS 1/2 deliveries are resent
    await b.send("p4", publish_frame("a/q", b"unacked", 1, 62))
    await b.drop("s4")
    await b.send("p4", publish_frame("a/r", b"while-away", 1, 63))
    await b.connect("s4", 4, clean=False)
    # a takeover of g2's session by a new connection with its id
    await b.connect("g2", 5)
    await b.send("p4", publish_frame("a/k/c", b"after-takeover", 1, 64))
    # the wills: w5 disconnects with 0x04 (send the will), w4 drops
    # uncleanly (the will fires), p4 disconnects normally (no will)
    await b.send("w5", disconnect_frame(5, 0x04))
    await b.drop("w4")
    await b.send("p4", disconnect_frame(4))


def test_scripted_sessions_equal_the_jax_server(pinned_clock):
    got = run_both(script_core, allow)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert list(tout) == list(jout)
    for name in jout:
        assert tout[name] == jout[name], name
    # the session reached every flow
    assert len(tout["s4"]) == 2 and len(tout["s4"][1]) > 20
    assert sum(len(c) for conns in tout.values() for c in conns) > 2500
    assert tb.srv.info.messages_received == jb.srv.info.messages_received > 30
    assert tb.srv.matcher.stats.as_dict()["batches"] > 0
    assert tb.srv._predicates.rule_count == 1


BREAKER_GAUGES = ("state", "trips", "failures", "successes", "probes", "fallback_batches", "fallback_topics",
                  "verified_batches", "wedged_workers")


@pytest.mark.parametrize("script", ["core", "auth"])
def test_sessions_with_the_breaker_equal_the_jax_server(pinned_clock, script):
    """The scripted sessions with the matcher's breaker on in both
    packages (``matcher_resilience=True``, the JAX default): every batch
    issued and resolved on a guard thread, one topic a batch re-walked by
    the verify sample. The breaker's gauges (its failure kinds, fallback
    and verified batches, state) equal the JAX server's, and so does every
    client's bytes, connection by connection. The auth script's ``c-alice``
    sends three publishes in one write; the two it may send can land in
    two batches, resolved on two guard threads, and reach ``c-alice`` in
    either order (the JAX server's order varies from run to run), so
    there each connection's frames are compared as a multiset.

    The core script trips the breaker in both packages (the verify sample
    reads a topic that one client's two filters match as corrupt, ROADMAP
    Queue C). An open breaker re-admits the device through half-open probes
    on a wall-clock schedule (``breaker_probe_backoff_ms``, 500 ms by
    default, jittered): on a loaded host the script outlasts that delay in
    one package and not in the other, and ``probes``, ``trips``,
    ``successes`` and ``failures`` then differ while every byte is equal.
    Both packages therefore take a probe delay past any run's length, so
    no time-driven probe enters the comparison."""
    from collections import Counter

    scripts = {"core": (script_core, allow, True), "auth": (script_auth, ledger_hooks, False)}
    run, hooks_of, ordered = scripts[script]
    got = run_both(run, hooks_of, matcher_resilience=True, breaker_probe_backoff_ms=3_600_000.0,
                   breaker_probe_backoff_max_ms=3_600_000.0)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    if ordered:
        assert tout == jout
    else:
        assert list(tout) == list(jout)
        for name in jout:
            assert [Counter(cs.split_frames(c)) for c in tout[name]] == [
                Counter(cs.split_frames(c)) for c in jout[name]], name
    jg, tg = jb.srv.matcher.breaker_gauges(), tb.srv.matcher.breaker_gauges()
    assert {k: tg[k] for k in BREAKER_GAUGES} == {k: jg[k] for k in BREAKER_GAUGES}
    kinds = {k: v for k, v in tg.items() if k.startswith("failures_")}
    assert kinds == {k: v for k, v in jg.items() if k.startswith("failures_")}
    assert tg["verified_batches"] > 0 and tb.srv.matcher.stats.as_dict()["batches"] > 0


def _families(text: str) -> dict:
    """A Prometheus exposition's families (``# TYPE`` lines), each with
    the set of its samples' label sets (``le`` left out). The JAX test
    platform has eight host devices and the port's host is one, so a
    ``device`` label other than "0" is left out."""
    types = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")]
    out: dict = {name: set() for name in types}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        head = line.split(" ", 1)[0]
        name, _, labels = head.partition("{")
        if name not in out:
            name = next(name.removesuffix(sfx) for sfx in ("_bucket", "_sum", "_count") if name.endswith(sfx))
        pairs = tuple(sorted(p for p in labels.rstrip("}").split(",") if p and not p.startswith("le=")))
        if any(p.startswith("device=") and p != 'device="0"' for p in pairs):
            continue
        out[name].add(pairs)
    return out


# known departures of the port's own planes, outside this comparison: the
# first-launch ledger notes only the card's launches and builds (the CPU's
# plain versions note nothing), and the predicate engine raises a device
# failure instead of a breaker (its own gauges)
_DEPARTED_FAMILIES = ("mqtt_tpu_matcher_recompiles_total", "mqtt_tpu_predicate_device_errors_total")
_SYS_DEPARTURES = ("devices/compiles/", "telemetry/matcher_recompiles_total/", "telemetry/predicate_device_errors",
                   "predicates/breaker_state", "predicates/device_errors", "predicates/host_reasons",
                   "predicates/stale_rows")


def _sys_keys(srv) -> set:
    """The retained ``$SYS`` topics after one more tick (the rows of a
    device other than 0 left out, as in ``_families``)."""
    srv.publish_sys_topics()
    keys = {m.topic_name[len("$SYS/broker/"):] for m in srv.topics.messages("$SYS/#")}
    other_device = re.compile(r"^(devices|telemetry/device_[a-z0-9_]+)/[1-9][0-9]*(/|$)")
    return {k for k in keys if not k.startswith(_SYS_DEPARTURES) and not other_device.match(k)}


def test_sessions_with_the_planes_on_equal_the_jax_server(pinned_clock, tmp_path):
    """The scripted sessions with the default planes on in both packages:
    the governor, telemetry with stage clocks and the flight recorder,
    the tracer, the host profiler and the lock plane, the SLO engine with
    two objectives, the per-card plane. Every client's bytes equal the JAX
    server's; ``/metrics`` has the same families with the same label sets
    and the ``$SYS`` tree the same keys (the known departures apart).

    The governors evaluate at the same points in both packages: their lazy
    re-evaluation interval is set past the run (the first admission
    evaluates once, before any publish), and the housekeeping tick's
    forced evaluation (``sweep_overload``, once a second on the loop's
    clock) is driven by the script after every session settled, not by
    the wall clock. So no evaluation meets a publish in the stage in one
    package and not in the other (its ``overload/peak/*`` rows)."""
    # objectives no CPU run breaches (a breach is a timing, and its
    # retained $SYS/broker/slo/<name> row would be too)
    objectives = ["p99 delivery < 30s over 5m", "hbm ratio < 0.9 over 5m"]

    async def script(b):
        sweep, sweeps = b.srv.sweep_overload, []
        b.srv.sweep_overload = lambda: sweeps.append(1)  # the tick's sweep, held for the fixed point below
        await script_core(b)
        sweep()
        b.exposition = b.srv.telemetry.exposition()
        b.sys_keys = _sys_keys(b.srv)

    got = run_both(script, allow, planes=True, slo_objectives=objectives, telemetry_sample=4, trace_sample=8,
                   telemetry_dump_dir=str(tmp_path), overload_eval_interval_ms=3_600_000.0)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    jf, tf = _families(jb.exposition), _families(tb.exposition)
    for name in _DEPARTED_FAMILIES:
        jf.pop(name, None), tf.pop(name, None)
    assert tf == jf
    assert tb.sys_keys == jb.sys_keys
    assert {"overload/state", "telemetry/publish_sampled_total", "devices/0/hbm_ratio"} <= tb.sys_keys
    tele = tb.srv.telemetry
    assert tele.sampled_publishes.value == jb.srv.telemetry.sampled_publishes.value > 0
    assert tb.srv.tracer.publishes_total == jb.srv.tracer.publishes_total > 0
    assert set(tb.srv.slo.state()) == set(jb.srv.slo.state())
    assert tb.srv.host_profiler._thread is None and tb.srv.overload.state == "normal"


async def script_shed(b: Broker) -> None:
    """SHED forced through ``overload.add_source``: new CONNECTs refused
    (v5 0x97, v4 0x03), the publishers of a zero-weight class shed (QoS 1
    acked 0x97 on v5, QoS 0 dropped), the housekeeping sweep's verdicts."""
    await b.connect("s4", 4)
    await b.send("s4", subscribe_frame(1, [("a/#", 1, 0)], 4))
    await b.connect("p5", 5)
    await b.connect("p4", 4)
    b.fold()
    await b.send("p5", publish_frame("a/x", b"before", 1, 1, version=5))
    b.srv.overload.add_source("forced", lambda: 1.0)
    assert b.srv.overload.evaluate(force=True) == "shed"
    await b.connect("n5", 5)
    await b.connect("n4", 4)
    await b.send("p5", publish_frame("a/x", b"shed-1", 1, 2, version=5),
                 publish_frame("a/y", b"shed-0", 0, version=5))
    await b.send("p4", publish_frame("a/x", b"shed-4", 1, 3), publish_frame("a/y", b"shed-40"))
    b.health = b.srv.health_report()
    b.gauges = b.srv.overload.gauges()
    b.dropped = b.srv.info.messages_dropped


def test_forced_shed_refuses_and_sheds_as_the_jax_server(pinned_clock, tmp_path):
    """The governor forced into SHED in both packages: byte-equal CONNACKs
    (0x97 on v5, 0x03 on v4), byte-equal 0x97 PUBACKs, nothing delivered
    of the shed publishes, and an equal ``health_report`` and gauges. The
    allow-all hook makes every client an admin of ``$SYS``, so the
    always-admit reserve is 0 here."""
    got = run_both(script_shed, allow, planes=True, overload_priority_classes={"low": 0},
                   overload_priority_users={"p5": "low", "p4": "low"}, telemetry_dump_dir=str(tmp_path),
                   overload_admission_reserve=0)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    assert tout["n5"][0][0] == 0x20 and tout["n5"][0][3] == 0x97
    assert tout["n4"][0] == bytes([0x20, 0x02, 0x00, 0x03])
    acks = [f for f in cs.split_frames(tout["p5"][0]) if f[0] == 0x40]
    # a v5 PUBACK without a reason code is a success
    assert [(f[2:4], f[4] if len(f) > 4 else 0) for f in acks] == [(b"\x00\x01", 0x00), (b"\x00\x02", 0x97)]
    assert b"shed-" not in tout["s4"][0] and b"before" in tout["s4"][0]
    assert tb.health == jb.health and tb.health[0] is False and "governor_shed" in tb.health[1]["not_ready"]
    for k in ("state", "sheds", "connects_refused", "transitions"):
        assert tb.gauges[k] == jb.gauges[k], k
    assert tb.gauges["sheds"] == 4 and tb.gauges["connects_refused"] == 2
    assert tb.dropped == jb.dropped == 4


def ledger_hooks(pkg):
    """An auth ledger: user alice (password a1) allowed everywhere but
    ``secret/#``; bob denied; anyone else by the rule on client ids
    ``dev-*``; ACL rules by username."""
    led = pkg.auth.Ledger(
        users={
            "alice": pkg.auth.UserRule(username=pkg.auth.RString("alice"), password=pkg.auth.RString("a1"),
                                       acl=pkg.auth.Filters({"secret/#": pkg.auth.ACCESS_DENY,
                                                             "#": pkg.auth.ACCESS_READ_WRITE})),
            "bob": pkg.auth.UserRule(username=pkg.auth.RString("bob"), password=pkg.auth.RString("b1"),
                                     disallow=True),
        },
        auth=[pkg.auth.AuthRule(client=pkg.auth.RString("dev-*"), allow=True)],
        acl=[pkg.auth.ACLRule(client=pkg.auth.RString("dev-*"),
                              filters=pkg.auth.Filters({"ro/#": pkg.auth.ACCESS_READ_ONLY,
                                                        "wo/#": pkg.auth.ACCESS_WRITE_ONLY}))],
    )
    return [(pkg.auth.AuthHook(), pkg.auth.AuthOptions(ledger=led))]


async def script_auth(b: Broker) -> None:
    await b.connect("c-alice", 5, username="alice", password="a1")
    await b.connect("c-bob", 5, username="bob", password="b1")  # refused
    await b.connect("c-eve", 4, username="eve", password="x")  # refused
    await b.connect("dev-1", 4)
    await b.connect("dev-2", 3)
    await b.send("c-alice", subscribe_frame(1, [("secret/#", 1, 0), ("pub/#", 1, 0), ("ro/#", 0, 0)], 5))
    await b.send("dev-1", subscribe_frame(2, [("ro/#", 0, 0), ("wo/#", 0, 0)], 4))
    b.fold()
    await b.send("dev-2", publish_frame("ro/a", b"denied-write"), publish_frame("wo/a", b"allowed"))
    await b.send("c-alice", publish_frame("secret/x", b"no", 1, 1, version=5),
                 publish_frame("pub/x", b"yes", 1, 2, version=5), publish_frame("ro/b", b"to-dev", version=5))


def test_auth_ledgers_equal_the_jax_server(pinned_clock):
    got = run_both(script_auth, ledger_hooks)
    (jout, _), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    # bob (disallowed, v5) and eve (no rule, v4) were refused: one CONNACK
    # each, 0x86 Bad User Name or Password (0x05 Not Authorized on the v4
    # wire)
    assert tout["c-bob"][0][0] == 0x20 and tout["c-bob"][0][3] == 0x86
    assert tout["c-eve"] == [b"\x20\x02\x00\x05"]
    assert len(tout["dev-1"][0]) > 12 and len(tout["c-alice"][0]) > 12


TENANTS = {
    "acme": {
        "encrypted": ["secure/"],
        "keys": {"alice": "00112233445566778899aabbccddeeff", "bob": "ffeeddccbbaa99887766554433221100",
                 "carol": "0f0e0d0c0b0a09080706050403020100"},
    },
}
USERS = {"alice": "acme", "bob": "acme", "carol": "acme", "dave": "acme"}


async def script_tenant(b: Broker) -> None:
    """An encrypted namespace: alice publishes sealed payloads, bob (v4)
    and carol (v5, QoS 1) hold keys, dave holds none; the retained
    message is re-keyed for a later subscriber; then a re-key re-seals it."""
    await b.connect("alice", 4, username="alice")
    await b.connect("bob", 4, username="bob")
    await b.connect("carol", 5, username="carol")
    await b.connect("dave", 4, username="dave")
    await b.connect("glob", 4)
    for who, v in (("bob", 4), ("carol", 5), ("dave", 4)):
        await b.send(who, subscribe_frame(1, [("secure/#", 1 if who == "carol" else 0, 0), ("plain/+", 0, 0)], v))
    await b.send("glob", subscribe_frame(1, [("#", 0, 0)], 4))
    b.fold()
    eng = b.srv._recrypt
    key = bytes.fromhex(TENANTS["acme"]["keys"]["alice"])
    for i in range(4):
        sealed = eng.seal_with_key(key, b"reading-%d" % i, nonce=bytes(11) + bytes([i + 1]))
        await b.send("alice", publish_frame("secure/a", sealed, 0, retain=i == 3))
        await b.send("alice", publish_frame("plain/a", b"clear-%d" % i))
    await b.connect("late", 5, username="carol")  # carol's key, a new client id
    await b.send("late", subscribe_frame(2, [("secure/#", 0, 0)], 5))


def test_encrypted_tenant_namespace_equals_the_jax_server(pinned_clock):
    """Every tenant client's bytes equal the JAX server's. The global
    ``#`` subscriber is the port's namespace-guard departure (ROADMAP): the JAX
    device matcher ignores the trie's namespace guard, so the JAX server
    delivers the tenant's plain publishes to it once the overlay is
    folded; the port's guard keeps them inside the namespace, as the
    trie walk does. Pinned both ways."""
    got = run_both(script_tenant, allow, tenancy=True, tenants=TENANTS, tenant_users=USERS,
                   recrypt_device_min_blocks=1)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    glob_t, glob_j = tout.pop("glob"), jout.pop("glob")
    assert tout == jout
    head = b"\x20\x02\x00\x00\x90\x03\x00\x01\x00"  # CONNACK, SUBACK
    assert glob_t == [head]  # nothing crosses the namespace
    assert glob_j == [head + b"".join(publish_frame("plain/a", b"clear-%d" % i) for i in range(4))]
    assert tb.srv._recrypt.fanouts == jb.srv._recrypt.fanouts > 0
    assert 0 < tb.srv._recrypt.no_key_drops <= jb.srv._recrypt.no_key_drops
    assert len(tout["bob"][0]) > 100 and len(tout["late"][0]) > 30


# -- the restart path -------------------------------------------------------

WORDS = [f"w{i}" for i in range(48)]  # the restart corpus's level vocabulary


def seeded_store(pkg, seed: int = 7, n_subs: int = 20_000, n_clients: int = 64, n_retained: int = 500,
                 n_inflight: int = 100):
    """A ``MemoryStore`` filled through the package's ``dumps`` with
    seeded records: subscriptions (wildcards, ``$share``, identifiers, a
    few predicated), client sessions (v4 persistent, v5 with an expiry,
    a clean v3 one that the restore discards), retained messages and
    inflight messages."""
    from importlib import import_module

    st = import_module(pkg.memory.__name__.rsplit(".", 1)[0])
    base = import_module(pkg.memory.__name__.rsplit(".", 1)[0] + ".base")
    rng = random.Random(seed)
    store = pkg.memory.MemoryStore()
    words = WORDS
    cids = [f"c{i}" for i in range(n_clients)]
    for i, cid in enumerate(cids):
        v = (4, 5, 3)[i % 3]
        rec = st.Client(id=cid, listener="t", username=b"u%d" % i, clean=v == 3, protocol_version=v,
                        properties=st.ClientProperties(session_expiry_interval=3600 if v == 5 else 0,
                                                       session_expiry_interval_flag=v == 5,
                                                       receive_maximum=32))
        store._set(st.CLIENT_KEY + "_" + cid, base.dumps(rec))
    for i in range(n_subs):
        cid = cids[i % n_clients] if i < 4 * n_clients else f"o{i % 5000}"
        depth = rng.randint(1, 4)
        parts = [rng.choice(words) for _ in range(depth)]
        r = rng.random()
        if r < 0.15 and depth > 1:
            parts[rng.randrange(1, depth)] = "+"  # never a first-level wildcard
        elif r < 0.2 and depth > 1:
            parts[-1] = "#"
        flt = "/".join(parts)
        if rng.random() < 0.02:
            flt = f"$share/g{rng.randrange(4)}/" + flt
        preds = ["$GT{v:%d}" % rng.randrange(100)] if rng.random() < 0.01 else []
        rec = st.Subscription(client=cid, filter=flt, qos=rng.randrange(3), identifier=rng.choice([0, 0, 3]),
                              no_local=rng.random() < 0.05, retain_handling=rng.randrange(3), predicates=preds)
        store._set(st.SUBSCRIPTION_KEY + "_" + cid + ":" + flt, base.dumps(rec))
    for i in range(n_retained):
        topic = "/".join(rng.choice(words) for _ in range(rng.randint(1, 4))) + f"/r{i}"
        rec = st.Message(t=st.RETAINED_KEY, id=st.RETAINED_KEY + "_" + topic, topic_name=topic,
                         payload=b"ret-%d" % i, retain=True, qos=rng.randrange(2), created=int(NOW),
                         protocol_version=4)
        store._set(rec.id, base.dumps(rec))
    for i in range(n_inflight):
        cid = cids[i % n_clients]
        rec = st.Message(t=st.INFLIGHT_KEY, client=cid, id=f"{st.INFLIGHT_KEY}_{cid}:{i + 1}",
                         topic_name=f"{rng.choice(words)}/inf", payload=b"inf-%d" % i, packet_id=i + 1,
                         qos=1 + i % 2, created=int(NOW), protocol_version=4)
        store._set(rec.id, base.dumps(rec))
    return store


def restored(name: str, topics: list):
    pkg = package(name)
    store = seeded_store(pkg)
    srv = pkg.server.Server(options(pkg, durable_restore_batch=1000))
    srv.add_hook(store)
    srv.read_store()
    subs = [cs_canon(srv.topics.subscribers(t)) for t in topics]
    durable = {k: v for k, v in srv._durable.items() if k != "recovery_seconds"}
    clients = {cid: (cl.properties.protocol_version, cl.properties.clean, len(cl.state.inflight),
                     sorted(cl.state.subscriptions.get_all()))
               for cid, cl in srv.clients.get_all().items()}
    inflight = {cid: sorted((pk.packet_id, pk.fixed_header.qos, bytes(pk.payload))
                            for pk in cl.state.inflight.get_all(False))
                for cid, cl in srv.clients.get_all().items()}
    return srv, store, subs, durable, clients, inflight


def cs_canon(s):
    return (
        sorted((c, sub.filter, sub.qos, sub.identifier, tuple(sorted(sub.identifiers.items())), sub.no_local,
                sub.retain_handling, tuple(sub.predicates)) for c, sub in s.subscriptions.items()),
        sorted((g, sorted(m)) for g, m in s.shared.items()),
    )


def test_restart_from_one_store_equals_the_jax_server():
    rng = random.Random(11)
    words = WORDS
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 4))) for _ in range(2000)]
    jsrv, jstore, jsubs, jdur, jcl, jinf = restored("jax", topics)
    tsrv, tstore, tsubs, tdur, tcl, tinf = restored("torch", topics)
    try:
        assert tstore.data == jstore.data  # dumps: the same bytes for every record
        assert tsubs == jsubs
        assert sum(len(s[0]) for s in tsubs) > 2000
        assert tdur == jdur and tdur["restored_subscriptions"] > 15_000 and tdur["restore_batches"] > 20
        assert tdur["restored_retained"] == 500 and tdur["restored_inflight"] > 0
        assert tcl == jcl and len(tcl) == 43  # the 21 clean v3 sessions are discarded
        assert tinf == jinf
        assert tsrv.info.retained == jsrv.info.retained == 500
        assert tsrv._predicates.rule_count == jsrv._predicates.rule_count > 0
        # the device matcher, folded, answers as the trie
        tsrv.matcher.flush()
        got = tsrv.matcher.match_topics(topics)
        assert [cs_canon(r.materialize() if hasattr(r, "materialize") else r) for r in got] == tsubs
    finally:
        tsrv.matcher.close()
        jsrv.matcher.close()


@pytest.mark.parametrize("batch", [1, 7, 4096])
def test_bulk_restore_equals_the_jax_functions(batch):
    """``bulk_register``, ``bulk_inflight`` and ``bulk_retain``: the same
    counts and batches as the JAX functions, and the same tries."""
    from mqtt_tpu import clients as jclients
    from mqtt_tpu import packets as jp
    from mqtt_tpu import staging as jstaging
    from mqtt_tpu import topics as jtopics
    from mqtt_tpu_torch import clients as tclients
    from mqtt_tpu_torch import packets as tp
    from mqtt_tpu_torch import staging as tstaging
    from mqtt_tpu_torch import topics as ttopics

    rng = random.Random(batch)
    entries = [(f"c{rng.randrange(50)}", "/".join(rng.choice("abc+") for _ in range(rng.randint(1, 3))),
                rng.randrange(3)) for _ in range(500)]
    got = []
    for p, tmod, st, cmod, pkg in ((jp, jtopics, jstaging, jclients, package("jax")),
                                    (tp, ttopics, tstaging, tclients, package("torch"))):
        idx = tmod.TopicsIndex()
        new, nb = st.bulk_register(idx, [(c, p.Subscription(filter=f, qos=q)) for c, f, q in entries], batch=batch)
        pks = [p.Packet(fixed_header=p.FixedHeader(type=p.PUBLISH, retain=True), topic_name=f"r/{i % 40}",
                        payload=b"" if i % 9 == 0 else b"x%d" % i) for i in range(120)]
        ret, rb = st.bulk_retain(idx, pks, batch=batch)
        srv = pkg.server.Server(options(pkg, device_matcher=False, predicate_filters=False))
        for i in range(5):
            cl = srv.new_client(None, None, "t", f"c{i}", False)
            srv.clients.add_client(cl)
        base = __import__(pkg.memory.__name__.rsplit(".", 1)[0], fromlist=["Message"])
        msgs = [base.Message(client=f"c{i % 7}", packet_id=i + 1, topic_name="t", payload=b"m", qos=1)
                for i in range(60)]
        inf, ib = st.bulk_inflight(srv.clients, msgs, batch=batch)
        got.append((new, nb, ret, rb, inf, ib, sorted(idx.retained.get_all()),
                    [cs_canon(idx.subscribers(t)) for t in ("a/b", "c", "a/a/a", "b/c")]))
    assert got[0] == got[1]


def test_a_restore_folds_the_device_matcher_once():
    """``read_store`` holds the device matcher's background folds while
    it restores, so the restored state is folded once after it, however
    often the overlay passed ``rebuild_after`` meanwhile; the folded
    matcher answers as the trie."""
    pkg = package("torch")
    store = seeded_store(pkg)
    srv = pkg.server.Server(options(pkg, durable_restore_batch=1000, matcher_resilience=True,
                                    matcher_opts={"max_levels": 4, "rebuild_after": 256, "rebuild_interval": 0.01}))
    srv.add_hook(store)
    dm = srv.matcher.inner
    st = dm.stats
    before = st.rebuilds + st.folds
    try:
        srv.read_store()
        assert srv._durable["restored_subscriptions"] > 15_000
        deadline = time.monotonic() + LIMIT
        while dm.pending_deltas:
            assert time.monotonic() < deadline, f"{dm.pending_deltas} mutations not folded"
            time.sleep(0.01)
        time.sleep(0.1)  # ten more ticks of the fold thread: nothing left to fold
        assert st.rebuilds + st.folds == before + 1
        rng = random.Random(3)
        topics = ["/".join(rng.choice(WORDS) for _ in range(rng.randint(1, 4))) for _ in range(500)]
        got = srv.matcher.match_topics(topics)
        assert [cs_canon(r.materialize() if hasattr(r, "materialize") else r) for r in got] == [
            cs_canon(srv.topics.subscribers(t)) for t in topics]
    finally:
        srv.matcher.close()


# -- the departures -----------------------------------------------------------


@pytest.mark.parametrize("resilience", [True, False], ids=["breaker", "no-breaker"])
def test_a_failing_matcher_closes_the_publisher_and_delivers_nothing(pinned_clock, resilience):
    """A batch whose launch raises. With the breaker (``matcher_resilience``,
    the default), the failed batch is answered from the trie walk: the
    acknowledged QoS 1 publish is delivered, the publisher stays connected,
    and the breaker counts one ``error``, in both packages alike, byte for
    byte. Without it the stage's future raises, the publisher's connection
    ends, and no subscriber receives the publish (nor a host walk's answer
    in its place)."""

    from mqtt_tpu_torch import KernelError

    def run(name):
        pkg = package(name)
        error = KernelError if name == "torch" else RuntimeError  # the JAX package has no KernelError

        async def main():
            b = Broker(pkg, hooks=allow(pkg), matcher_resilience=resilience)
            await b.start()
            await b.connect("sub", 4)
            await b.connect("pub", 4)
            await b.send("sub", subscribe_frame(1, [("a/+", 1, 0)], 4))
            b.fold()
            await b.send("pub", publish_frame("a/b", b"before", 1, 1))

            def broken(topics, profile=None):
                raise error("flat_probe_ranges: launch failed")

            target = b.srv.matcher.inner if resilience else b.srv.matcher
            working = target.match_topics_async
            target.match_topics_async = broken
            if resilience:
                await b.send("pub", publish_frame("a/b", b"recovered", 1, 2))
                target.match_topics_async = working
                await b.send("pub", publish_frame("a/b", b"after", 1, 3))
            else:
                b.clients["pub"].send(publish_frame("a/b", b"lost", 1, 2))
                await b.clients["pub"].ended(LIMIT)
                await b.settle()
            delivered = [cs.parse_publish(f, 4)["payload"] for f in b.clients["sub"].frames()[2:]]
            stage = b.srv._stage
            gauges = b.srv.matcher.breaker_gauges() if resilience else None
            health = b.srv.health_report()
            out = await b.close()
            return delivered, out, stage, gauges, health

        return asyncio.run(main())

    delivered, out, stage, gauges, health = run("torch")
    assert not stage.fallbacks and stage.admission_fallbacks == 0
    if not resilience:
        assert delivered == [b"before"]
        # the publisher got its CONNACK and both PUBACKs (a QoS 1 publish is
        # acknowledged before its fan-out, as in the JAX server), then the
        # broker ended its connection
        assert out["pub"] == [b"\x20\x02\x00\x00\x40\x02\x00\x01\x40\x02\x00\x02"]
        return
    assert delivered == [b"before", b"recovered", b"after"]
    assert len(out["pub"]) == 1  # one connection: the publisher was never dropped
    assert gauges["failures_error"] == 1 and gauges["state"] == "closed"
    assert gauges["fallback_batches"] == 1 and gauges["fallback_topics"] == 1
    assert health[0] and health[1]["matcher_breaker"] == {"state": "closed"}
    jdelivered, jout, _jstage, jgauges, jhealth = run("jax")
    assert (delivered, out) == (jdelivered, jout)
    keys = ("state", "failures", "failures_error", "fallback_batches", "fallback_topics", "trips")
    assert {k: gauges[k] for k in keys} == {k: jgauges[k] for k in keys}
    assert health[1]["matcher_breaker"] == jhealth[1]["matcher_breaker"]


def test_default_options_raise_without_cuda():
    from mqtt_tpu_torch.server import Options, Server

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(Options())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(Options(predicate_filters=False, device_matcher=True))
    # the per-card plane is on by default: a Server without a device
    # matcher or predicates is on the card too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(Options(predicate_filters=False))
    Server(Options(device="cpu", device_matcher=True, tenancy=True, retained_matcher=True)).matcher.close()


def test_options_omit_the_planes_not_ported():
    """Every JAX ``Options`` field is the port's, the cluster's and the
    shard fabric's with the JAX defaults; only the JAX profiler switch is
    not (``trace_torch_profiler_dir`` takes its place)."""
    from mqtt_tpu_torch.server import Options

    with pytest.raises(TypeError):
        Options(trace_jax_profiler_dir="x")
    o = Options()
    assert (o.device, o.predicate_filters, o.fanout_batch, o.durable_restore_batch) == ("cuda", True, True, 4096)
    # the JAX server's default planes are on, with its defaults
    j = JOptions()
    for field in ("telemetry", "trace", "profile", "profile_locks", "slo", "device_stats", "overload_control"):
        assert getattr(o, field) is True and getattr(j, field) is True


def _seeded_ledger(auth, rng):
    """A ledger of seeded users, auth rules and ACL rules, with ``*``
    prefixes, and filters with wildcards."""
    R = auth.RString
    levels = [auth.ACCESS_DENY, auth.ACCESS_READ_ONLY, auth.ACCESS_WRITE_ONLY, auth.ACCESS_READ_WRITE]

    def pattern(prefix):
        return R(rng.choice(["", "*", f"{prefix}{rng.randrange(4)}", f"{prefix}*", f"{prefix}1*"]))

    def filters():
        return {rng.choice(["a/#", "a/+/c", "b/x", "#", "c/+", "a/b"]): rng.choice(levels) for _ in range(rng.randrange(4))}

    users = {f"u{i}": auth.UserRule(username=R(f"u{i}"), password=R(rng.choice(["", f"p{i}", "x"])),
                                    acl=filters(), disallow=rng.random() < 0.2) for i in range(4)}
    rules = [auth.AuthRule(client=pattern("c"), username=pattern("u"), password=pattern("p"),
                           remote=pattern("10.0.0."), allow=rng.random() < 0.6) for _ in range(rng.randrange(1, 5))]
    acls = [auth.ACLRule(client=pattern("c"), username=pattern("u"), remote=pattern("10.0.0."), filters=filters())
            for _ in range(rng.randrange(1, 5))]
    return auth.Ledger(users=users if rng.random() < 0.8 else None, auth=rules, acl=acls)


@pytest.mark.parametrize("seed", range(8))
def test_ledger_verdicts_equal_the_jax_package(seed):
    """``Ledger.auth_ok``/``acl_ok`` on seeded rule sets and clients, and a
    JSON round trip of the ledger, in both packages."""
    verdicts = []
    for name in ("jax", "torch"):
        auth = package(name).auth
        rng = random.Random(seed)
        led = _seeded_ledger(auth, rng)
        again = auth.Ledger()
        again.unmarshal(led.to_json())
        out = []
        for _ in range(200):
            cl = SimpleNamespace(id=f"c{rng.randrange(5)}", net=SimpleNamespace(remote=f"10.0.0.{rng.randrange(5)}"),
                                 properties=SimpleNamespace(username=f"u{rng.randrange(6)}".encode()))
            pk = SimpleNamespace(connect=SimpleNamespace(password=rng.choice([b"", b"p1", b"x", b"p2"]),
                                                         username=cl.properties.username))
            topic = rng.choice(["a/b/c", "a/b", "b/x", "c/d", "#", "z"])
            write = rng.random() < 0.5
            out.append((led.auth_ok(cl, pk), led.acl_ok(cl, topic, write), again.auth_ok(cl, pk),
                        again.acl_ok(cl, topic, write), auth.match_topic("a/+/#", topic)))
        verdicts.append((out, led.to_json()))
    assert verdicts[0] == verdicts[1]


def test_torch_profiler_capture_from_serve_to_close(tmp_path):
    """``Options.trace_torch_profiler_dir``: ``serve()`` starts a
    ``torch.profiler`` capture beside the device matcher and ``close()``
    writes its Chrome trace into the directory."""
    pkg = package("torch")

    async def main():
        srv = pkg.server.Server(options(pkg, trace_torch_profiler_dir=str(tmp_path / "trace")))
        await srv.serve()
        assert srv._torch_profiler is not None
        srv.matcher.match_topics(["a/b", "c"])
        await srv.close()
        assert srv._torch_profiler is None

    asyncio.run(main())
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_qos0_frame_passthrough_equals_the_jax_server(pinned_clock):
    """Without the device matcher (the host walk) and without hooks that
    observe packets, a v4 QoS 0 PUBLISH takes ``try_fast_publish``: its
    frame is relayed to the subscribers' sockets without a ``Packet``.
    Each step ends on the publisher's PINGRESP (the passthrough runs
    within the read loop's scan), and every client's bytes must equal the
    JAX server's."""
    outs, plans = {}, {}
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            srv = pkg.server.Server(options(pkg, device_matcher=False))
            srv.add_hook(pkg.auth.AllowHook())
            srv.add_listener(pkg.listeners.TCP(pkg.listeners.Config(type="tcp", id="t", address="127.0.0.1:0")))
            await srv.serve()
            host, port = srv.listeners.get("t").address().rsplit(":", 1)
            subs = [WireClient("f4", 4), WireClient("f5", 5), WireClient("fid", 4)]
            pub = WireClient("fp", 4)
            for c in subs + [pub]:
                await c.open(host, int(port))
                c.send(connect_frame(c.name, c.version))
                await c.wait_frames(1, LIMIT)
            subs[0].send(subscribe_frame(1, [("fa/+", 0, 0)], 4))
            subs[1].send(subscribe_frame(1, [("fa/#", 1, 0)], 5))
            subs[2].send(subscribe_frame(1, [("fa/b", 0, 0), ("$share/g/fa/c", 0, 0)], 4))
            for c in subs:
                await c.wait_frames(2, LIMIT)
            pings = 0
            for i in range(20):
                pub.send(publish_frame(["fa/b", "fa/c", "fb"][i % 3], b"p%d" % i) + b"\xc0\x00")
                pings += 1
                await pub.wait_frames(1 + pings, LIMIT)
                for _ in range(5):
                    await asyncio.sleep(0)
            for c in subs + [pub]:
                c.send(disconnect_frame(c.version))
                await c.ended(LIMIT)
            plans[name] = sorted(t for t, (_v, plan) in srv._fastpub_plans.items() if plan is not None)
            await srv.close()
            return {c.name: [bytes(b) for b in c.conns] for c in subs + [pub]}

        outs[name] = asyncio.run(main())
    assert outs["torch"] == outs["jax"]
    # fa/c has a shared group: the decode path; fb has no subscriber: an
    # empty plan
    assert plans["torch"] == plans["jax"] == ["fa/b", "fb"]
    assert len(outs["torch"]["f4"][0]) > 60


@pytest.mark.parametrize("window", [16, 63])
def test_a_filter_path_past_the_window_takes_the_host_route(pinned_clock, window):
    """A filter path that holds more ids than the matcher's window (16 by
    default) is spilled to the host: a publish on it resolves by the
    overflow route, in both packages alike, with the same frames; at a
    window of 63 the 40 holders of each path resolve on the device."""

    async def script(b: Broker) -> None:
        for k in range(40):
            await b.connect(f"h{k}", 4)
            await b.send(f"h{k}", subscribe_frame(1, [("e/#" if k % 2 else "e/+", 0, 0)], 4))
        await b.connect("p", 4)
        b.fold()
        await b.send("p", *(publish_frame("e/x", b"m%d" % i) for i in range(4)))

    got = run_both(script, allow, matcher_opts={"max_levels": 4, "background": False, "window": window})
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    assert all(len(tout[f"h{k}"][0]) > 4 * 9 for k in range(40))  # every holder got the 4 publishes
    overflows = [b.srv.matcher.stats.as_dict()["overflows"] for b in (jb, tb)]
    assert overflows[0] == overflows[1] == (4 if window == 16 else 0)


def test_a_failed_kernel_build_raises_from_the_constructor(monkeypatch):
    """On a card, ``Server(...)`` builds and loads every kernel library
    before it makes the device matcher, so a build that fails raises
    ``KernelError`` from the constructor and never becomes a guarded batch
    timing out on the breaker's watchdog. Here the card is pretended
    (``resolve_device``) and the build fails for real: this machine has
    no ``nvcc``."""
    import shutil

    from mqtt_tpu_torch import KernelError
    from mqtt_tpu_torch.ops import flat, kernels
    from mqtt_tpu_torch.server import Options, Server

    if shutil.which("nvcc") or kernels._libs:
        pytest.skip("nvcc is present here: the build would not fail")
    built = []
    monkeypatch.setattr(flat, "resolve_device", lambda device: built.append(device) or torch.device("cuda"))
    with pytest.raises(KernelError, match="nvcc"):
        Server(Options(device_matcher=True, predicate_filters=False, device="cuda"))
    assert built == ["cuda"]
