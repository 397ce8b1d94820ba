"""The port's WebSocket and HTTP listeners (``listeners.websocket``,
``listeners.http``) and ``Server.health_report`` held against the JAX
package's on the CPU.

An MQTT session over WebSocket (``chip_smoke.WsClient``: the upgrade, and
every frame masked by hand) through each package's ``Server`` gives every
client the same bytes; the upgrade's answers, pings, close and an
oversized frame give the same bytes raw. The healthcheck, stats and
dashboard listeners answer every route with the JAX listeners' status and
body (the stats route's JSON keys; the volatile values aside), the
telemetry routes 404 in both with telemetry off, and ``health_report``
equals the JAX server's: serving, a restore in progress, a tripped
breaker, shutting down, and with the default planes on, a governor in
SHED and a breached SLO. With the planes on, ``/metrics``, ``/devices``,
``/profile``, ``/traces`` and ``/cluster/slo`` answer as the JAX
listener's: the same status, the same metric families and label sets, the
same JSON keys, and each body passes its package's checker.
"""

import asyncio
import base64
import json
import struct

import pytest

import chip_smoke as cs
from chip_smoke import WsClient, connect_frame, disconnect_frame, publish_frame, subscribe_frame

from mqtt_tpu_torch import profiling as tprf
from mqtt_tpu_torch import telemetry as ttel
from mqtt_tpu_torch import tracing as ttrc

from test_torch_server import (  # noqa: F401 (fixture)
    LIMIT, _DEPARTED_FAMILIES, Broker, _families, allow, package, pinned_clock)


def with_ws(b: Broker):
    """Add a websocket listener to a broker before it starts."""
    L = b.pkg.listeners
    b.srv.add_listener(L.Websocket(L.Config(type="ws", id="ws", address="127.0.0.1:0")))


async def ws_addr(b: Broker):
    host, port = b.srv.listeners.get("ws").address().rsplit(":", 1)
    return host, int(port)


def ws_session(name: str, batch: bool) -> dict:
    """v4 and v5 clients over WebSocket beside a TCP one through one
    package's broker: SUBSCRIBE, a fold onto the device matcher, QoS 0 and
    1 publishes both ways, a PUBACK, large payloads (a 16-bit and a 64-bit
    frame length), DISCONNECT; every client's bytes."""
    pkg = package(name)

    async def main():
        b = Broker(pkg, hooks=allow(pkg), fanout_batch=batch)
        with_ws(b)
        await b.start()
        host, port = await ws_addr(b)
        clients = {"ws4": WsClient("ws4", 4), "ws5": WsClient("ws5", 5)}
        for c in clients.values():
            await c.open(host, port)
            c.send(connect_frame(c.name, c.version))
            await c.wait_frames(1, LIMIT)
        await b.connect("tcp", 4)
        clients["ws4"].send(subscribe_frame(1, [("a/+", 1, 0)], 4))
        clients["ws5"].send(subscribe_frame(1, [("a/#", 0, 0), ("big/#", 1, 0)], 5))
        for c in clients.values():
            await c.wait_frames(2, LIMIT)
        b.fold()
        await b.send("tcp", publish_frame("a/b", b"from-tcp", 1, 1), publish_frame("a/c", b"q0"))
        clients["ws5"].send(publish_frame("a/d", b"from-ws", 1, 7, version=5))
        clients["ws4"].send(publish_frame("big/x", b"B" * 300, 1, 2) + publish_frame("big/y", b"C" * 70000))
        await clients["ws4"].wait_frames(2 + 3 + 1, 5.0 if name == "jax" and batch else LIMIT)
        await clients["ws5"].wait_frames(2 + 5 + 1, 5.0 if name == "jax" and batch else LIMIT)
        clients["ws4"].send(cs.ack_frame(cs.PUBACK, 1))
        await b.settle()
        for c in clients.values():
            c.send(disconnect_frame(c.version))
            await c.ended(LIMIT)
        out = await b.close()
        out.update({n: [bytes(x) for x in c.conns] for n, c in clients.items()})
        return out

    return asyncio.run(main())


@pytest.mark.parametrize("batch", [False, True], ids=["per-subscriber", "batched"])
def test_mqtt_over_websocket_equals_the_jax_server(pinned_clock, batch):
    """The websocket session (``ws_session``): with the per-subscriber
    fan-out every client's bytes equal the JAX server's. With the batched
    fan-out (``fanout_batch``, the default) the port delivers those same
    bytes, where the JAX server skips every websocket subscriber (its
    websocket writer lacks the ``transport`` the batched path reads,
    pinned here): a fault of the JAX package that the port does not keep
    (ROADMAP Queue C)."""
    want = ws_session("jax", False)
    got = ws_session("torch", batch)
    assert got == want
    pubs = [cs.parse_publish(f, 5) for f in cs.split_frames(got["ws5"][0]) if f[0] >> 4 == 3]
    assert [p["payload"][:8] for p in pubs] == [b"from-tcp", b"q0", b"from-ws", b"B" * 8, b"C" * 8]
    if batch:
        with pytest.raises(cs.PhaseFailed, match="ws4: 3 of 6 frames"):
            ws_session("jax", True)


async def _raw(host, port, data: bytes, read_for: float = 0.5) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(data)
    await writer.drain()
    out = b""
    try:
        while True:
            chunk = await asyncio.wait_for(reader.read(65536), read_for)
            if not chunk:
                break
            out += chunk
    except asyncio.TimeoutError:
        pass
    writer.close()
    return out


UPGRADE = (b"GET /mqtt HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
           b"Sec-WebSocket-Key: " + cs.WS_KEY.encode() + b"\r\n")


def _masked(op: int, payload: bytes, declared: int = -1) -> bytes:
    n = len(payload) if declared < 0 else declared
    mask = b"\x01\x02\x03\x04"
    head = bytes([0x80 | op]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 127]) + struct.pack("!Q", n))
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


WS_CASES = {
    "subprotocol": UPGRADE + b"Sec-WebSocket-Protocol: mqtt, other\r\n\r\n",
    "no-subprotocol": UPGRADE + b"\r\n",
    "not-an-upgrade": b"GET /mqtt HTTP/1.1\r\nHost: x\r\n\r\n",
    "ping-then-close": UPGRADE + b"\r\n" + _masked(0x9, b"hi") + _masked(0x8, b""),
    "oversized": UPGRADE + b"\r\n" + _masked(0x2, b"", declared=(1 << 20) + 1),
}


@pytest.mark.parametrize("case", list(WS_CASES))
def test_websocket_framing_equals_the_jax_listener(case):
    """The upgrade's answer (101 with the accept key and the ``mqtt``
    subprotocol when asked, 400 without an upgrade), a ping's pong, and the
    1009 close of a frame past ``MAX_FRAME``: the same bytes."""
    got = []
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            b = Broker(pkg, hooks=allow(pkg), device_matcher=False)
            with_ws(b)
            await b.start()
            out = await _raw(*(await ws_addr(b)), WS_CASES[case])
            await b.close()
            return out

        got.append(asyncio.run(main()))
    assert got[1] == got[0]
    if case == "subprotocol":
        assert b"Sec-WebSocket-Accept: " + cs.WS_ACCEPT in got[1] and b"Sec-WebSocket-Protocol: mqtt" in got[1]
    if case == "not-an-upgrade":
        assert got[1].startswith(b"HTTP/1.1 400")
    if case == "ping-then-close":
        assert got[1].endswith(b"\x8a\x02hi\x88\x00")  # the pong, then the close as the connection ends
    if case == "oversized":
        assert got[1].endswith(b"\x88\x02\x03\xf1\x88\x00")  # 1009: message too big


async def _get(host, port, path, method="GET", auth=None) -> tuple:
    hdr = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    if auth is not None:
        hdr += "Authorization: Basic " + base64.b64encode(auth.encode()).decode() + "\r\n"
    raw = await _raw(host, int(port), (hdr + "\r\n").encode(), read_for=2.0)
    head, _, body = raw.partition(b"\r\n\r\n")
    return head.split(b"\r\n", 1)[0].decode(), body


ROUTES = [("GET", "/healthcheck"), ("POST", "/healthcheck"), ("GET", "/nope"), ("GET", "/"), ("POST", "/"),
          ("GET", "/healthz"), ("POST", "/healthz"), ("GET", "/metrics"), ("GET", "/traces"),
          ("GET", "/profile"), ("GET", "/devices"), ("GET", "/metrics/cluster"), ("GET", "/cluster/slo")]


def test_http_listeners_answer_as_the_jax_listeners():
    """Every route of the healthcheck and stats listeners (built from the
    server's listener configs, as a config file builds them): the same
    status lines; the stats JSON's keys and its version; ``/healthz``'s
    body; the telemetry routes 404 in both (the planes off in both)."""
    got = []
    for name in ("jax", "torch"):
        pkg = package(name)
        L = pkg.listeners

        async def main():
            b = Broker(pkg, hooks=allow(pkg), device_matcher=False, predicate_filters=False)
            b.srv.add_listeners_from_config([L.Config(type="healthcheck", id="hc", address="127.0.0.1:0"),
                                             L.Config(type="sysinfo", id="st", address="127.0.0.1:0")])
            await b.start()
            out = []
            for method, path in ROUTES:
                lid = "hc" if path == "/healthcheck" or path == "/nope" else "st"
                host, port = b.srv.listeners.get(lid).address().rsplit(":", 1)
                status, body = await _get(host, port, path, method)
                if path == "/" and status.startswith("HTTP/1.1 200"):
                    info = json.loads(body)
                    body = (sorted(info), info["version"])
                elif path == "/healthz" and status.startswith("HTTP/1.1 200"):
                    body = json.loads(body)
                out.append((method, path, status, body))
            await b.close()
            return out

        got.append(asyncio.run(main()))
    assert got[1] == got[0]
    by = {(m, p): (s, body) for m, p, s, body in got[1]}
    assert by[("GET", "/healthcheck")][0] == "HTTP/1.1 200 OK"
    assert by[("POST", "/healthz")][0] == "HTTP/1.1 405 Method Not Allowed"
    assert by[("GET", "/metrics")][0] == "HTTP/1.1 404 Not Found"
    assert by[("GET", "/healthz")][1]["ok"] is True


@pytest.mark.parametrize("state", ["serving", "recovering", "breaker-open", "closed"])
def test_health_report_equals_the_jax_server(state):
    """``health_report`` on the planes both packages have (the JAX
    server's governor, cluster, SLO and device planes off): while serving
    with the device matcher and its breaker, while a restore is in
    progress, with a tripped breaker (degraded, still ready), and after
    close (draining)."""
    got = []
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            b = Broker(pkg, hooks=allow(pkg), matcher_resilience=True,
                       breaker_failure_threshold=1, breaker_probe_backoff_ms=60000.0,
                       breaker_probe_backoff_max_ms=120000.0)
            await b.start()
            srv = b.srv
            if state == "recovering":
                srv._durable.update(recovering=True, replayed_keys=12, recovery_seconds=1.25)
            if state == "breaker-open":
                srv.matcher.breaker.record_failure("error")
            if state == "closed":
                await b.close()
                return srv.health_report()
            report = srv.health_report()
            await b.close()
            return report

        got.append(asyncio.run(main()))
    assert got[1] == got[0]
    ok, body = got[1]
    assert ok == (state in ("serving", "breaker-open"))
    if state == "breaker-open":
        assert body["degraded"] == ["matcher_breaker_open"]
    if state == "recovering":
        assert body["not_ready"] == ["recovering"] and body["durable"]["recovery_seconds"] == 1.25
    if state == "closed":
        assert "draining" in body["not_ready"]


def _dashboard(pkg, b: Broker, auth):
    L = pkg.listeners
    return L.Dashboard(L.Config(type="dashboard", id="d1", address="127.0.0.1:0"), b.srv.info, b.srv.clients,
                       auth=auth, listener_summary="mqtt: test")


@pytest.mark.parametrize("auth", [{"admin": "pw"}, {"admin": ""}], ids=["basic-auth", "empty-password"])
def test_dashboard_answers_as_the_jax_dashboard(auth):
    """The dashboard's routes under basic auth: 401 without credentials, a
    wrong password, an unknown user with an empty password or none at all;
    with them, the same routes' status and shapes (a connected client
    listed); an empty configured password never authorizes."""
    got = []
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            b = Broker(pkg, hooks=allow(pkg), device_matcher=False, predicate_filters=False)
            await b.start()
            await b.connect("dash-cl", 4)
            d = _dashboard(pkg, b, auth)
            await d.init(b.srv.log)
            host, port = d.address().rsplit(":", 1)
            out = []
            for path, cred in [("/information", None), ("/information", "admin:nope"), ("/information", "ghost:"),
                               ("/information", "ghost"), ("/information", "admin:"), ("/information", "admin:pw"),
                               ("/connections", "admin:pw"), ("/clientsrawdata", "admin:pw"),
                               ("/processrecords", "admin:pw"), ("/nope", "admin:pw")]:
                status, body = await _get(host, port, path, auth=cred)
                if status.endswith("200 OK"):
                    if path == "/connections":
                        body = (b"dash-cl" in body, b"mqtt: test" in body)
                    elif path == "/clientsrawdata":
                        body = [(c["id"], c["listener"], c["subscriptions"]) for c in json.loads(body)]
                    else:
                        parsed = json.loads(body)
                        body = sorted(parsed[0] if isinstance(parsed, list) else parsed)
                out.append((path, cred, status, body))
            await d.close(lambda _: None)
            await b.close()
            return out

        got.append(asyncio.run(main()))
    assert got[1] == got[0]
    statuses = [s for _p, _c, s, _b in got[1]]
    if auth["admin"]:
        assert statuses[:5] == ["HTTP/1.1 401 Unauthorized"] * 5 and statuses[5] == "HTTP/1.1 200 OK"
        assert got[1][7][3] == [("dash-cl", "t", [])] and statuses[-1] == "HTTP/1.1 404 Not Found"
    else:
        assert set(statuses) == {"HTTP/1.1 401 Unauthorized"}


TELEMETRY_ROUTES = ["/metrics", "/devices", "/profile", "/profile?format=trace", "/traces", "/cluster/slo",
                    "/metrics/cluster", "/healthz"]


def test_telemetry_routes_answer_as_the_jax_listener(tmp_path):
    """The stats listener of a server with the default planes on, after a
    few publishes (every one traced): each telemetry route's status equals
    the JAX listener's; ``/metrics`` has the same families and label sets
    (``check_exposition``), ``/devices`` the same keys for device 0,
    ``/profile`` passes ``check_collapsed`` and its trace form and
    ``/traces`` ``check_trace_events``, ``/cluster/slo`` the same
    objectives; ``/metrics/cluster`` 404 (no cluster in either)."""
    got = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        L = pkg.listeners

        async def main():
            b = Broker(pkg, hooks=allow(pkg), planes=True, trace_sample=1, telemetry_sample=1, profile_hz=200.0,
                       slo_objectives=["p99 delivery < 30s over 5m", "hbm ratio < 0.9 over 5m"],
                       telemetry_dump_dir=str(tmp_path / name))
            b.srv.add_listeners_from_config([L.Config(type="sysinfo", id="st", address="127.0.0.1:0")])
            await b.start()
            await b.connect("s", 4)
            await b.send("s", subscribe_frame(1, [("a/#", 1, 0)], 4))
            await b.connect("p", 5)
            b.fold()
            for i in range(6):
                await b.send("p", publish_frame(f"a/{i}", b"x%d" % i, i % 2, i + 1 if i % 2 else 0, version=5))
            for _ in range(300):
                if b.srv.host_profiler.samples >= 3:
                    break
                await asyncio.sleep(0.01)
            host, port = b.srv.listeners.get("st").address().rsplit(":", 1)
            out = {}
            for path in TELEMETRY_ROUTES:
                status, body = await _get(host, port, path)
                out[path] = (status, body)
            await b.close()
            return out

        got[name] = asyncio.run(main())
    j, t = got["jax"], got["torch"]
    assert {p: s for p, (s, _b) in t.items()} == {p: s for p, (s, _b) in j.items()}
    assert t["/metrics/cluster"][0] == "HTTP/1.1 404 Not Found"
    jf, tf = _families(j["/metrics"][1].decode()), _families(t["/metrics"][1].decode())
    for fam in _DEPARTED_FAMILIES:
        jf.pop(fam, None), tf.pop(fam, None)
    assert tf == jf and ttel.check_exposition(t["/metrics"][1].decode()) > 0
    jd, td = json.loads(j["/devices"][1]), json.loads(t["/devices"][1])
    assert sorted(td) == sorted(jd) and sorted(td["devices"][0]) == sorted(jd["devices"][0])
    assert td["devices"][0]["platform"] == "cpu" and td["n_devices"] == 1
    assert tprf.check_collapsed(t["/profile"][1].decode()) > 0
    assert ttrc.check_trace_events(t["/profile?format=trace"][1]) > 0
    assert ttrc.check_trace_events(t["/traces"][1]) >= 6 * 5
    assert json.loads(t["/cluster/slo"][1]).keys() == json.loads(j["/cluster/slo"][1]).keys()
    assert sorted(json.loads(t["/cluster/slo"][1])["local"]) == sorted(json.loads(j["/cluster/slo"][1])["local"])
    assert json.loads(t["/healthz"][1]) == json.loads(j["/healthz"][1])


@pytest.mark.parametrize("state", ["serving", "governor-shed", "slo-breached"])
def test_health_report_with_the_planes_equals_the_jax_server(state, tmp_path):
    """``health_report`` with the default planes on in both packages: the
    governor's and the SLO engine's entries and the per-card plane's, a
    governor forced into SHED (not ready), an SLO breached (degraded)."""
    got = []
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            b = Broker(pkg, hooks=allow(pkg), planes=True, telemetry_dump_dir=str(tmp_path / name),
                       slo_objectives=["p99 delivery < 1ms over 10s", "hbm ratio < 0.9 over 5m"])
            await b.start()
            srv = b.srv
            if state == "governor-shed":
                srv.overload.add_source("forced", lambda: 1.0)
                srv.overload.evaluate(force=True)
            if state == "slo-breached":
                for k in range(50):
                    srv.telemetry.observe_delivery(0.5, "", 0, "local")
                    srv.slo.evaluate(now=1000.0 + k)
            report = srv.health_report()
            await b.close()
            return report

        got.append(asyncio.run(main()))
    assert got[1] == got[0]
    ok, body = got[1]
    assert body["governor"]["state"] == ("shed" if state == "governor-shed" else "normal")
    assert body["slo"]["objectives"] == 2 and "devices" in body
    assert ok == (state != "governor-shed")
    if state == "governor-shed":
        assert body["not_ready"] == ["governor_shed"]
    if state == "slo-breached":
        assert body["degraded"] == ["slo_breached"] and body["slo"]["breached"] == ["p99_delivery_1ms_over_10s"]
