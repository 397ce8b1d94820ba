"""The port's listeners (``mqtt_tpu_torch.listeners``) held against the JAX
package's on the CPU: the registry, ``split_host_port``,
``bind_stream_socket``, the TCP, unix-socket, pre-bound-socket and mock
listeners through their lifecycle, the server's listener construction from
configs, and one broker session through each stream listener, whose bytes
must equal the JAX server's. Every wait carries its own limit.
"""

import asyncio
import os
import socket
import time

import pytest

import chip_smoke as cs
from test_torch_server import LIMIT, NOW, Broker, allow, options, package


@pytest.fixture
def pinned_clock(monkeypatch):
    """Wall-clock time pinned: the message-expiry rewrite reads it."""
    monkeypatch.setattr(time, "time", lambda: NOW)


@pytest.mark.parametrize(
    "address",
    ["127.0.0.1:1883", ":1883", "[::1]:8883", "localhost:", "0.0.0.0:0", "host.example:65535"],
)
def test_split_host_port_equals_the_jax_package(address):
    assert package("torch").listeners.split_host_port(address) == package("jax").listeners.split_host_port(address)


def test_bind_stream_socket_listens():
    sock = package("torch").listeners.bind_stream_socket("127.0.0.1", 0)
    try:
        assert sock.getsockname()[1] > 0 and not sock.getblocking()
        c = socket.create_connection(sock.getsockname(), timeout=LIMIT)
        c.close()
    finally:
        sock.close()


def test_registry_and_mock_lifecycle_equal_the_jax_package():
    got = []
    for name in ("jax", "torch"):
        L = package(name).listeners
        reg = L.Listeners()
        a, b = L.MockListener("a", "addr-a"), L.MockListener("b", "addr-b")
        reg.add(a)
        reg.add(b)
        closed = []

        async def main():
            for lst in reg.internal.values():
                await lst.init(None)
            await reg.serve_all(lambda *args: None)
            flags = [(x.is_listening, x.is_serving) for x in (a, b)]
            await reg.close_all(closed.append)
            return flags

        flags = asyncio.run(main())
        failing = L.MockListener("c", "")
        failing.err_listen = OSError("bind")
        with pytest.raises(OSError):
            asyncio.run(failing.init(None))
        got.append((len(reg), flags, [(x.is_listening, x.is_serving) for x in (a, b)], closed,
                    a.id(), a.address(), a.protocol(), failing.is_listening))
    assert got[0] == got[1]
    assert got[1][1] == [(True, True)] * 2 and got[1][3] == ["a", "b"]


@pytest.mark.parametrize("kind", ["tcp", "mock", "unix", "ws", "healthcheck", "sysinfo", "bogus"])
def test_listener_from_config(kind, tmp_path):
    """The port builds every listener type as the JAX server does (the
    stats listener wired to the server's ``health_report``), and treats an
    unknown type as the JAX server does (logged, None)."""
    pkg = package("torch")
    L = pkg.listeners
    srv = pkg.server.Server(options(pkg, device_matcher=False, predicate_filters=False))
    address = str(tmp_path / "s.sock") if kind == "unix" else "127.0.0.1:0"
    got = srv._listener_from_config(L.Config(type=kind.upper(), id=kind, address=address))
    want = {"tcp": L.TCP, "mock": L.MockListener, "unix": L.UnixSock, "ws": L.Websocket,
            "healthcheck": L.HTTPHealthCheck, "sysinfo": L.HTTPStats}.get(kind)
    if want is None:
        assert got is None
    else:
        assert type(got) is want and got.id() == kind
    if kind == "sysinfo":
        assert got.health == srv.health_report and got.telemetry is None
    jpkg = package("jax")
    jsrv = jpkg.server.Server(options(jpkg, device_matcher=False, predicate_filters=False))
    jgot = jsrv._listener_from_config(jpkg.listeners.Config(type=kind, id=kind, address=address))
    assert type(jgot).__name__ == type(got).__name__
    srv.add_listeners_from_config([pkg.listeners.Config(type="mock", id="m", address="")])
    with pytest.raises(pkg.server.ListenerIDExistsError):
        srv.add_listener(pkg.listeners.MockListener("m", ""))


async def _session(b: Broker, open_conn) -> None:
    """A publisher and a subscriber through the listener ``open_conn``
    reaches: CONNECT, SUBSCRIBE, a fold, QoS 0 and 1 publishes, a PUBACK."""
    for name, version in (("sub", 5), ("pub", 4)):
        c = b.clients[name] = cs.WireClient(name, version)
        await open_conn(c)
        c.send(cs.connect_frame(name, version))
        await c.wait_frames(1, LIMIT)
    await b.send("sub", cs.subscribe_frame(1, [("s/+", 1, 0)], 5))
    b.fold()
    await b.send("pub", cs.publish_frame("s/a", b"zero"), cs.publish_frame("s/b", b"one", 1, 1))
    await b.send("sub", cs.ack_frame(cs.PUBACK, 1))


def _unix_open(path):
    async def open_conn(c):
        reader, c.writer = await asyncio.open_unix_connection(path)
        buf = bytearray()
        c.conns.append(buf)
        c.task = asyncio.get_running_loop().create_task(c._read(reader, buf))

    return open_conn


@pytest.mark.parametrize("kind", ["unix", "net"])
def test_stream_listener_sessions_equal_the_jax_server(kind, tmp_path, pinned_clock):
    outs = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        L = pkg.listeners

        async def main():
            b = Broker(pkg, hooks=allow(pkg))
            if kind == "unix":
                path = str(tmp_path / f"{name}.sock")
                open(path, "w").close()  # a stale file the listener removes
                b.srv.add_listener(L.UnixSock(L.Config(type="unix", id="u", address=path)))
                open_conn = _unix_open(path)
            else:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.bind(("127.0.0.1", 0))
                sock.listen(16)
                b.srv.add_listener(L.Net("n", sock))
                host, port = sock.getsockname()

                async def open_conn(c):
                    await c.open(host, port)

            await b.start()
            lst = b.srv.listeners.get("u" if kind == "unix" else "n")
            assert lst.protocol() == kind and lst.address()
            await _session(b, open_conn)
            out = await b.close()
            if kind == "unix":
                assert not os.path.exists(path)  # unlinked on close
            return out

        outs[name] = asyncio.run(main())
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]["sub"][0]) > 20


def test_mock_listener_establishes_a_session_like_the_jax_server(pinned_clock):
    """``MockListener.establish`` (what ``serve`` hands it) attaches a
    connection over a fed ``StreamReader`` and an in-memory writer."""
    outs = []
    for name in ("jax", "torch"):
        pkg = package(name)

        async def main():
            srv = pkg.server.Server(options(pkg))
            srv.add_hook(pkg.auth.AllowHook())
            lst = pkg.listeners.MockListener("m", "mock-addr")
            srv.add_listener(lst)
            await srv.serve()
            assert lst.is_serving
            reader = asyncio.StreamReader()
            reader.feed_data(cs.connect_frame("mc", 5) + cs.subscribe_frame(1, [("x/#", 0, 0)], 5)
                             + b"\xc0\x00" + cs.disconnect_frame(5))
            reader.feed_eof()
            w = cs.MemWriter()
            w.close = lambda: None
            w.drain = lambda: asyncio.sleep(0)
            # its own task, as an accept would run it: the registry drains
            # the connection tasks at close
            await asyncio.wait_for(asyncio.ensure_future(lst.establish("m", reader, w)), LIMIT)
            await srv.close()
            return bytes(w.data)

        outs.append(asyncio.run(main()))
    assert outs[0] == outs[1] and len(outs[1]) > 10
