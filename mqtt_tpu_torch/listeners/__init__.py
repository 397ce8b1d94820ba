"""Network listeners: the listener interface, the id-keyed registry, and the
built-in listener types (TCP, websocket, unix socket, a pre-bound socket,
the mock, and the HTTP healthcheck, stats and dashboard listeners).

A copy of the JAX package's ``listeners`` (reference
``listeners/listeners.go``: interface :32-39, registry :42-135). Accept
loops are asyncio servers; the registry tracks all per-client tasks (the
reference's ``ClientsWg``) so close can wait for them. Under the
event-loop shard fabric (``shards``) a stream listener binds raw sockets
and hands each accepted one to a shard's loop.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import ssl
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

# An EstablishFn is called for every new connection: (listener_id, reader,
# writer) -> awaitable (reference listeners.go:25).
EstablishFn = Callable[[str, asyncio.StreamReader, asyncio.StreamWriter], Awaitable]

TYPE_TCP = "tcp"
TYPE_WS = "ws"
TYPE_UNIX = "unix"
TYPE_HEALTHCHECK = "healthcheck"
TYPE_SYSINFO = "sysinfo"
TYPE_MOCK = "mock"


@dataclass
class Config:
    """Listener instantiation config (listeners.go:16-22).

    ``reuse_port`` enables SO_REUSEPORT binding so several broker
    processes share one address with kernel load-balancing.

    ``admission=False`` exempts the listener from the overload
    governor's CONNECT admission (``Server._connect_admission``)."""

    type: str = ""
    id: str = ""
    address: str = ""
    tls_config: Optional[ssl.SSLContext] = None
    reuse_port: bool = False
    admission: bool = True


class Listener:
    """A network interface accepting client connections (listeners.go:32-39)."""

    def __init__(self, config: Config) -> None:
        self.config = config
        self.log = logging.getLogger("mqtt_tpu_torch.listener")

    def id(self) -> str:
        return self.config.id

    def address(self) -> str:
        return self.config.address

    def protocol(self) -> str:
        raise NotImplementedError

    async def init(self, log: logging.Logger) -> None:
        """Bind/prepare the listener; raise on failure."""
        self.log = log

    async def serve(self, establish: EstablishFn) -> None:
        """Begin accepting connections, dispatching each to ``establish``."""
        raise NotImplementedError

    async def close(self, close_clients: Callable[[str], None]) -> None:
        """Stop accepting and run ``close_clients(listener_id)``."""
        close_clients(self.id())


def split_host_port(address: str) -> tuple[str, int]:
    """Parse host:port, handling bracketed IPv6 literals."""
    host, _, port = address.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host or "0.0.0.0", int(port or 0)


def bind_stream_socket(
    host: str, port: int, reuse_port: bool = False
) -> socket.socket:
    """A bound, listening, non-blocking TCP socket — the raw-accept
    path the event-loop shard fabric uses (shards): accepted
    connections must reach the shard's loop as bare sockets, never as
    main-loop transports that may already hold read bytes."""
    family = socket.AF_INET6 if ":" in host else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port and hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(1024)
        sock.setblocking(False)
    except OSError:
        sock.close()
        raise
    return sock


class StreamListener(Listener):
    """Shared scaffolding for stream-socket listeners: establish dispatch,
    serve arming, and the disconnect-clients-then-wait close ordering.

    With an event-loop shard fabric attached (``attach_fabric``, set by
    the server before ``init`` when ``Options.loop_shards > 1``), the
    listener binds raw sockets instead of an asyncio server: accepted
    sockets are dispatched to the least-loaded shard and wrapped into
    streams ON that shard's loop (shards). ``reuseport`` accept
    mode gives every shard its own SO_REUSEPORT-bound socket + accept
    loop instead (kernel load balancing, no hand-off hop)."""

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self._server: Optional[asyncio.base_events.Server] = None
        self._establish: Optional[EstablishFn] = None
        # event-loop shard fabric (shards.ShardFabric) or None
        self._fabric = None
        self._fabric_reuseport = False
        self._lsocks: list[socket.socket] = []
        self._accept_task: Optional[asyncio.Task] = None

    def attach_fabric(self, fabric, reuseport: bool = False) -> None:
        """Route this listener's accepts through the shard fabric; must
        be called before ``init``."""
        self._fabric = fabric
        self._fabric_reuseport = reuseport

    def _fabric_bind(self) -> list:
        """Bind the fabric-mode listening socket(s); subclasses that
        support the fabric override this. One socket = hand-off accept
        on the main loop; one socket per shard = per-shard accept."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support the shard fabric"
        )

    def address(self) -> str:
        if self._server is not None and self._server.sockets:
            name = self._server.sockets[0].getsockname()
            if isinstance(name, tuple):
                return f"{name[0]}:{name[1]}"
            return str(name)
        if self._lsocks:
            try:
                name = self._lsocks[0].getsockname()
            except OSError:
                return self.config.address
            if isinstance(name, tuple):
                return f"{name[0]}:{name[1]}"
            return str(name)
        return self.config.address

    async def _handle(self, reader, writer, establish: EstablishFn) -> None:
        """Dispatch one accepted connection; override to wrap the streams."""
        await establish(self.id(), reader, writer)

    async def _on_connection(self, reader, writer) -> None:
        establish = self._establish
        if establish is None:  # not serving yet
            writer.close()
            return
        try:
            await self._handle(reader, writer, establish)
        except Exception as e:
            self.log.debug("establish error on %s: %s", self.id(), e)
        finally:
            try:
                writer.close()
            except Exception:  # brokerlint: ok=R4 teardown; the transport is already gone
                pass

    async def serve(self, establish: EstablishFn) -> None:
        self._establish = establish
        if self._fabric is None or not self._lsocks:
            return

        async def handler(reader, writer) -> None:
            # through _handle so stream-wrapping listeners (websocket)
            # ride the fabric unchanged
            await self._handle(reader, writer, establish)

        tls = self.config.tls_config
        if self._fabric_reuseport and len(self._lsocks) > 1:
            self._fabric.serve_reuseport(self._lsocks, tls, handler)
            return
        self._accept_task = asyncio.get_running_loop().create_task(
            self._fabric_accept_loop(self._lsocks[0], tls, handler),
            name=f"mqtt-torch-accept-{self.id()}",
        )

    async def _fabric_accept_loop(self, lsock, tls, handler) -> None:
        """Hand-off accept: the main loop accepts, the fabric routes the
        bare socket to the least-loaded shard."""
        loop = asyncio.get_running_loop()
        while True:
            try:
                sock, _addr = await loop.sock_accept(lsock)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except OSError:
                return  # listener closed under us
            self._fabric.dispatch(sock, tls, handler)

    async def close(self, close_clients: Callable[[str], None]) -> None:
        # Stop accepting, then disconnect attached clients FIRST — their
        # handler tasks must end before wait_closed() can complete.
        if self._server is not None:
            self._server.close()
        if self._accept_task is not None:
            self._accept_task.cancel()
            self._accept_task = None
        for sock in self._lsocks:
            try:
                sock.close()
            except OSError:
                pass
        self._lsocks = []
        close_clients(self.id())
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
            except Exception:  # brokerlint: ok=R4 bounded-wait shutdown; a straggler handler must not wedge close
                pass
            self._server = None


class Listeners:
    """Id-keyed listener registry with serve/close-all and a global client
    task group (listeners.go:42-135)."""

    def __init__(self) -> None:
        self.internal: dict[str, Listener] = {}
        self.client_tasks: set[asyncio.Task] = set()  # the ClientsWg analog

    def add(self, val: Listener) -> None:
        self.internal[val.id()] = val

    def get(self, id_: str) -> Optional[Listener]:
        return self.internal.get(id_)

    def delete(self, id_: str) -> None:
        self.internal.pop(id_, None)

    def __len__(self) -> int:
        return len(self.internal)

    def track(self, coro) -> asyncio.Task:
        """Spawn a per-client task, tracked for close-time draining."""
        task = asyncio.get_running_loop().create_task(coro)
        self.client_tasks.add(task)
        task.add_done_callback(self.client_tasks.discard)
        return task

    async def serve_all(self, establish: EstablishFn) -> None:
        for listener in list(self.internal.values()):
            await listener.serve(establish)

    async def close_all(self, close_clients: Callable[[str], None]) -> None:
        for listener in list(self.internal.values()):
            await listener.close(close_clients)
            self.delete(listener.id())
        if self.client_tasks:
            # bounded drain, then cancel: a handler wedged on an
            # unflushable transport (a disconnected-but-stalled reader
            # holding buffered writes) must not hang shutdown — the
            # same posture as the listener's bounded wait_closed above
            tasks = list(self.client_tasks)
            done, pending = await asyncio.wait(tasks, timeout=5)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)


from .http import Dashboard, HTTPHealthCheck, HTTPStats  # noqa: E402
from .mock import MockListener  # noqa: E402
from .net import Net  # noqa: E402
from .tcp import TCP  # noqa: E402
from .unixsock import UnixSock  # noqa: E402
from .websocket import Websocket  # noqa: E402

__all__ = [
    "Config",
    "Dashboard",
    "EstablishFn",
    "HTTPHealthCheck",
    "HTTPStats",
    "Listener",
    "Listeners",
    "MockListener",
    "Net",
    "TCP",
    "TYPE_HEALTHCHECK",
    "TYPE_MOCK",
    "TYPE_SYSINFO",
    "TYPE_TCP",
    "TYPE_UNIX",
    "TYPE_WS",
    "StreamListener",
    "UnixSock",
    "Websocket",
    "bind_stream_socket",
    "split_host_port",
]
