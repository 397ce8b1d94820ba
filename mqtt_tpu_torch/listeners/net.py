"""Listener over an externally created, already-bound socket.

A copy of the JAX package's (reference ``listeners/net.go:16-92``, which
wraps a pre-made net.Listener).
"""

from __future__ import annotations

import asyncio
import logging
import socket

from . import Config, StreamListener


class Net(StreamListener):
    def __init__(self, id_: str, sock: socket.socket) -> None:
        super().__init__(Config(type="net", id=id_))
        self._sock = sock

    def protocol(self) -> str:
        return "net"

    def address(self) -> str:
        try:
            host, port = self._sock.getsockname()[:2]
            return f"{host}:{port}"
        except OSError:
            return ""

    def _fabric_bind(self) -> list:
        # the caller's pre-bound socket feeds the hand-off accept loop
        self._fabric_reuseport = False
        self._sock.setblocking(False)
        return [self._sock]

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        if self._fabric is not None:
            self._lsocks = self._fabric_bind()
            return
        self._server = await asyncio.start_server(self._on_connection, sock=self._sock)
