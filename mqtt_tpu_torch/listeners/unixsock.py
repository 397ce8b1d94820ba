"""Unix-domain socket listener.

A copy of the JAX package's (reference ``listeners/unixsock.go:19-102``):
removes a stale socket file before binding.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
from typing import Callable

from . import StreamListener


class UnixSock(StreamListener):
    def protocol(self) -> str:
        return "unix"

    def address(self) -> str:
        return self.config.address

    def _fabric_bind(self) -> list:
        # hand-off only: SO_REUSEPORT has no unix-socket meaning
        self._fabric_reuseport = False
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(self.config.address)
            sock.listen(1024)
            sock.setblocking(False)
        except OSError:
            sock.close()
            raise
        return [sock]

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        try:
            # brokerlint: ok=R11 one-time stale-socket removal during init, before the listener accepts (unixsock.go:58)
            os.unlink(self.config.address)
        except FileNotFoundError:
            pass
        if self._fabric is not None:
            self._lsocks = self._fabric_bind()
            return
        self._server = await asyncio.start_unix_server(
            self._on_connection, path=self.config.address
        )

    async def close(self, close_clients: Callable[[str], None]) -> None:
        await super().close(close_clients)
        try:
            # brokerlint: ok=R11 teardown-path unlink after clients are closed; the listener no longer serves
            os.unlink(self.config.address)
        except OSError:
            pass
