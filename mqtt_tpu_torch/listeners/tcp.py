"""Plain/TLS TCP listener.

A copy of the JAX package's (reference ``listeners/tcp.go:16-109``): bind on init,
accept loop dispatching each connection to the establish function, close
idempotently.
"""

from __future__ import annotations

import asyncio
import logging

from . import StreamListener, split_host_port


class TCP(StreamListener):
    """A TCP listener, optionally TLS-wrapped (tcp.go:19-27)."""

    def protocol(self) -> str:
        return "tcp"

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        host, port = split_host_port(self.config.address)
        self._server = await asyncio.start_server(
            self._on_connection,
            host,
            port,
            ssl=self.config.tls_config,
            reuse_port=self.config.reuse_port or None,
        )
