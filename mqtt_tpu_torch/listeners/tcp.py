"""Plain/TLS TCP listener.

A copy of the JAX package's (reference ``listeners/tcp.go:16-109``): bind on init,
accept loop dispatching each connection to the establish function, close
idempotently.
"""

from __future__ import annotations

import asyncio
import logging
import socket

from . import StreamListener, bind_stream_socket, split_host_port


class TCP(StreamListener):
    """A TCP listener, optionally TLS-wrapped (tcp.go:19-27)."""

    def protocol(self) -> str:
        return "tcp"

    def _fabric_bind(self) -> list:
        host, port = split_host_port(self.config.address)
        if self._fabric_reuseport and hasattr(socket, "SO_REUSEPORT"):
            # one SO_REUSEPORT socket per shard: the kernel load-balances
            # accepts, each shard accepts on its own loop. The first bind
            # resolves an ephemeral port for the rest to join.
            first = bind_stream_socket(host, port, reuse_port=True)
            bound = first.getsockname()[1]
            socks = [first]
            try:
                for _ in range(1, self._fabric.n_shards):
                    socks.append(
                        bind_stream_socket(host, bound, reuse_port=True)
                    )
            except OSError:
                for s in socks:
                    s.close()
                raise
            return socks
        self._fabric_reuseport = False  # hand-off accept
        return [
            bind_stream_socket(
                host, port, reuse_port=bool(self.config.reuse_port)
            )
        ]

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        if self._fabric is not None:
            self._lsocks = self._fabric_bind()
            return
        host, port = split_host_port(self.config.address)
        self._server = await asyncio.start_server(
            self._on_connection,
            host,
            port,
            ssl=self.config.tls_config,
            reuse_port=self.config.reuse_port or None,
        )
