"""Mock listener test double with serving/listening introspection.

A copy of the JAX package's, after the reference's ``listeners/mock.go:26-105``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from . import Config, EstablishFn, Listener


class MockListener(Listener):
    """A do-nothing listener exposing its lifecycle flags for tests."""

    def __init__(self, id_: str, address: str) -> None:
        super().__init__(Config(type="mock", id=id_, address=address))
        self.is_listening = False
        self.is_serving = False
        self.err_listen: Optional[Exception] = None
        self.establish: Optional[EstablishFn] = None

    def protocol(self) -> str:
        return "mock"

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        if self.err_listen is not None:
            raise self.err_listen
        self.is_listening = True

    async def serve(self, establish: EstablishFn) -> None:
        self.establish = establish
        self.is_serving = True

    async def close(self, close_clients: Callable[[str], None]) -> None:
        self.is_serving = False
        self.is_listening = False
        close_clients(self.id())
