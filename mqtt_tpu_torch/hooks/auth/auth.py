"""The ledger-backed auth hook.

A copy of the JAX package's, after the reference's ``hooks/auth/auth.go:15-103``.
"""

from __future__ import annotations

from typing import Any, Optional

from .. import ON_ACL_CHECK, ON_CONNECT_AUTHENTICATE, Hook
from .ledger import Ledger


class AuthOptions:
    """Configuration for the auth ledger hook (auth.go:15-18)."""

    def __init__(self, data: bytes = b"", ledger: Optional[Ledger] = None) -> None:
        self.data = data
        self.ledger = ledger


class AuthHook(Hook):
    """Authenticates connections and ACL checks against an auth ledger."""

    def __init__(self) -> None:
        super().__init__()
        self.ledger: Ledger = Ledger()

    def id(self) -> str:
        return "auth-ledger"

    def provides(self, b: int) -> bool:
        return b in (ON_CONNECT_AUTHENTICATE, ON_ACL_CHECK)

    def init(self, config: Any) -> None:
        """Load the ledger from a struct or raw JSON/YAML bytes
        (auth.go:41-73)."""
        if config is not None and not isinstance(config, AuthOptions):
            raise TypeError("invalid config type provided")
        config = config or AuthOptions()
        if config.ledger is not None:
            self.ledger = config.ledger
        elif config.data:
            self.ledger = Ledger()
            self.ledger.unmarshal(config.data)
        else:
            self.ledger = Ledger()
        self.log.info(
            "loaded auth rules: authentication=%d acl=%d",
            len(self.ledger.auth),
            len(self.ledger.acl),
        )

    def on_connect_authenticate(self, cl, pk) -> bool:
        _, ok = self.ledger.auth_ok(cl, pk)
        if not ok:
            self.log.info(
                "client failed authentication check: username=%s remote=%s",
                pk.connect.username,
                cl.net.remote,
            )
        return ok

    def on_acl_check(self, cl, topic: str, write: bool) -> bool:
        _, ok = self.ledger.acl_ok(cl, topic, write)
        if not ok:
            self.log.debug(
                "client failed allowed ACL check: client=%s topic=%s", cl.id, topic
            )
        return ok
