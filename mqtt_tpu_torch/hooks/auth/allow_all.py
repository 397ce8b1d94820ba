"""Allow-all auth hook: permits every connection and ACL check.

A copy of the JAX package's, after the reference's ``hooks/auth/allow_all.go:16-42``.
"""

from __future__ import annotations

from .. import ON_ACL_CHECK, ON_CONNECT_AUTHENTICATE, Hook


class AllowHook(Hook):
    """Allows all connections and all topic reads/writes."""

    def id(self) -> str:
        return "allow-all-auth"

    def provides(self, b: int) -> bool:
        return b in (ON_CONNECT_AUTHENTICATE, ON_ACL_CHECK)

    def on_connect_authenticate(self, cl, pk) -> bool:
        return True

    def on_acl_check(self, cl, topic: str, write: bool) -> bool:
        return True
