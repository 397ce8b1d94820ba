"""Authentication hooks: allow-all and the rule-based ledger hook.

A copy of the JAX package's, after the reference's ``hooks/auth/`` (allow_all.go, auth.go,
ledger.go).
"""

from .allow_all import AllowHook
from .auth import AuthHook, AuthOptions
from .ledger import (
    ACCESS_DENY,
    ACCESS_READ_ONLY,
    ACCESS_READ_WRITE,
    ACCESS_WRITE_ONLY,
    ACLRule,
    AuthRule,
    Filters,
    Ledger,
    RString,
    UserRule,
    match_topic,
)

__all__ = [
    "ACCESS_DENY",
    "ACCESS_READ_ONLY",
    "ACCESS_READ_WRITE",
    "ACCESS_WRITE_ONLY",
    "ACLRule",
    "AllowHook",
    "AuthHook",
    "AuthOptions",
    "AuthRule",
    "Filters",
    "Ledger",
    "RString",
    "UserRule",
    "match_topic",
]
