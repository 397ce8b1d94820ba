"""Rule-based auth/ACL ledger.

A copy of the JAX package's, after the reference's ``hooks/auth/ledger.go``: access levels
:18-23, the ``*``-prefix rule matcher :68-80, the independent split-based
topic matcher ``MatchTopic`` :90-117 (distinct semantics from the trie walk
— no parent-level ``#`` match, no ``$``-exclusion), user-first-then-rules
auth :137-161, and user -> ACL rules -> auth-fallback ACL checks :164-224.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Optional

# Access levels for an ACL rule (ledger.go:18-23).
ACCESS_DENY = 0  # user cannot access the topic
ACCESS_READ_ONLY = 1  # user can only subscribe
ACCESS_WRITE_ONLY = 2  # user can only publish
ACCESS_READ_WRITE = 3  # user can publish and subscribe


class RString(str):
    """A rule value string; empty or ``*`` match anything, a trailing ``*``
    prefix-matches (ledger.go:68-80)."""

    def matches(self, a: str) -> bool:
        r = str(self)
        if r == "" or r == "*" or a == r:
            return True
        i = r.find("*")
        return i > 0 and len(a) > i and r[:i] == a[:i]

    def filter_matches(self, a: str) -> bool:
        _, ok = match_topic(str(self), a)
        return ok


def match_topic(filter: str, topic: str) -> tuple[list[str], bool]:
    """The ledger's own filter-vs-topic matcher (ledger.go:90-117). Returns
    the wildcard-captured elements and whether the topic matched. NOTE: by
    design this matcher differs from the trie walk — ``a/b/#`` does NOT
    match ``a/b`` here."""
    filter_parts = filter.split("/")
    topic_parts = topic.split("/")
    elements: list[str] = []
    for i, fp in enumerate(filter_parts):
        if i >= len(topic_parts):
            return elements, False
        if fp == "+":
            elements.append(topic_parts[i])
            continue
        if fp == "#":
            elements.append("/".join(topic_parts[i:]))
            return elements, True
        if fp != topic_parts[i]:
            return elements, False
    return elements, len(filter_parts) == len(topic_parts)


# Filters maps filter -> access level (ledger.go:62).
Filters = dict


@dataclass
class UserRule:
    """Access rules for one named user (ledger.go:32-37)."""

    username: RString = RString("")
    password: RString = RString("")
    acl: dict = field(default_factory=dict)  # RString filter -> Access
    disallow: bool = False


@dataclass
class AuthRule:
    """A generic authentication rule (ledger.go:41-48)."""

    client: RString = RString("")
    username: RString = RString("")
    remote: RString = RString("")
    password: RString = RString("")
    allow: bool = False


@dataclass
class ACLRule:
    """A generic topic-access rule (ledger.go:53-59)."""

    client: RString = RString("")
    username: RString = RString("")
    remote: RString = RString("")
    filters: dict = field(default_factory=dict)  # RString filter -> Access


class Ledger:
    """An auth ledger of user, auth, and ACL rules (ledger.go:121-127)."""

    def __init__(
        self,
        users: Optional[dict[str, UserRule]] = None,
        auth: Optional[list[AuthRule]] = None,
        acl: Optional[list[ACLRule]] = None,
    ) -> None:
        self._lock = threading.Lock()
        self.users = users
        self.auth = auth if auth is not None else []
        self.acl = acl if acl is not None else []

    def update(self, ln: "Ledger") -> None:
        with self._lock:
            self.auth = ln.auth
            self.acl = ln.acl

    def auth_ok(self, cl, pk) -> tuple[int, bool]:
        """True when a user entry or auth rule permits the connection
        (ledger.go:137-161)."""
        username = (
            cl.properties.username.decode("utf-8", "replace")
            if isinstance(cl.properties.username, (bytes, bytearray))
            else str(cl.properties.username)
        )
        password = (
            pk.connect.password.decode("utf-8", "replace")
            if isinstance(pk.connect.password, (bytes, bytearray))
            else str(pk.connect.password)
        )
        if self.users is not None:
            u = self.users.get(username)
            if u is not None and u.password != "" and str(u.password) == password:
                return 0, not u.disallow
        for n, rule in enumerate(self.auth):
            if (
                rule.client.matches(cl.id)
                and rule.username.matches(username)
                and rule.password.matches(password)
                and rule.remote.matches(cl.net.remote)
            ):
                return n, rule.allow
        return 0, False

    def acl_ok(self, cl, topic: str, write: bool) -> tuple[int, bool]:
        """True when the user/rules allow reading (subscribe) or writing
        (publish) the topic; first matching filter decides
        (ledger.go:164-224)."""
        username = (
            cl.properties.username.decode("utf-8", "replace")
            if isinstance(cl.properties.username, (bytes, bytearray))
            else str(cl.properties.username)
        )
        if self.users is not None:
            u = self.users.get(username)
            if u is not None:
                if not u.acl:
                    return 0, True
                for filter_, access in u.acl.items():
                    if not write and topic == "#":
                        return 0, True
                    if RString(filter_).filter_matches(topic):
                        if not write and access in (ACCESS_READ_ONLY, ACCESS_READ_WRITE):
                            return 0, True
                        if write and access in (ACCESS_WRITE_ONLY, ACCESS_READ_WRITE):
                            return 0, True
                        return 0, False
        for n, rule in enumerate(self.acl):
            if (
                rule.client.matches(cl.id)
                and rule.username.matches(username)
                and rule.remote.matches(cl.net.remote)
            ):
                if not rule.filters:
                    return n, True
                for filter_, access in rule.filters.items():
                    if not write and topic == "#":
                        return n, True
                    if RString(filter_).filter_matches(topic):
                        if not write and access in (ACCESS_READ_ONLY, ACCESS_READ_WRITE):
                            return n, True
                        if write and access in (ACCESS_WRITE_ONLY, ACCESS_READ_WRITE):
                            return n, True
                        return n, False
        # auth rules act as a fallback grant (ledger.go:212-222)
        for n, rule in enumerate(self.auth):
            if (
                rule.client.matches(cl.id)
                and rule.username.matches(username)
                and rule.remote.matches(cl.net.remote)
                and rule.allow
            ):
                return n, True
        return 0, False

    # -- (de)serialization (ledger.go:227-250) -----------------------------

    def to_dict(self) -> dict:
        def rule_dict(r):
            return {k: v for k, v in r.__dict__.items()}

        return {
            "users": {
                k: {
                    "username": str(u.username),
                    "password": str(u.password),
                    "acl": {str(f): a for f, a in u.acl.items()},
                    "disallow": u.disallow,
                }
                for k, u in (self.users or {}).items()
            },
            "auth": [rule_dict(r) for r in self.auth],
            "acl": [
                {
                    "client": str(r.client),
                    "username": str(r.username),
                    "remote": str(r.remote),
                    "filters": {str(f): a for f, a in r.filters.items()},
                }
                for r in self.acl
            ],
        }

    def to_json(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    def to_yaml(self) -> bytes:
        import yaml

        return yaml.safe_dump(self.to_dict()).encode()

    def unmarshal(self, data: bytes) -> None:
        """Load rules from JSON (leading ``{``) or YAML bytes."""
        with self._lock:
            if not data:
                return
            if data[:1] == b"{":
                raw = json.loads(data)
            else:
                import yaml

                raw = yaml.safe_load(data)
            if not raw:
                return
            users = raw.get("users") or {}
            self.users = {
                k: UserRule(
                    username=RString(u.get("username", "")),
                    password=RString(u.get("password", "")),
                    acl={RString(f): a for f, a in (u.get("acl") or {}).items()},
                    disallow=bool(u.get("disallow", False)),
                )
                for k, u in users.items()
            } or None
            self.auth = [
                AuthRule(
                    client=RString(r.get("client", "")),
                    username=RString(r.get("username", "")),
                    remote=RString(r.get("remote", "")),
                    password=RString(r.get("password", "")),
                    allow=bool(r.get("allow", False)),
                )
                for r in (raw.get("auth") or [])
            ]
            self.acl = [
                ACLRule(
                    client=RString(r.get("client", "")),
                    username=RString(r.get("username", "")),
                    remote=RString(r.get("remote", "")),
                    filters={RString(f): a for f, a in (r.get("filters") or {}).items()},
                )
                for r in (raw.get("acl") or [])
            ]
