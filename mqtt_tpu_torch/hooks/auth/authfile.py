"""YAML user-authfile loader for the CLI (reference cmd/server/auth.go).

The authfile is a map of username -> {password, acl, disallow}; disallowed
users are skipped on load (auth.go:56-59) and passwords may be stored
obfuscated (``--coded-pwd``, auth.go:60-63). The result is a Ledger with
Users only — auth/ACL rule lists stay empty (auth.go:73). A copy of the
JAX package's; ``yaml`` is imported only where an authfile is parsed."""

from __future__ import annotations

import logging

from ...utils.obfuscate import is_obfuscated, obfuscate, try_deobfuscate
from .ledger import Ledger, RString, UserRule

_log = logging.getLogger("mqtt_tpu_torch.authfile")

# Access levels in acl maps: 0 deny, 1 read-only, 2 write-only, 3 read-write
# (ledger.go:18-23). Set ``disallow: true`` to keep an entry but reject the
# user. Passwords may be obfuscated via the code-password subcommand.
AUTH_SAMPLE = """\
sample-acl-user:
    password: change-me
    acl:
        blocked/#: 0
        telemetry/#: 1
        commands/#: 2
        chat/#: 3
    disallow: true
operator:
    password: also-change-me
    acl:
        actuators/#: 3
        sensors/#: 3
device01:
    password: secret01
    acl:
        actuators/+/device01/#: 1
        sensors/+/device01/#: 2
"""


def parse_authfile(data: bytes, coded_pwd: bool = False) -> Ledger:
    """Parse authfile bytes into a users-only Ledger (auth.go:42-74)."""
    import yaml

    raw = yaml.safe_load(data) or {}
    users: dict[str, UserRule] = {}
    plain_users: list[str] = []
    for username, rule in raw.items():
        rule = rule or {}
        if rule.get("disallow"):
            continue
        pwd = str(rule.get("password", ""))
        if coded_pwd:
            if pwd and not is_obfuscated(pwd):
                plain_users.append(str(username))
            pwd = try_deobfuscate(pwd)
        users[username] = UserRule(
            username=RString(rule.get("username", username)),
            password=RString(pwd),
            acl={RString(f): int(a) for f, a in (rule.get("acl") or {}).items()},
        )
    if plain_users:
        # mixed plain/coded files are supported (plain strings pass through),
        # but a fully still-coded foreign file — e.g. one coded by the Go
        # fork's incompatible toolbox CodeString format — would silently turn
        # into literal passwords and fail every login, so note it once
        _log.warning(
            "authfile: --coded-pwd set but %d user(s) have passwords without "
            "the obfuscation marker, treated as plain text: %s (authfiles "
            "coded by the Go fork's toolbox are not compatible — re-code "
            "with the code-password subcommand)",
            len(plain_users),
            ", ".join(sorted(plain_users)[:5]),
        )
    return Ledger(users=users, auth=[], acl=[])


def from_authfile(path: str, coded_pwd: bool = False) -> Ledger:
    if not path:
        raise ValueError("filename is empty")
    with open(path, "rb") as f:
        return parse_authfile(f.read(), coded_pwd)


def init_authfile(path: str) -> None:
    """Write the sample authfile (auth.go:76-78)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(AUTH_SAMPLE)


__all__ = ["AUTH_SAMPLE", "from_authfile", "init_authfile", "obfuscate", "parse_authfile"]
