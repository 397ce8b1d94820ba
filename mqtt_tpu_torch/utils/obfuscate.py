"""Reversible password obfuscation for auth files.

The fork CLI stores authfile passwords obfuscated (cmd/main.go:147-153
``code-password`` / cmd/server/auth.go:60-63 ``TryDeobfuscation``, from
xyzj/toolbox). This is obfuscation, not encryption — it only keeps
passwords out of casual sight in config files. Scheme: XOR with a rolling
key, base64url, and a marker prefix so plain and coded strings coexist
(``try_deobfuscate`` passes non-marked strings through unchanged, matching
the reference's VString.TryDeobfuscation behavior).

A copy of the JAX package's, key and marker included, so a password coded
by either package's ``code-password`` decodes in both.
"""

from __future__ import annotations

import base64

_MARK = "$MOB$"
_KEY = b"mqtt-tpu-authfile-obfuscation-key"


def _xor(data: bytes) -> bytes:
    return bytes(b ^ _KEY[i % len(_KEY)] ^ (i & 0xFF) for i, b in enumerate(data))


def obfuscate(plain: str) -> str:
    """Encode a password for storage in an authfile."""
    coded = base64.urlsafe_b64encode(_xor(plain.encode("utf-8"))).decode("ascii")
    return _MARK + coded.rstrip("=")


def is_obfuscated(value: str) -> bool:
    """True when ``value`` carries the obfuscation marker."""
    return value.startswith(_MARK)


def try_deobfuscate(value: str) -> str:
    """Decode an obfuscated password; plain strings pass through."""
    if not value.startswith(_MARK):
        return value
    coded = value[len(_MARK):]
    coded += "=" * (-len(coded) % 4)
    try:
        return _xor(base64.urlsafe_b64decode(coded.encode("ascii"))).decode("utf-8")
    except Exception:
        return value
