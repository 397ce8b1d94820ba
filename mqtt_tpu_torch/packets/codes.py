"""MQTT v5 reason codes and v3 CONNACK return codes.

Behavioral parity with reference ``packets/codes.go`` (the full v5 reason-code
table, reference codes.go:31-129; the v3 translation map, codes.go:141-148).
Values are MQTT spec constants (MQTT v5.0 §2.4, §3.2.2.2).

A :class:`Code` doubles as an exception so broker paths can ``raise`` a reason
code directly and compare the caught instance against the table below.
"""

from __future__ import annotations


class Code(Exception):
    """A reason code byte paired with a human-readable reason string.

    Equality compares both fields, so two distinct codes sharing a byte value
    (e.g. ``CODE_SUCCESS`` and ``CODE_DISCONNECT``, both 0x00) are distinct —
    mirroring the reference's value-struct semantics (codes.go:8-11).
    """

    def __init__(self, code: int, reason: str = "", detail: str = "") -> None:
        super().__init__(reason)
        self.code = code
        self.reason = reason
        # Extra context (e.g. the inner decode error) carried for logs only;
        # never part of equality, so wrapped errors still classify against
        # the table (the Go reference's errors.Is(%w) contract).
        self.detail = detail

    def __call__(self, detail: str = "") -> "Code":
        """Return a fresh copy for raising, so tracebacks/context never
        attach to (and race on) the shared module-level constants."""
        return Code(self.code, self.reason, detail or self.detail)

    def wrap(self, inner: object) -> "Code":
        """Fresh copy carrying ``inner`` as detail — mirrors the reference's
        ``fmt.Errorf("%s: %w", err, ErrOuter)`` while keeping equality."""
        return Code(self.code, self.reason, str(inner))

    @property
    def is_error(self) -> bool:
        """True for codes in the error range (>= 0x80)."""
        return self.code >= 0x80

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Code)
            and self.code == other.code
            and self.reason == other.reason
        )

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash((self.code, self.reason))

    def __repr__(self) -> str:
        if self.detail:
            return f"Code(0x{self.code:02X}, {self.reason!r}, detail={self.detail!r})"
        return f"Code(0x{self.code:02X}, {self.reason!r})"

    def __str__(self) -> str:
        if self.detail:
            return f"{self.detail}: {self.reason}"
        return self.reason


CODE_SUCCESS_IGNORE = Code(0x00, "ignore packet")
CODE_SUCCESS = Code(0x00, "success")
CODE_DISCONNECT = Code(0x00, "disconnected")
CODE_GRANTED_QOS0 = Code(0x00, "granted qos 0")
CODE_GRANTED_QOS1 = Code(0x01, "granted qos 1")
CODE_GRANTED_QOS2 = Code(0x02, "granted qos 2")
CODE_DISCONNECT_WILL_MESSAGE = Code(0x04, "disconnect with will message")
CODE_NO_MATCHING_SUBSCRIBERS = Code(0x10, "no matching subscribers")
CODE_NO_SUBSCRIPTION_EXISTED = Code(0x11, "no subscription existed")
CODE_CONTINUE_AUTHENTICATION = Code(0x18, "continue authentication")
CODE_RE_AUTHENTICATE = Code(0x19, "re-authenticate")

ERR_UNSPECIFIED_ERROR = Code(0x80, "unspecified error")
ERR_MALFORMED_PACKET = Code(0x81, "malformed packet")
ERR_MALFORMED_PROTOCOL_NAME = Code(0x81, "malformed packet: protocol name")
ERR_MALFORMED_PROTOCOL_VERSION = Code(0x81, "malformed packet: protocol version")
ERR_MALFORMED_FLAGS = Code(0x81, "malformed packet: flags")
ERR_MALFORMED_KEEPALIVE = Code(0x81, "malformed packet: keepalive")
ERR_MALFORMED_PACKET_ID = Code(0x81, "malformed packet: packet identifier")
ERR_MALFORMED_TOPIC = Code(0x81, "malformed packet: topic")
ERR_MALFORMED_WILL_TOPIC = Code(0x81, "malformed packet: will topic")
ERR_MALFORMED_WILL_PAYLOAD = Code(0x81, "malformed packet: will message")
ERR_MALFORMED_USERNAME = Code(0x81, "malformed packet: username")
ERR_MALFORMED_PASSWORD = Code(0x81, "malformed packet: password")
ERR_MALFORMED_QOS = Code(0x81, "malformed packet: qos")
ERR_MALFORMED_OFFSET_UINT_OUT_OF_RANGE = Code(0x81, "malformed packet: offset uint out of range")
ERR_MALFORMED_OFFSET_BYTES_OUT_OF_RANGE = Code(0x81, "malformed packet: offset bytes out of range")
ERR_MALFORMED_OFFSET_BYTE_OUT_OF_RANGE = Code(0x81, "malformed packet: offset byte out of range")
ERR_MALFORMED_OFFSET_BOOL_OUT_OF_RANGE = Code(0x81, "malformed packet: offset boolean out of range")
ERR_MALFORMED_INVALID_UTF8 = Code(0x81, "malformed packet: invalid utf-8 string")
ERR_MALFORMED_VARIABLE_BYTE_INTEGER = Code(0x81, "malformed packet: variable byte integer out of range")
ERR_MALFORMED_BAD_PROPERTY = Code(0x81, "malformed packet: unknown property")
ERR_MALFORMED_PROPERTIES = Code(0x81, "malformed packet: properties")
ERR_MALFORMED_WILL_PROPERTIES = Code(0x81, "malformed packet: will properties")
ERR_MALFORMED_SESSION_PRESENT = Code(0x81, "malformed packet: session present")
ERR_MALFORMED_REASON_CODE = Code(0x81, "malformed packet: reason code")

ERR_PROTOCOL_VIOLATION = Code(0x82, "protocol violation")
ERR_PROTOCOL_VIOLATION_PROTOCOL_NAME = Code(0x82, "protocol violation: protocol name")
ERR_PROTOCOL_VIOLATION_PROTOCOL_VERSION = Code(0x82, "protocol violation: protocol version")
ERR_PROTOCOL_VIOLATION_RESERVED_BIT = Code(0x82, "protocol violation: reserved bit not 0")
ERR_PROTOCOL_VIOLATION_FLAG_NO_USERNAME = Code(0x82, "protocol violation: username flag set but no value")
ERR_PROTOCOL_VIOLATION_FLAG_NO_PASSWORD = Code(0x82, "protocol violation: password flag set but no value")
ERR_PROTOCOL_VIOLATION_USERNAME_NO_FLAG = Code(0x82, "protocol violation: username set but no flag")
# Reference quirk preserved: the password-no-flag reason string reads
# "username set but no flag" upstream as well (codes.go:73).
ERR_PROTOCOL_VIOLATION_PASSWORD_NO_FLAG = Code(0x82, "protocol violation: username set but no flag")
ERR_PROTOCOL_VIOLATION_PASSWORD_TOO_LONG = Code(0x82, "protocol violation: password too long")
ERR_PROTOCOL_VIOLATION_USERNAME_TOO_LONG = Code(0x82, "protocol violation: username too long")
ERR_PROTOCOL_VIOLATION_NO_PACKET_ID = Code(0x82, "protocol violation: missing packet id")
ERR_PROTOCOL_VIOLATION_SURPLUS_PACKET_ID = Code(0x82, "protocol violation: surplus packet id")
ERR_PROTOCOL_VIOLATION_QOS_OUT_OF_RANGE = Code(0x82, "protocol violation: qos out of range")
ERR_PROTOCOL_VIOLATION_SECOND_CONNECT = Code(0x82, "protocol violation: second connect packet")
ERR_PROTOCOL_VIOLATION_ZERO_NON_ZERO_EXPIRY = Code(0x82, "protocol violation: non-zero expiry")
ERR_PROTOCOL_VIOLATION_REQUIRE_FIRST_CONNECT = Code(0x82, "protocol violation: first packet must be connect")
ERR_PROTOCOL_VIOLATION_WILL_FLAG_NO_PAYLOAD = Code(0x82, "protocol violation: will flag no payload")
ERR_PROTOCOL_VIOLATION_WILL_FLAG_SURPLUS_RETAIN = Code(0x82, "protocol violation: will flag surplus retain")
ERR_PROTOCOL_VIOLATION_SURPLUS_WILDCARD = Code(0x82, "protocol violation: topic contains wildcards")
ERR_PROTOCOL_VIOLATION_SURPLUS_SUB_ID = Code(0x82, "protocol violation: contained subscription identifier")
ERR_PROTOCOL_VIOLATION_INVALID_TOPIC = Code(0x82, "protocol violation: invalid topic")
ERR_PROTOCOL_VIOLATION_INVALID_SHARED_NO_LOCAL = Code(0x82, "protocol violation: invalid shared no local")
ERR_PROTOCOL_VIOLATION_NO_FILTERS = Code(0x82, "protocol violation: must contain at least one filter")
ERR_PROTOCOL_VIOLATION_INVALID_REASON = Code(0x82, "protocol violation: invalid reason")
ERR_PROTOCOL_VIOLATION_OVERSIZE_SUB_ID = Code(0x82, "protocol violation: oversize subscription id")
ERR_PROTOCOL_VIOLATION_DUP_NO_QOS = Code(0x82, "protocol violation: dup true with no qos")
ERR_PROTOCOL_VIOLATION_UNSUPPORTED_PROPERTY = Code(0x82, "protocol violation: unsupported property")
ERR_PROTOCOL_VIOLATION_NO_TOPIC = Code(0x82, "protocol violation: no topic or alias")

ERR_IMPLEMENTATION_SPECIFIC_ERROR = Code(0x83, "implementation specific error")
ERR_REJECT_PACKET = Code(0x83, "packet rejected")
ERR_UNSUPPORTED_PROTOCOL_VERSION = Code(0x84, "unsupported protocol version")
ERR_CLIENT_IDENTIFIER_NOT_VALID = Code(0x85, "client identifier not valid")
ERR_CLIENT_IDENTIFIER_TOO_LONG = Code(0x85, "client identifier too long")
ERR_BAD_USERNAME_OR_PASSWORD = Code(0x86, "bad username or password")
ERR_NOT_AUTHORIZED = Code(0x87, "not authorized")
ERR_SERVER_UNAVAILABLE = Code(0x88, "server unavailable")
ERR_SERVER_BUSY = Code(0x89, "server busy")
ERR_BANNED = Code(0x8A, "banned")
ERR_SERVER_SHUTTING_DOWN = Code(0x8B, "server shutting down")
ERR_BAD_AUTHENTICATION_METHOD = Code(0x8C, "bad authentication method")
ERR_KEEP_ALIVE_TIMEOUT = Code(0x8D, "keep alive timeout")
ERR_SESSION_TAKEN_OVER = Code(0x8E, "session takeover")
ERR_TOPIC_FILTER_INVALID = Code(0x8F, "topic filter invalid")
ERR_TOPIC_NAME_INVALID = Code(0x90, "topic name invalid")
ERR_PACKET_IDENTIFIER_IN_USE = Code(0x91, "packet identifier in use")
ERR_PACKET_IDENTIFIER_NOT_FOUND = Code(0x92, "packet identifier not found")
ERR_RECEIVE_MAXIMUM = Code(0x93, "receive maximum exceeded")
ERR_TOPIC_ALIAS_INVALID = Code(0x94, "topic alias invalid")
ERR_PACKET_TOO_LARGE = Code(0x95, "packet too large")
ERR_MESSAGE_RATE_TOO_HIGH = Code(0x96, "message rate too high")
ERR_QUOTA_EXCEEDED = Code(0x97, "quota exceeded")
ERR_PENDING_CLIENT_WRITES_EXCEEDED = Code(0x97, "too many pending writes")
ERR_ADMINISTRATIVE_ACTION = Code(0x98, "administrative action")
ERR_PAYLOAD_FORMAT_INVALID = Code(0x99, "payload format invalid")
ERR_RETAIN_NOT_SUPPORTED = Code(0x9A, "retain not supported")
ERR_QOS_NOT_SUPPORTED = Code(0x9B, "qos not supported")
ERR_USE_ANOTHER_SERVER = Code(0x9C, "use another server")
ERR_SERVER_MOVED = Code(0x9D, "server moved")
ERR_SHARED_SUBSCRIPTIONS_NOT_SUPPORTED = Code(0x9E, "shared subscriptions not supported")
ERR_CONNECTION_RATE_EXCEEDED = Code(0x9F, "connection rate exceeded")
ERR_MAX_CONNECT_TIME = Code(0xA0, "maximum connect time")
ERR_SUBSCRIPTION_IDENTIFIERS_NOT_SUPPORTED = Code(0xA1, "subscription identifiers not supported")
ERR_WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED = Code(0xA2, "wildcard subscriptions not supported")
ERR_INLINE_SUBSCRIPTION_HANDLER_INVALID = Code(0xA3, "inline subscription handler not valid.")

# Granted-QoS reason codes indexed by QoS byte (codes.go:25-29).
QOS_CODES = {
    0: CODE_GRANTED_QOS0,
    1: CODE_GRANTED_QOS1,
    2: CODE_GRANTED_QOS2,
}

# MQTT v3.1.1 CONNACK return codes (spec §3.2.2.3 of v3.1.1).
ERR3_UNSUPPORTED_PROTOCOL_VERSION = Code(0x01)
ERR3_CLIENT_IDENTIFIER_NOT_VALID = Code(0x02)
ERR3_SERVER_UNAVAILABLE = Code(0x03)
ERR_MALFORMED_USERNAME_OR_PASSWORD = Code(0x04)
ERR3_NOT_AUTHORIZED = Code(0x05)

# v5 CONNACK reason code -> v3 CONNACK return code translation (codes.go:141-148).
V5_CODES_TO_V3 = {
    ERR_UNSUPPORTED_PROTOCOL_VERSION: ERR3_UNSUPPORTED_PROTOCOL_VERSION,
    ERR_CLIENT_IDENTIFIER_NOT_VALID: ERR3_CLIENT_IDENTIFIER_NOT_VALID,
    ERR_SERVER_UNAVAILABLE: ERR3_SERVER_UNAVAILABLE,
    ERR_MALFORMED_USERNAME: ERR_MALFORMED_USERNAME_OR_PASSWORD,
    ERR_MALFORMED_PASSWORD: ERR_MALFORMED_USERNAME_OR_PASSWORD,
    ERR_BAD_USERNAME_OR_PASSWORD: ERR3_NOT_AUTHORIZED,
}
