"""Primitive MQTT wire codec: big-endian ints, length-prefixed strings/bytes,
UTF-8 validation, and the variable byte integer.

Behavioral parity with reference ``packets/codec.go`` (decode offsets and the
exact malformed-* error selection, codec.go:22-172). Decoders take ``(buf,
offset)`` and return ``(value, next_offset)``, raising a
:class:`~mqtt_tpu_torch.packets.codes.Code` on malformed input.
"""

from __future__ import annotations

from .codes import (
    ERR_MALFORMED_INVALID_UTF8,
    ERR_MALFORMED_OFFSET_BOOL_OUT_OF_RANGE,
    ERR_MALFORMED_OFFSET_BYTE_OUT_OF_RANGE,
    ERR_MALFORMED_OFFSET_BYTES_OUT_OF_RANGE,
    ERR_MALFORMED_OFFSET_UINT_OUT_OF_RANGE,
    ERR_MALFORMED_VARIABLE_BYTE_INTEGER,
)

# Maximum value representable by an MQTT variable byte integer (4 bytes).
MAX_VARINT = 268_435_455


def decode_uint16(buf: bytes, offset: int) -> tuple[int, int]:
    if len(buf) < offset + 2:
        raise ERR_MALFORMED_OFFSET_UINT_OUT_OF_RANGE()
    return (buf[offset] << 8) | buf[offset + 1], offset + 2


def decode_uint32(buf: bytes, offset: int) -> tuple[int, int]:
    if len(buf) < offset + 4:
        raise ERR_MALFORMED_OFFSET_UINT_OUT_OF_RANGE()
    return int.from_bytes(buf[offset : offset + 4], "big"), offset + 4


def decode_bytes(buf: bytes, offset: int) -> tuple[bytes, int]:
    """Decode a two-byte-length-prefixed byte field (payloads, passwords)."""
    length, next_ = decode_uint16(buf, offset)
    end = next_ + length
    if end > len(buf):
        raise ERR_MALFORMED_OFFSET_BYTES_OUT_OF_RANGE()
    return bytes(buf[next_:end]), end


def decode_string(buf: bytes, offset: int) -> tuple[str, int]:
    """Decode a length-prefixed UTF-8 string [MQTT-1.5.4-1] [MQTT-3.1.3-5]."""
    b, next_ = decode_bytes(buf, offset)
    try:
        s = b.decode("utf-8")
    except UnicodeDecodeError:
        raise ERR_MALFORMED_INVALID_UTF8() from None
    if "\x00" in s:  # [MQTT-1.5.4-2]
        raise ERR_MALFORMED_INVALID_UTF8()
    return s, next_


def decode_byte(buf: bytes, offset: int) -> tuple[int, int]:
    if len(buf) <= offset:
        raise ERR_MALFORMED_OFFSET_BYTE_OUT_OF_RANGE()
    return buf[offset], offset + 1


def decode_byte_bool(buf: bytes, offset: int) -> tuple[bool, int]:
    if len(buf) <= offset:
        raise ERR_MALFORMED_OFFSET_BOOL_OUT_OF_RANGE()
    return bool(buf[offset] & 1), offset + 1


def encode_bool(b: bool) -> int:
    return 1 if b else 0


def encode_uint16(val: int) -> bytes:
    return val.to_bytes(2, "big")


def encode_uint32(val: int) -> bytes:
    return val.to_bytes(4, "big")


def encode_bytes(val: bytes) -> bytes:
    return len(val).to_bytes(2, "big") + bytes(val)


def encode_string(val: str) -> bytes:
    b = val.encode("utf-8")
    return len(b).to_bytes(2, "big") + b


def encode_length(out: bytearray, length: int) -> None:
    """Append a variable byte integer (MQTT v5 §1.5.5) to ``out``."""
    while True:
        eb = length % 128
        length //= 128
        if length > 0:
            eb |= 0x80
        out.append(eb)
        if length == 0:
            break  # [MQTT-1.5.5-1]


def decode_length(buf: bytes, offset: int) -> tuple[int, int]:
    """Decode a variable byte integer; returns ``(value, next_offset)``.

    Raises on >4-byte overflow (max 268435455) or truncated input.
    """
    multiplier = 0
    value = 0
    while True:
        if offset >= len(buf):
            raise ERR_MALFORMED_VARIABLE_BYTE_INTEGER()
        eb = buf[offset]
        offset += 1
        value |= (eb & 127) << multiplier
        if value > MAX_VARINT:
            raise ERR_MALFORMED_VARIABLE_BYTE_INTEGER()
        if (eb & 128) == 0:
            return value, offset
        multiplier += 7


def valid_utf8(b: bytes) -> bool:
    """True when ``b`` is valid UTF-8 without NUL [MQTT-1.5.4-1] [MQTT-1.5.4-2]."""
    if b"\x00" in b:
        return False
    try:
        b.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True
