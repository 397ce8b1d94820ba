"""MQTT v3.1.1 / v5 wire codec.

A copy of the JAX package's codec: the packet model, the primitive codec,
the fixed header, v5 properties and reason codes, with behavioral parity
to the reference ``packets/`` package. ``Subscription`` is also the record
the trie stores and the C materializer copies by slot offsets; ``Packet``
the record the retained store, the inflight store and the clients' read
and write loops carry.
"""

from .codec import (
    MAX_VARINT,
    decode_byte,
    decode_byte_bool,
    decode_bytes,
    decode_length,
    decode_string,
    decode_uint16,
    decode_uint32,
    encode_bool,
    encode_bytes,
    encode_length,
    encode_string,
    encode_uint16,
    encode_uint32,
    valid_utf8,
)
from .codes import *  # noqa: F401,F403 — the full reason-code table
from .codes import Code, QOS_CODES, V5_CODES_TO_V3
from .codes import ERR_MALFORMED_PACKET
from .fixedheader import (
    AUTH,
    CONNACK,
    CONNECT,
    DISCONNECT,
    PACKET_NAMES,
    PINGREQ,
    PINGRESP,
    PUBACK,
    PUBCOMP,
    PUBLISH,
    PUBREC,
    PUBREL,
    RESERVED,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    WILL_PROPERTIES,
    FixedHeader,
)
from .packets import (
    ConnectParams,
    Packet,
    PacketStore,
    Subscription,
    Subscriptions,
)
from .properties import (
    VALID_PACKET_PROPERTIES,
    Mods,
    Properties,
    UserProperty,
)

# Raised when the packet-type nibble does not name a decodable packet
# (reference packets.go:42).
ERR_NO_VALID_PACKET_AVAILABLE = Code(0x00, "no valid packet available")

# Per-type decode/encode dispatch. The broker read/write paths and tests
# share these tables (reference: the switches at clients.go:478-512,557-590).
DECODERS = {
    CONNECT: Packet.connect_decode,
    CONNACK: Packet.connack_decode,
    PUBLISH: Packet.publish_decode,
    PUBACK: Packet.puback_decode,
    PUBREC: Packet.pubrec_decode,
    PUBREL: Packet.pubrel_decode,
    PUBCOMP: Packet.pubcomp_decode,
    SUBSCRIBE: Packet.subscribe_decode,
    SUBACK: Packet.suback_decode,
    UNSUBSCRIBE: Packet.unsubscribe_decode,
    UNSUBACK: Packet.unsuback_decode,
    PINGREQ: Packet.pingreq_decode,
    PINGRESP: Packet.pingresp_decode,
    DISCONNECT: Packet.disconnect_decode,
    AUTH: Packet.auth_decode,
}

ENCODERS = {
    CONNECT: Packet.connect_encode,
    CONNACK: Packet.connack_encode,
    PUBLISH: Packet.publish_encode,
    PUBACK: Packet.puback_encode,
    PUBREC: Packet.pubrec_encode,
    PUBREL: Packet.pubrel_encode,
    PUBCOMP: Packet.pubcomp_encode,
    SUBSCRIBE: Packet.subscribe_encode,
    SUBACK: Packet.suback_encode,
    UNSUBSCRIBE: Packet.unsubscribe_encode,
    UNSUBACK: Packet.unsuback_encode,
    PINGREQ: Packet.pingreq_encode,
    PINGRESP: Packet.pingresp_encode,
    DISCONNECT: Packet.disconnect_encode,
    AUTH: Packet.auth_encode,
}


def decode_packet(raw: bytes, protocol_version: int = 4) -> Packet:
    """Decode a complete wire packet (fixed header + body) into a Packet."""
    if not raw:
        raise ERR_NO_VALID_PACKET_AVAILABLE()
    header = FixedHeader()
    header.decode(raw[0])
    remaining, offset = decode_length(raw, 1)
    header.remaining = remaining
    if len(raw) - offset < remaining:
        raise ERR_MALFORMED_PACKET()
    pk = Packet(fixed_header=header, protocol_version=protocol_version)
    decoder = DECODERS.get(header.type)
    if decoder is None:
        raise ERR_NO_VALID_PACKET_AVAILABLE()
    # NOTE: bytes past the declared remaining length are ignored; stream
    # callers (the broker read loop) must frame packets before calling this.
    decoder(pk, bytes(raw[offset : offset + remaining]))
    return pk


def encode_packet(pk: Packet) -> bytes:
    """Encode a Packet into wire bytes (fixed header + body)."""
    out = bytearray()
    ENCODERS[pk.fixed_header.type](pk, out)
    return bytes(out)
