"""WebSocket listener: HTTP upgrade + binary-frame wrapping of the MQTT
byte stream.

A copy of the JAX package's (reference ``listeners/websocket.go:30-199``): the
upgrade advertises the ``mqtt`` subprotocol, reads reassemble binary frames
into a contiguous byte stream, and each broker write goes out as one binary
frame. Implemented directly over asyncio (a dependency-free RFC 6455
server subset: no extensions, server frames unmasked, handles
ping/pong/close/continuation). Inbound frames are size-capped and the pump
applies backpressure so a hostile peer cannot buffer unbounded memory.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import struct

from . import EstablishFn, StreamListener, split_host_port

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

# Hard cap on a single inbound frame; larger declared lengths close the
# connection (MQTT's own maximum-packet-size applies after reassembly).
MAX_FRAME = 1 << 20
# Pause reading when this much reassembled data is pending in the MQTT
# stream (no transport below the feed StreamReader, so no built-in
# pause_reading backpressure).
MAX_PENDING = 2 * MAX_FRAME


def _accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def _encode_frame(opcode: int, data: bytes) -> bytes:
    """One unmasked server frame with FIN set, any payload length."""
    n = len(data)
    if n < 126:
        header = struct.pack("!BB", 0x80 | opcode, n)
    elif n < (1 << 16):
        header = struct.pack("!BBH", 0x80 | opcode, 126, n)
    else:
        header = struct.pack("!BBQ", 0x80 | opcode, 127, n)
    return header + data


class _WsWriter:
    """Wraps a StreamWriter so each write emits one binary frame
    (websocket.go:187-197).

    It hides the raw socket (``get_extra_info("socket")`` is None) and
    exposes the transport, so the server's batched fan-out, which writes
    encoded frames straight to ready sockets (``native.fan_flush``) and
    reads ``writer.transport`` to find them, sends a websocket subscriber's
    frames through ``write`` instead. The JAX package's wrapper has no
    ``transport``: its batched fan-out fails on the attribute and skips
    every websocket subscriber (``tests/test_torch_http.py`` pins it)."""

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer

    @property
    def transport(self):
        return self._writer.transport

    def write(self, data: bytes) -> None:
        self._writer.write(_encode_frame(OP_BINARY, data))

    def close(self) -> None:
        try:
            self._writer.write(_encode_frame(OP_CLOSE, b""))
        except Exception:  # brokerlint: ok=R4 best-effort CLOSE frame; the close() below is the real teardown
            pass
        self._writer.close()

    def get_extra_info(self, name, default=None):
        if name == "socket":
            return default  # a raw write would bypass the framing
        return self._writer.get_extra_info(name, default)

    async def drain(self) -> None:
        await self._writer.drain()


async def websocket_handshake(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
    """Perform the HTTP upgrade; returns True on success."""
    request = await reader.readuntil(b"\r\n\r\n")
    headers = {}
    for line in request.split(b"\r\n")[1:]:
        if b":" in line:
            k, _, v = line.partition(b":")
            headers[k.strip().lower().decode()] = v.strip().decode()
    key = headers.get("sec-websocket-key")
    if not key or "upgrade" not in headers.get("connection", "").lower():
        writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        await writer.drain()
        return False
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n"
    )
    # advertise the mqtt subprotocol when requested (websocket.go:48-53)
    protocols = headers.get("sec-websocket-protocol", "")
    if "mqtt" in [p.strip() for p in protocols.split(",")]:
        response += "Sec-WebSocket-Protocol: mqtt\r\n"
    writer.write(response.encode() + b"\r\n")
    await writer.drain()
    return True


async def ws_frame_pump(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    out: asyncio.StreamReader,
) -> None:
    """Read WS frames and feed binary payload bytes into ``out`` so the
    broker sees a contiguous MQTT byte stream (websocket.go:149-183)."""
    try:
        while True:
            head = await reader.readexactly(2)
            fin_op, len7 = head[0], head[1]
            opcode = fin_op & 0x0F
            masked = bool(len7 & 0x80)
            length = len7 & 0x7F
            if length == 126:
                length = struct.unpack("!H", await reader.readexactly(2))[0]
            elif length == 127:
                length = struct.unpack("!Q", await reader.readexactly(8))[0]
            if length > MAX_FRAME:
                writer.write(_encode_frame(OP_CLOSE, struct.pack("!H", 1009)))
                break  # 1009: message too big
            mask = await reader.readexactly(4) if masked else b""
            payload = await reader.readexactly(length) if length else b""
            if masked and payload:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if opcode in (OP_BINARY, OP_CONT):
                if payload:
                    # backpressure: wait for the broker to drain pending bytes
                    while len(out._buffer) > MAX_PENDING:  # noqa: SLF001
                        await asyncio.sleep(0.005)
                    out.feed_data(payload)
            elif opcode == OP_PING:
                writer.write(_encode_frame(OP_PONG, payload))
            elif opcode == OP_CLOSE:
                break
            # OP_TEXT / OP_PONG ignored (mqtt-over-ws is binary-only)
    except (asyncio.IncompleteReadError, ConnectionError):
        pass
    finally:
        out.feed_eof()


class Websocket(StreamListener):
    """A websocket listener serving MQTT over binary frames."""

    def protocol(self) -> str:
        return "wss" if self.config.tls_config else "ws"

    def _fabric_bind(self) -> list:
        from . import bind_stream_socket

        # hand-off accept only: the upgrade + frame pump run on the
        # shard's loop either way (the fabric routes through _handle)
        self._fabric_reuseport = False
        host, port = split_host_port(self.config.address)
        return [
            bind_stream_socket(
                host, port, reuse_port=bool(self.config.reuse_port)
            )
        ]

    async def init(self, log: logging.Logger) -> None:
        self.log = log
        if self._fabric is not None:
            self._lsocks = self._fabric_bind()
            return
        host, port = split_host_port(self.config.address)
        self._server = await asyncio.start_server(
            self._on_connection,
            host,
            port,
            ssl=self.config.tls_config,
            reuse_port=self.config.reuse_port or None,
        )

    async def _handle(self, reader, writer, establish: EstablishFn) -> None:
        if not await websocket_handshake(reader, writer):
            return
        mqtt_stream = asyncio.StreamReader()
        pump = asyncio.get_running_loop().create_task(
            ws_frame_pump(reader, writer, mqtt_stream)
        )
        try:
            await establish(self.id(), mqtt_stream, _WsWriter(writer))
        finally:
            pump.cancel()
