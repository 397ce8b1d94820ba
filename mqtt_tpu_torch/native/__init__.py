"""Build and load the port's C host code: the tokenizer, the frame
functions and the materializer.

Two sources, copies of the JAX package's native code with the departures
each names in its header:

- ``mqtt_native.c``: blake2b token hashing and batch topic tokenization,
  and the wire's byte paths (``varint_decode``/``varint_encode``,
  ``utf8_valid``, ``frame_scan``/``frame_scan_multi`` for the clients'
  read loop, ``fan_flush`` and ``assemble_frames`` for the fan-out's
  writes), a plain C library loaded with ``ctypes`` (``lib()``).
- ``accelmod.c``: the match-result materializer, a CPython extension
  module named ``mqtt_torch_accel`` (``accel()``): eager ``Subscribers``
  results and lazy ``SubscribersView`` results from the device's ranges
  rows or pair stream, with the tenant namespace guards.

Each builds with the host C compiler (``$CC``, else the first of ``cc``,
``gcc`` and ``clang`` on ``PATH``) at first use, never at import, into
``mqtt_tpu_torch/build/`` (kept out of git), named by a hash of its source,
the flags, the compiler and (for the extension) the CPython ABI, so an
edited source rebuilds. A build writes a temp file and renames it into
place, so processes that build at once never load a half-written library.
Each build is noted in the first-launch ledger (``ops.devicestats.LEDGER``)
as ``cc:<source>`` with its wall time.
A failed build or load raises ``NativeError`` with the compiler's output,
from every binding: the port has no Python fallback (the JAX package
falls back to Python frame scanners when its library is missing). The plain Python
versions (``ops/hashing.tokenize_topics_py``, ``ops/matcher.expand_sids``
and its callers' ``*_py`` forms) stay for the tests to hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "build"
NATIVE_SRC = _HERE / "mqtt_native.c"
ACCEL_SRC = _HERE / "accelmod.c"
ACCEL_MODULE = "mqtt_torch_accel"
CFLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_accel = None

# Per-scan frame cap: bounds the output arrays while the read loop keeps
# rescanning until the buffer is drained, so it is not a throughput cap.
MAX_FRAMES_PER_SCAN = 256


class NativeError(Exception):
    """The C host code failed to build or load. Like ``KernelError`` it
    does not derive from ``RuntimeError``, so no handler meant for a torn
    read of the live trie can swallow it."""


def compiler() -> str:
    """The host C compiler: ``$CC`` when set (and then only it), else the
    first of ``cc``, ``gcc`` and ``clang`` on ``PATH``."""
    cc = os.environ.get("CC")
    if cc:
        return cc
    for name in ("cc", "gcc", "clang"):
        if shutil.which(name):
            return name
    raise NativeError("no C compiler found ($CC unset; no cc, gcc or clang on PATH)")


def _extra(src: Path) -> list[str]:
    """Flags beyond ``CFLAGS``: the CPython headers for the extension."""
    if src == ACCEL_SRC:
        return [f"-I{sysconfig.get_paths()['include']}"]
    return []


def library_path(src: Path, cc: str) -> Path:
    """Where ``src``'s library lands, named by a hash of the source text,
    the flags and the compiler (and, for the extension, the CPython ABI
    tag it was built for)."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join((cc, *CFLAGS, *_extra(src))).encode())
    tag = f"{sys.implementation.cache_tag}-{os.uname().machine}"
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}-{tag}.so"


def _build(src: Path) -> Path:
    """Compile ``src`` unless its library exists; return the library's
    path. Raises ``NativeError`` with the compiler's output on failure."""
    cc = compiler()
    out = library_path(src, cc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [cc, *CFLAGS, *_extra(src), "-o", tmp, str(src)]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeError(f"cannot run the C compiler {cc!r} for {src.name}: {e}") from e
        if r.returncode != 0:
            raise NativeError(
                f"{src.name}: {cc} exit {r.returncode}\n{r.stdout}{r.stderr}"
            )
        os.replace(tmp, out)
        # imported here: ops imports this package
        from ..ops.devicestats import LEDGER

        LEDGER.note_compile(f"cc:{src.name}", cc, time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The tokenizer library (``mqtt_native.c``), built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if sys.byteorder != "little":
                # the C hashing assumes little-endian loads
                raise NativeError("the C tokenizer needs a little-endian host")
            path = _build(NATIVE_SRC)
            try:
                cdll = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeError(f"cannot load {path.name}: {e}") from e
            _declare(cdll)
            _lib = cdll
    return _lib


def available() -> bool:
    """Whether the tokenizer library builds and loads; its bindings raise
    ``NativeError`` where it does not."""
    try:
        lib()
    except NativeError:
        return False
    return True


def _declare(l: ctypes.CDLL) -> None:
    """Every entry point's ctypes signature; the frame functions' as the
    JAX package declares them."""
    ptr = ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    l.mqtt_hash_token.restype = ctypes.c_uint64
    l.mqtt_hash_token.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
    l.mqtt_tokenize_topics.restype = None
    l.mqtt_tokenize_topics.argtypes = [
        ctypes.c_char_p, ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ptr, ptr, ptr, ptr, ptr,
    ]
    l.mqtt_varint_decode.restype = ctypes.c_int
    l.mqtt_varint_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32)
    ]
    l.mqtt_varint_encode.restype = ctypes.c_int
    l.mqtt_varint_encode.argtypes = [ctypes.c_uint32, u8p]
    l.mqtt_fh_validate.restype = ctypes.c_int
    l.mqtt_fh_validate.argtypes = [ctypes.c_uint8]
    l.mqtt_frame_scan.restype = ctypes.c_int64
    l.mqtt_frame_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64), u8p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    l.mqtt_utf8_valid.restype = ctypes.c_int
    l.mqtt_utf8_valid.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    l.mqtt_fan_flush.restype = ctypes.c_int64
    l.mqtt_fan_flush.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int64),
    ]
    l.mqtt_frame_scan_multi.restype = None
    l.mqtt_frame_scan_multi.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64), u8p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    l.mqtt_assemble_frames.restype = None
    l.mqtt_assemble_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int64, u8p,
        ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64, u8p,
    ]


def accel():
    """The materializer extension module (``accelmod.c``), built on first
    use."""
    global _accel
    if _accel is not None:
        return _accel
    with _lock:
        if _accel is None:
            path = _build(ACCEL_SRC)
            try:
                loader = importlib.machinery.ExtensionFileLoader(ACCEL_MODULE, str(path))
                spec = importlib.util.spec_from_file_location(ACCEL_MODULE, str(path), loader=loader)
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
            except (OSError, ImportError) as e:
                raise NativeError(f"cannot load {path.name}: {e}") from e
            _accel = mod
    return _accel


def hash_token_native(token: bytes, salt: int = 0) -> int:
    """8-byte blake2b of one token as a little-endian u64."""
    return lib().mqtt_hash_token(token, len(token), salt)


def tokenize_topics_native(topics: list[str], max_levels: int, salt: int = 0):
    """Batch tokenization with the output contract of
    ``ops/hashing.tokenize_topics``: ``(tok1[B,L], tok2[B,L], lengths[B],
    is_dollar[B], overflow[B])``."""
    l = lib()
    n = len(topics)
    encoded = [t.encode("utf-8") for t in topics]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, encoded), dtype=np.int64, count=n), out=offsets[1:])
    tok1 = np.zeros((n, max_levels), dtype=np.uint32)
    tok2 = np.zeros((n, max_levels), dtype=np.uint32)
    lengths = np.zeros(n, dtype=np.int32)
    is_dollar = np.zeros(n, dtype=np.uint8)
    overflow = np.zeros(n, dtype=np.uint8)
    if n:
        l.mqtt_tokenize_topics(
            b"".join(encoded), offsets.ctypes.data, n, max_levels, salt,
            tok1.ctypes.data, tok2.ctypes.data, lengths.ctypes.data,
            is_dollar.ctypes.data, overflow.ctypes.data,
        )
    return tok1, tok2, lengths, is_dollar.view(bool), overflow.view(bool)


def varint_decode(buf: bytes) -> tuple[int, int]:
    """Returns (value, bytes_consumed); consumed 0 = need more bytes.
    Raises ValueError on a malformed integer."""
    l = lib()
    value = ctypes.c_uint32()
    r = l.mqtt_varint_decode(buf, len(buf), ctypes.byref(value))
    if r < 0:
        raise ValueError("malformed variable byte integer")
    return value.value, r


def varint_encode(value: int) -> bytes:
    l = lib()
    out = (ctypes.c_uint8 * 4)()
    n = l.mqtt_varint_encode(value, out)
    if n < 0:
        raise ValueError("value exceeds maximum variable byte integer")
    return bytes(out[:n])


def utf8_valid(data: bytes) -> bool:
    """Strict UTF-8 incl. the MQTT NUL rejection [MQTT-1.5.4-2]."""
    return bool(lib().mqtt_utf8_valid(data, len(data)))


class Frame:
    """One complete packet located by frame_scan."""

    __slots__ = ("first_byte", "body_offset", "remaining")

    def __init__(self, first_byte: int, body_offset: int, remaining: int):
        self.first_byte = first_byte
        self.body_offset = body_offset
        self.remaining = remaining


def frame_scan(
    buf: bytes, max_frames: int = 1024, max_packet_size: int = 0
) -> tuple[list[Frame], int, int]:
    """Split a raw read buffer into complete MQTT packets.

    Returns ``(frames, consumed, err)``. ``frames`` holds every complete
    packet found before any error (the caller still processes them).
    ``err``: 0 ok, -1 malformed header/varint, -2 packet-too-large; on
    error ``consumed`` points at the offending packet's first byte.
    """
    l = lib()
    body_offsets = np.zeros(max_frames, dtype=np.int64)
    first_bytes = np.zeros(max_frames, dtype=np.uint8)
    remainings = np.zeros(max_frames, dtype=np.uint32)
    consumed = ctypes.c_int64()
    err = ctypes.c_int32()
    if isinstance(buf, (bytearray, memoryview)):
        # zero-copy view of the mutable read buffer
        holder = (ctypes.c_char * len(buf)).from_buffer(buf) if len(buf) else b""
        ptr = ctypes.addressof(holder) if len(buf) else None
    else:
        holder = buf
        ptr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value if buf else None
    try:
        n = l.mqtt_frame_scan(
            ptr, len(buf), max_frames, max_packet_size,
            body_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            first_bytes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            remainings.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(consumed), ctypes.byref(err),
        )
    finally:
        # release the from_buffer export deterministically: anything that
        # pins this frame past return (a sampling profiler, a debugger)
        # would otherwise keep the export alive and make the caller's
        # `del rbuf[:consumed]` raise BufferError mid-read-loop
        del holder
    frames = [
        Frame(int(first_bytes[i]), int(body_offsets[i]), int(remainings[i]))
        for i in range(n)
    ]
    return frames, consumed.value, err.value


def fan_flush(fds, frame: bytes, id_offset: int = -1, ids=None):
    """Write one encoded PUBLISH variant frame to many ready sockets in
    a single GIL-released native call (the server's batched fan-out).

    ``fds`` is a sequence of socket fds whose transports the caller
    verified idle; ``id_offset``/``ids`` patch per-target 2-byte packet
    ids via writev iovecs for QoS>0 variants (no per-target copies).
    Returns an int64 array of per-target results: bytes written, or
    ``-errno``."""
    l = lib()
    n = len(fds)
    fds_arr = np.asarray(fds, dtype=np.int32)
    sent = np.zeros(n, dtype=np.int64)
    if ids is None:
        ids_arr = np.zeros(0, dtype=np.uint16)
        id_offset = -1
    else:
        ids_arr = np.asarray(ids, dtype=np.uint16)
    if n:
        l.mqtt_fan_flush(
            fds_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, frame, len(frame), id_offset,
            ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            sent.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    return sent


def frame_scan_multi(
    bufs: list, max_frames: int = 256, max_packet_size: int = 0
) -> list[tuple[list[Frame], int, int]]:
    """Scan K read buffers in ONE native call: the read-side decode
    batched across ready sockets (the coalesced read path). Returns one
    ``(frames, consumed, err)`` tuple per buffer with frame_scan's exact
    contract."""
    l = lib()
    k = len(bufs)
    if k == 0:
        return []
    holders: list = []
    ptrs = (ctypes.c_void_p * k)()
    lens = np.zeros(k, dtype=np.int64)
    for i, buf in enumerate(bufs):
        lens[i] = len(buf)
        if isinstance(buf, (bytearray, memoryview)):
            # the export must live ONLY in `holders`: a loop-local binding
            # would survive the finally below and keep the last buffer
            # exported while its read loop resumes (frame_scan's hazard)
            if len(buf):
                holders.append((ctypes.c_char * len(buf)).from_buffer(buf))
                ptrs[i] = ctypes.addressof(holders[-1])
            else:
                holders.append(b"")
                ptrs[i] = None
        else:
            holders.append(buf)
            ptrs[i] = (
                ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
                if buf
                else None
            )
    body_offsets = np.zeros(k * max_frames, dtype=np.int64)
    first_bytes = np.zeros(k * max_frames, dtype=np.uint8)
    remainings = np.zeros(k * max_frames, dtype=np.uint32)
    counts = np.zeros(k, dtype=np.int64)
    consumed = np.zeros(k, dtype=np.int64)
    errs = np.zeros(k, dtype=np.int32)
    try:
        l.mqtt_frame_scan_multi(
            k, ptrs,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_frames, max_packet_size,
            body_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            first_bytes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            remainings.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            consumed.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            errs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        # release the from_buffer exports in place, as frame_scan does
        holders.clear()
        del holders
    out = []
    for i in range(k):
        base = i * max_frames
        frames = [
            Frame(
                int(first_bytes[base + j]),
                int(body_offsets[base + j]),
                int(remainings[base + j]),
            )
            for j in range(int(counts[i]))
        ]
        out.append((frames, int(consumed[i]), int(errs[i])))
    return out


def assemble_frames(head: bytes, nonces, keystreams, plaintext: bytes):
    """Assemble N per-subscriber encrypted PUBLISH frames (head ||
    nonce_i || (plaintext XOR keystream_i)) in one GIL-released native
    pass (the re-encrypt fan-out's encode-once path). ``nonces`` is
    uint8 [N, nonce_len], ``keystreams`` uint8 [N, >= len(plaintext)].
    Returns a uint8 array [N, frame_len], or None when the keystream rows
    are shorter than the plaintext."""
    l = lib()
    nonces = np.ascontiguousarray(nonces, dtype=np.uint8)
    keystreams = np.ascontiguousarray(keystreams, dtype=np.uint8)
    n, nonce_len = nonces.shape
    pt_len = len(plaintext)
    ks_stride = keystreams.shape[1] if keystreams.ndim == 2 else 0
    if n and pt_len > ks_stride:
        return None
    out = np.empty((n, len(head) + nonce_len + pt_len), dtype=np.uint8)
    if n:
        pt = np.frombuffer(plaintext, dtype=np.uint8)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        l.mqtt_assemble_frames(
            head, len(head),
            nonces.ctypes.data_as(u8), nonce_len,
            keystreams.ctypes.data_as(u8), ks_stride,
            pt.ctypes.data_as(u8), pt_len,
            n, out.ctypes.data_as(u8),
        )
    return out


__all__ = [
    "MAX_FRAMES_PER_SCAN",
    "Frame",
    "NativeError",
    "accel",
    "assemble_frames",
    "compiler",
    "fan_flush",
    "frame_scan",
    "frame_scan_multi",
    "hash_token_native",
    "lib",
    "library_path",
    "tokenize_topics_native",
    "utf8_valid",
    "varint_decode",
    "varint_encode",
]
