"""Build and load the port's C host code: the tokenizer and the materializer.

Two sources, copies of the JAX package's native code with the departures
each names in its header:

- ``mqtt_native.c``: blake2b token hashing and batch topic tokenization, a
  plain C library loaded with ``ctypes`` (``lib()``). The port binds
  ``mqtt_hash_token`` and ``mqtt_tokenize_topics``.
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
A failed build or load raises ``NativeError`` with the compiler's output:
the port has no Python fallback on its main path. The plain Python
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
            ptr = ctypes.c_void_p
            cdll.mqtt_hash_token.restype = ctypes.c_uint64
            cdll.mqtt_hash_token.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
            cdll.mqtt_tokenize_topics.restype = None
            cdll.mqtt_tokenize_topics.argtypes = [
                ctypes.c_char_p, ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                ptr, ptr, ptr, ptr, ptr,
            ]
            _lib = cdll
    return _lib


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


__all__ = [
    "NativeError",
    "accel",
    "compiler",
    "hash_token_native",
    "lib",
    "library_path",
    "tokenize_topics_native",
]
