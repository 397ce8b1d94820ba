"""Build, load and launch the hand-written CUDA kernels of the matcher.

``csrc/flat_match.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use into ``mqtt_tpu_torch/build/`` (kept out of git),
named by a hash of the source and flags so an edited source rebuilds.
Nothing here runs when the module is imported: this module is imported
on machines without a card or a compiler.

Each wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error,
and adds one to its entry in ``LAUNCHES``. The wrappers take CUDA tensors
only; the plain PyTorch versions in ``ops/flat.py`` serve CPU tensors.

A failed build, load or launch raises ``KernelError``. It does not derive
from ``RuntimeError``, so no handler meant for a torn read of the live
trie (``RuntimeError``/``KeyError``) can swallow it: it reaches the
caller of the matcher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("flat_match.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# one count per kernel wrapper, bumped where the wrapper launches
LAUNCHES = {"flat_probe_ranges": 0, "flat_match_compact": 0, "scatter_rows": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
_SIGNATURES = {
    "fm_probe_ranges": [_c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr,
                        _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr],
    "fm_match_compact": [_c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr,
                         _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr],
    "fm_scatter_rows": [_c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr],
}
_SCAN_TILE = 1024  # kScanThreads in flat_match.cu


class KernelError(Exception):
    """A kernel failed to build, load or launch."""


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(source: str) -> Path:
    """Where ``source``'s library lands: named by a hash of the source
    text and the flags."""
    src = SOURCE_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together. ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel). Returns
    ``{source: compiler output}``; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(SOURCE_DIR / source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {}
    failed = []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"{source}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build_all()
            try:
                lib = ctypes.CDLL(str(library_path("flat_match.cu")))
            except OSError as e:
                raise KernelError(f"cannot load the kernel library: {e}") from e
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _c_int
            lib.fm_error_string.argtypes = [_c_int]
            lib.fm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(t, name: str, device: torch.device, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_index(table, pat_kind, pat_depth, pat_mask, device) -> tuple[int, int]:
    _check(table, "table", device, 2)
    S = table.shape[0]
    if table.shape[1] != 16 or S < 1 or S & (S - 1) or S >= 1 << 31:
        raise ValueError(f"table must be [S, 16] with S a power of two, got {tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    for name, t in (("pat_kind", pat_kind), ("pat_depth", pat_depth), ("pat_mask", pat_mask)):
        _check(t, name, device, 1)
    P = pat_depth.shape[0]
    if pat_kind.shape[0] != P or pat_mask.shape[0] != P:
        raise ValueError("pattern arrays must share one length")
    return S, P


def _check_tokens(tokens, device, max_levels: int) -> tuple[int, int]:
    _check(tokens, "packed_tokens", device, 2)
    B, W = tokens.shape
    if W < 2 or W % 2:
        raise ValueError(f"packed tokens must be [B, 2L+2], got {tuple(tokens.shape)}")
    if not 0 <= max_levels <= (W - 2) // 2:
        raise ValueError(f"max_levels {max_levels} exceeds the token width {(W - 2) // 2}")
    return B, W


def _cuda_device(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    return t.device


def _launched(lib, err: int, name: str) -> None:
    """Raise if the launch reported an error, else count it."""
    if err:
        raise KernelError(f"{name} launch failed: {lib.fm_error_string(err).decode()} ({err})")
    with _count_lock:
        LAUNCHES[name] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flat_probe_ranges(table, pat_kind, pat_depth, pat_mask, tokens, max_levels: int):
    """K1: ``[B, 2L+2]`` packed tokens -> ``[B, 2P+2]`` packed ranges."""
    device = _cuda_device(tokens)
    S, P = _check_index(table, pat_kind, pat_depth, pat_mask, device)
    B, W = _check_tokens(tokens, device, max_levels)
    out = torch.empty((B, 2 * P + 2), dtype=torch.int32, device=device)
    if B == 0:
        return out
    lib = library()
    err = lib.fm_probe_ranges(
        tokens.data_ptr(), B, W, max_levels, table.data_ptr(), S,
        pat_kind.data_ptr(), pat_depth.data_ptr(), pat_mask.data_ptr(), P,
        out.data_ptr(), _stream(device),
    )
    _launched(lib, err, "flat_probe_ranges")
    return out


def flat_match_compact(table, pat_kind, pat_depth, pat_mask, tokens, max_levels: int, capacity: int):
    """K2: ``[B, 2L+2]`` packed tokens -> ``[2 + 2B + capacity]`` compacted
    sid stream. Needs ``B >= 1`` and ``P >= 1`` (``ops/flat.py`` writes the
    constant output otherwise)."""
    device = _cuda_device(tokens)
    S, P = _check_index(table, pat_kind, pat_depth, pat_mask, device)
    B, W = _check_tokens(tokens, device, max_levels)
    if B < 1 or P < 1 or capacity < 1:
        raise ValueError(f"compact kernel needs B, P, capacity >= 1 (got {B}, {P}, {capacity})")
    N = B * P
    if N + 2 * B + capacity >= 1 << 31:
        raise ValueError("compact batch too large for int32 offsets")
    tiles = -(-N // _SCAN_TILE)
    out = torch.empty((2 + 2 * B + capacity,), dtype=torch.int32, device=device)
    scratch = torch.empty((3 * N + tiles + 1,), dtype=torch.int32, device=device)
    lib = library()
    err = lib.fm_match_compact(
        tokens.data_ptr(), B, W, max_levels, table.data_ptr(), S,
        pat_kind.data_ptr(), pat_depth.data_ptr(), pat_mask.data_ptr(), P,
        capacity, out.data_ptr(), scratch.data_ptr(), _stream(device),
    )
    _launched(lib, err, "flat_match_compact")
    return out


def scatter_rows(table, idx, rows):
    """K3: a new table equal to ``table`` with rows ``idx`` replaced."""
    device = _cuda_device(table)
    _check(table, "table", device, 2)
    _check(idx, "idx", device, 1)
    _check(rows, "rows", device, 2)
    S = table.shape[0]
    k = idx.shape[0]
    if table.shape[1] != 16 or rows.shape != (k, 16):
        raise ValueError("scatter_rows takes table [S, 16], idx [k], rows [k, 16]")
    if table.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("table and rows must be 16-byte aligned")
    out = torch.empty_like(table)
    lib = library()
    err = lib.fm_scatter_rows(
        table.data_ptr(), S, idx.data_ptr(), k, rows.data_ptr(), out.data_ptr(),
        _stream(device),
    )
    _launched(lib, err, "scatter_rows")
    return out
