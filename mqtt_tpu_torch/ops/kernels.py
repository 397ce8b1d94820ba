"""Build, load and launch the hand-written CUDA kernels of the port.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and loaded with
``ctypes``: ``flat_match.cu`` (the topic matcher, K1-K3),
``predicates.cu`` (payload predicates, K4-K5), ``recrypt.cu`` (tenant
re-encryption, K6) and ``sharded.cu`` (the subscription-sharded matcher,
K7-K9; it shares ``flat_probe.cuh`` with ``flat_match.cu``). The build
runs at first use into
``mqtt_tpu_torch/build/`` (kept out of git), one ``nvcc`` per source, all
started together, each library named by a hash of its source, the
shared headers and the flags so an edited source or header rebuilds. Nothing here runs when the module is
imported: this module is imported on machines without a card or a
compiler.

Each wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream(device)`` of its tensors' card (named, so a
shard loop's thread launches where the tensors are), raises if the launch reports an error,
and adds one to its entry in ``LAUNCHES``. Each runs inside a
``devicestats.KernelWatch`` under its own name, which notes the first
launch of every new signature (shapes, dtypes, devices, integer
arguments) in ``devicestats.LEDGER``: the host's enqueue time of that
launch, not the kernel's. The library is loaded (built at first use)
before the watch times the call, and each ``nvcc`` build is noted under
its own name, ``nvcc:<source>``. The wrappers take CUDA tensors
only; the plain PyTorch versions in ``ops/flat.py``, ``ops/predicates.py``,
``ops/recrypt.py`` and ``parallel/sharded.py`` serve CPU tensors.

A failed build, load or launch raises ``KernelError``. It does not derive
from ``RuntimeError``, so no handler meant for a torn read of the live
trie (``RuntimeError``/``KeyError``) can swallow it: it reaches the
caller.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .devicestats import LEDGER, KernelWatch

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("flat_match.cu", "predicates.cu", "recrypt.cu", "sharded.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# one count per kernel wrapper, bumped where the wrapper launches. The
# sharded step launches K7's kernel over its tiles and stacked shards and
# counts under "sharded_step" only
LAUNCHES = {
    "flat_probe_ranges": 0, "flat_match_compact": 0, "scatter_rows": 0,
    "rules_eval": 0, "agg_reduce": 0, "keystream": 0,
    "flat_match_slots": 0, "sharded_step": 0, "tile_compact": 0,
}

_lock = threading.Lock()
_count_lock = threading.Lock()
# held from taking a look-back scratch's epoch to the launch that uses it
# (K2, K9): callers on several threads (the matcher's guard threads) then
# enqueue their launches on a stream in the order of their epochs, which
# the kernels' tickets and status words rely on
_scratch_launch_lock = threading.Lock()
_libs: dict = {}
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
# per source: its C entry points' argument types, then its error-string function
_SIGNATURES = {
    "flat_match.cu": {
        "fm_probe_ranges": [_c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr,
                            _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr],
        "fm_match_compact": [_c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr,
                             _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_int,
                             ctypes.c_uint, _c_ptr],
        "fm_scatter_rows": [_c_ptr, _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr],
    },
    "predicates.cu": {
        "pk_rules_eval": [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int,
                          _c_ptr, _c_int, _c_int, _c_ptr, _c_ptr],
        "pk_agg_reduce": [_c_ptr, _c_int, _c_int, _c_ptr, _c_ptr],
    },
    "recrypt.cu": {
        "rc_keystream": [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_int, _c_ptr],
    },
    "sharded.cu": {
        "sh_match_slots": [_c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_int,
                           _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                           _c_ptr, _c_ptr],
        "sh_tile_compact": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int,
                            _c_ptr, _c_ptr, _c_int, ctypes.c_uint, _c_ptr],
        "sh_tile_compact_scratch": [_c_int, _c_int, _c_int, _c_int],
    },
}
# entry points whose result is not an error code
_RESTYPES = {"sh_tile_compact_scratch": ctypes.c_longlong}
_ERROR_FNS = {
    "flat_match.cu": "fm_error_string",
    "predicates.cu": "pk_error_string",
    "recrypt.cu": "rc_error_string",
    "sharded.cu": "sh_error_string",
}
# the look-back scratch of K2, one per (device, stream, layout size), and
# the last epoch of each (device, stream); K9's, one per (device, stream),
# with its last epoch and the count of tiles its counters are laid out
# for. Each is zeroed once when allocated and kept zeroed by the kernel's
# own protocol (see fm_match_compact in flat_match.cu and sh_tile_compact
# in sharded.cu)
_compact_scratch: dict = {}
_compact_epochs: dict = {}
_tile_scratch: dict = {}
_EPOCH_MASK = (1 << 31) - 1


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
    text, the shared headers (``csrc/*.cuh``) and the flags."""
    src = SOURCE_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together. ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel). Returns
    ``{source: compiler output}``; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
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
            # the builds run together: each one's seconds are from the
            # common start to the moment this one is known to be done
            LEDGER.note_compile(f"nvcc:{source}", "sm_90a", time.perf_counter() - t0)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(source: str = "flat_match.cu"):
    """The loaded library of one source (every source is built on first
    use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all()
            try:
                lib = ctypes.CDLL(str(library_path(source)))
            except OSError as e:
                raise KernelError(f"cannot load the kernel library {source}: {e}") from e
            for name, args in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _RESTYPES.get(name, _c_int)
            err_fn = getattr(lib, _ERROR_FNS[source])
            err_fn.argtypes = [_c_int]
            err_fn.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def _check(t, name: str, device: torch.device, ndim: int, dtype=torch.int32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
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


def _launched(source: str, err: int, *names: str) -> None:
    """Raise if the launch reported an error, else count it under each
    of ``names``."""
    if err:
        text = getattr(_libs[source], _ERROR_FNS[source])(err).decode()
        raise KernelError(f"{names[0]} launch failed: {text} ({err})")
    with _count_lock:
        for name in names:
            LAUNCHES[name] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _pow2(n: int) -> int:
    """The power-of-two bucket that holds ``n`` (at least 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _rows_sig(table, idx, rows) -> tuple:
    """``scatter_rows``' ledger key: the table's shape and card, and the
    fold's row count by its power-of-two bucket (the launch itself is not
    padded; the JAX package's fold padded it to these buckets)."""
    return ("x".join(map(str, table.shape)) + f",k<={_pow2(idx.shape[0])}", table.device)


def _windows_sig(buf, W: int) -> tuple:
    """``agg_reduce``'s ledger key: the tick's windows and samples, each by
    its power-of-two bucket (the JAX package padded both to these)."""
    return (f"W<={_pow2(W)},n<={_pow2(buf.shape[0] - 3 * W - 1)}", buf.device)


def _watched(source: str, sig=None):
    """Run a wrapper inside a ``KernelWatch`` named after it (``sig``: the
    watch's signature, for a wrapper whose shapes vary call by call).
    Where its first argument lies on a card, ``source``'s library is
    loaded (and built at first use) before the watch times the call, so a
    first launch's note holds the launch's host time and not the build's."""

    def wrap(fn):
        watch = KernelWatch(fn.__name__, fn, sig=sig)

        @functools.wraps(fn)
        def launch(*args, **kwargs):
            first = args[0] if args else None
            if source not in _libs and isinstance(first, torch.Tensor) and first.is_cuda:
                library(source)
            return watch(*args, **kwargs)

        launch.watch = watch
        return launch

    return wrap


@_watched("flat_match.cu")
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
    _launched("flat_match.cu", err, "flat_probe_ranges")
    return out


@_watched("flat_match.cu")
def flat_match_compact(table, pat_kind, pat_depth, pat_mask, tokens, max_levels: int, capacity: int):
    """K2: ``[B, 2L+2]`` packed tokens -> ``[2 + 2B + capacity]`` compacted
    sid stream. Needs ``B >= 1`` and ``P >= 1`` (``ops/flat.py`` writes the
    constant output otherwise)."""
    device = _cuda_device(tokens)
    S, P = _check_index(table, pat_kind, pat_depth, pat_mask, device)
    B, W = _check_tokens(tokens, device, max_levels)
    if B < 1 or P < 1 or capacity < 1:
        raise ValueError(f"compact kernel needs B, P, capacity >= 1 (got {B}, {P}, {capacity})")
    if B * P + 2 * B + capacity >= 1 << 31:
        raise ValueError("compact batch too large for int32 offsets")
    warps = _compact_warps(P, B)
    per_block = warps * (32 // min(P, 32))
    out = torch.empty((2 + 2 * B + capacity,), dtype=torch.int32, device=device)
    stream = _stream(device)
    lib = library()
    with _scratch_launch_lock:
        scratch, epoch = _compact_scratch_for(device, stream, 4 + 4 * -(-B // per_block))
        err = lib.fm_match_compact(
            tokens.data_ptr(), B, W, max_levels, table.data_ptr(), S,
            pat_kind.data_ptr(), pat_depth.data_ptr(), pat_mask.data_ptr(), P,
            capacity, out.data_ptr(), scratch.data_ptr(), warps, epoch, stream,
        )
    _launched("flat_match.cu", err, "flat_match_compact")
    return out


def _compact_warps(P: int, B: int) -> int:
    """K2's warps per CUDA block (a warp probes ``32 // P`` whole topics,
    or one topic where ``P > 32``): the whole batch in one block where it
    fits in 32 warps (no look-back, no done counter), else 8, or fewer
    where ``P`` is so large that the block's starts and counts would pass
    128 KB of shared memory. ``P`` is a power of two (``build_flat_index``
    pads it so); raises otherwise and past 16,384 patterns."""
    if P < 1 or P & (P - 1) or P > 16384:
        raise ValueError(f"the compact kernel takes a power-of-two pattern count up to 16384, got {P}")
    per_warp = 32 // min(P, 32)
    fit = 16384 // max(P, 32)
    need = -(-B // per_warp)
    return need if need <= min(32, fit) else min(8, fit)


def _compact_scratch_for(device, stream: int, n: int) -> tuple:
    """K2's scratch for a launch on ``stream`` whose layout takes ``n``
    ints (4 + 4 per CUDA block), and the stream's next epoch. The kernel
    keeps each block's clip record right after the launch's status words,
    at an offset its block count sets, and a record holds no epoch: in a
    scratch shared with launches of more blocks, a later launch's
    look-back could read a record as a block's published status whose
    epoch bits happen to equal its own, and write its pairs at a wrong
    offset. So each layout has a scratch of its own (batches come in
    power-of-two buckets: a few); launches on one stream run in order, so
    those of one layout share it."""
    key = (device.index, stream)
    with _lock:
        epoch = _compact_epochs[key] = _compact_epochs.get(key, 0) % _EPOCH_MASK + 1  # never 0
        scratch = _compact_scratch.get(key + (n,))
        if scratch is None:
            scratch = _compact_scratch[key + (n,)] = torch.zeros((n,), dtype=torch.int32, device=device)
        return scratch, epoch


def _tile_scratch_for(lib, device, stream: int, T: int, S: int, bl: int) -> tuple:
    """K9's scratch for launches on ``stream``, the count of tiles its
    counters are laid out for, and the next epoch. A launch of more tiles
    than that, or one that needs more room, replaces it with a larger
    zeroed one (launches on one stream run in order). Epochs cycle through
    an even count of values, so consecutive launches alternate in parity,
    across the wrap too (the kernel takes its tickets by that parity)."""
    key = (device.index, stream)
    with _lock:
        entry = _tile_scratch.get(key)
        tiles_cap = max(T, entry[1] if entry else 0)
        need = lib.sh_tile_compact_scratch(T, S, bl, tiles_cap)
        if entry is None or tiles_cap > entry[1] or entry[0].numel() < need:
            zeroed = torch.zeros((max(need, 1024),), dtype=torch.int32, device=device)
            entry = _tile_scratch[key] = [zeroed, tiles_cap, entry[2] if entry else 0]
        entry[2] = entry[2] % (_EPOCH_MASK - 1) + 1  # 1 .. 2^31 - 2, never 0
        return entry[0], entry[1], entry[2]


@_watched("flat_match.cu", sig=_rows_sig)
def scatter_rows(table, idx, rows):
    """K3, in place: ``table[idx[i]] = rows[i]`` for every ``idx[i]`` in
    ``[0, S)`` (the rest dropped); returns ``table``. Nothing else of the
    table is read or written, so the caller must own the buffer: no batch
    may read it until this launch has run (``TorchMatcher`` writes its
    standby buffer)."""
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
    if k == 0:
        return table
    lib = library()
    err = lib.fm_scatter_rows(table.data_ptr(), S, idx.data_ptr(), k, rows.data_ptr(), _stream(device))
    _launched("flat_match.cu", err, "scatter_rows")
    return table


@_watched("predicates.cu")
def rules_eval(op, slot, thresh, cbit, feats, cmask):
    """K4: every rule of the ``[R]`` table on every publish of ``feats``
    ``[B, S]`` float32 and ``cmask`` ``[B, W]`` (u32 bits in int32) ->
    ``[B, R/32]`` packed pass bits (u32 in int32). ``R`` is a multiple
    of 32."""
    device = _cuda_device(feats)
    for name, t in (("op", op), ("slot", slot), ("cbit", cbit)):
        _check(t, name, device, 1)
    _check(thresh, "thresh", device, 1, torch.float32)
    _check(feats, "feats", device, 2, torch.float32)
    _check(cmask, "cmask", device, 2)
    R = op.shape[0]
    B, S = feats.shape
    W = cmask.shape[1]
    if slot.shape[0] != R or thresh.shape[0] != R or cbit.shape[0] != R:
        raise ValueError("rule arrays must share one length")
    if R < 32 or R % 32:
        raise ValueError(f"the rule count must be a positive multiple of 32, got {R}")
    if S < 1 or W < 1 or cmask.shape[0] != B:
        raise ValueError(f"feats [B, S>=1] and cmask [B, W>=1] must agree, got {tuple(feats.shape)}, "
                         f"{tuple(cmask.shape)}")
    out = torch.empty((B, R // 32), dtype=torch.int32, device=device)
    if B == 0:
        return out
    lib = library("predicates.cu")
    err = lib.pk_rules_eval(
        op.data_ptr(), slot.data_ptr(), thresh.data_ptr(), cbit.data_ptr(), R,
        feats.data_ptr(), S, cmask.data_ptr(), W, B, out.data_ptr(), _stream(device),
    )
    _launched("predicates.cu", err, "rules_eval")
    return out


@_watched("predicates.cu", sig=_windows_sig)
def agg_reduce(buf, W: int):
    """K5: the ``W`` ragged windows of ``buf`` (int32 ``[3W + 1 + n]``:
    offsets ``[W+1]``, nondecreasing from 0 to ``n``, ops ``[W]``, counts
    ``[W]``, then the ``n`` samples as float32 bits) -> the ``[W]`` float32
    aggregates."""
    device = _cuda_device(buf)
    _check(buf, "buf", device, 1)
    if W < 0 or buf.shape[0] < 3 * W + 1:
        raise ValueError(f"agg_reduce takes a buffer of at least 3W + 1 ints, got {buf.shape[0]} for W={W}")
    n = buf.shape[0] - (3 * W + 1)
    if n >= 1 << 31:
        raise ValueError("agg_reduce: too many samples for int32 offsets")
    out = torch.empty((W,), dtype=torch.float32, device=device)
    if W == 0:
        return out
    lib = library("predicates.cu")
    err = lib.pk_agg_reduce(buf.data_ptr(), W, n, out.data_ptr(), _stream(device))
    _launched("predicates.cu", err, "agg_reduce")
    return out


@_watched("recrypt.cu")
def keystream(key_table, kidx, counters):
    """K6: AES-128 of ``counters [N, 16]`` uint8 under the round keys
    ``key_table [T, 11, 16]`` uint8 picked by ``kidx [N]`` int32 ->
    ``[N, 16]`` uint8 keystream."""
    device = _cuda_device(counters)
    _check(key_table, "key_table", device, 3, torch.uint8)
    _check(kidx, "kidx", device, 1)
    _check(counters, "counters", device, 2, torch.uint8)
    T = key_table.shape[0]
    N = kidx.shape[0]
    if key_table.shape[1:] != (11, 16) or T < 1:
        raise ValueError(f"key_table must be [T>=1, 11, 16], got {tuple(key_table.shape)}")
    if counters.shape != (N, 16):
        raise ValueError(f"counters must be [N, 16], got {tuple(counters.shape)}")
    if key_table.data_ptr() % 16 or counters.data_ptr() % 16:
        raise ValueError("key_table and counters must be 16-byte aligned")
    out = torch.empty((N, 16), dtype=torch.uint8, device=device)
    if N == 0:
        return out
    lib = library("recrypt.cu")
    err = lib.rc_keystream(
        key_table.data_ptr(), T, kidx.data_ptr(), counters.data_ptr(), N, out.data_ptr(),
        0, _stream(device),
    )
    _launched("recrypt.cu", err, "keystream")
    return out


def _match_slots(tables, pat_kind, pat_depth, pat_mask, tokens, max_levels: int,
                 overflow_slots: int, out, totals, overflow, *names: str) -> None:
    """Launch K7's kernel once over the ``T`` tiles and ``S`` shards of
    ``tables [S, NB, 16]`` (patterns ``[S, P]``): tokens ``[T*bl, 2L+2]``
    into ``out [T, S, bl, K]``, ``totals [T, S, bl]`` and ``overflow [T, S,
    bl]`` bool. Outputs ``[S, B, K]``, ``[S, B]``, ``[S, B]`` are one tile."""
    device = _cuda_device(tokens)
    _check(tables, "tables", device, 3)
    S, NB = tables.shape[0], tables.shape[1]
    if tables.shape[2] != 16 or S < 1 or NB < 1 or NB & (NB - 1) or NB >= 1 << 31:
        raise ValueError(f"tables must be [S, NB, 16] with NB a power of two, got {tuple(tables.shape)}")
    if tables.data_ptr() % 16:
        raise ValueError("tables must be 16-byte aligned")
    for name, t in (("pat_kind", pat_kind), ("pat_depth", pat_depth), ("pat_mask", pat_mask)):
        _check(t, name, device, 2)
    P = pat_depth.shape[1]
    if any(t.shape != (S, P) for t in (pat_kind, pat_depth, pat_mask)) or P < 1:
        raise ValueError("pattern arrays must be [S, P >= 1], one row per shard")
    B, W = _check_tokens(tokens, device, max_levels)
    ndim = 3 if isinstance(out, torch.Tensor) and out.dim() == 3 else 4
    _check(out, "out", device, ndim)
    _check(totals, "totals", device, ndim - 1)
    _check(overflow, "overflow", device, ndim - 1, torch.bool)
    T, S_out, bl, K = (1, *out.shape) if ndim == 3 else out.shape
    rows = (S, bl) if ndim == 3 else (T, S, bl)
    if S_out != S or T * bl != B or totals.shape != rows or overflow.shape != rows or K < 1:
        raise ValueError(f"outputs must be [T, S, bl, K>=1], [T, S, bl], [T, S, bl] (or [S, B, K], [S, B], "
                         f"[S, B]) with S={S}, T*bl={B}, got {tuple(out.shape)}, {tuple(totals.shape)}, "
                         f"{tuple(overflow.shape)}")
    if T * S * bl * K >= 1 << 31 or T * S > 65535:
        raise ValueError("slot buffer too large for int32 offsets or the launch grid")
    if B == 0:
        return
    lib = library("sharded.cu")
    err = lib.sh_match_slots(
        tokens.data_ptr(), T, bl, W, max_levels, tables.data_ptr(), S, NB,
        pat_kind.data_ptr(), pat_depth.data_ptr(), pat_mask.data_ptr(), P, K,
        overflow_slots, out.data_ptr(), totals.data_ptr(), overflow.data_ptr(),
        _stream(device),
    )
    _launched("sharded.cu", err, *names)


@_watched("sharded.cu")
def flat_match_slots(table, pat_kind, pat_depth, pat_mask, tokens, max_levels: int,
                     out_slots: int, overflow_slots: int = 0):
    """K7: ``[B, 2L+2]`` packed tokens against one index -> ``(sub_ids
    [B, out_slots] int32 -1-padded, totals [B] int32, overflow [B] bool)``."""
    device = _cuda_device(tokens)
    _check_index(table, pat_kind, pat_depth, pat_mask, device)
    B, _ = _check_tokens(tokens, device, max_levels)
    out = torch.empty((1, B, out_slots), dtype=torch.int32, device=device)
    totals = torch.empty((1, B), dtype=torch.int32, device=device)
    overflow = torch.empty((1, B), dtype=torch.bool, device=device)
    _match_slots(
        table[None], pat_kind[None], pat_depth[None], pat_mask[None], tokens, max_levels,
        overflow_slots, out, totals, overflow, "flat_match_slots",
    )
    return out[0], totals[0], overflow[0]


@_watched("sharded.cu")
def sharded_match_slots(tables, pat_kind, pat_depth, pat_mask, tokens, max_levels: int,
                        out, totals, overflow) -> None:
    """K8: ``T`` batch tiles (``tokens [T*bl, 2L+2]``) against every shard
    of a stacked index, in one launch, written straight into the gathered
    ``out [T, S, bl, K]``, ``totals [T, S, bl]`` and ``overflow [T, S,
    bl]`` (views the caller allocated; 3-D views are one tile). The same
    kernel as K7 with tile and shard dimensions in its grid; a launch counts
    for K8 only."""
    _match_slots(
        tables, pat_kind, pat_depth, pat_mask, tokens, max_levels, 0,
        out, totals, overflow, "sharded_step",
    )


@_watched("sharded.cu")
def tile_compact(out, totals, overflow, cap_local: int):
    """K9: ``T`` gathered tiles ``out [T, S, bl, K]``, ``totals [T, S, bl]``
    int32, ``overflow [T, S, bl]`` bool -> ``rows [T, 2 + 2*bl +
    2*cap_local]`` int32, one compacted ``(shard, sid)`` pair stream per
    tile, in one launch."""
    device = _cuda_device(out)
    _check(out, "out", device, 4)
    _check(totals, "totals", device, 3)
    _check(overflow, "overflow", device, 3, torch.bool)
    T, S, bl, K = out.shape
    if totals.shape != (T, S, bl) or overflow.shape != (T, S, bl):
        raise ValueError(f"totals and overflow must be [T, S, bl] = {(T, S, bl)}, "
                         f"got {tuple(totals.shape)}, {tuple(overflow.shape)}")
    if S < 1 or bl < 1 or K < 1 or cap_local < 1:
        raise ValueError(f"tile_compact needs S, bl, K, cap_local >= 1 (got {S}, {bl}, {K}, {cap_local})")
    row_w = 2 + 2 * bl + 2 * cap_local
    if T * S * bl * K >= 1 << 31 or T * row_w >= 1 << 31 or T > 65535:
        raise ValueError("tiles too large for int32 offsets or the launch grid")
    rows = torch.empty((T, row_w), dtype=torch.int32, device=device)
    if T == 0:
        return rows
    lib = library("sharded.cu")
    stream = _stream(device)
    with _scratch_launch_lock:
        scratch, tiles_cap, epoch = _tile_scratch_for(lib, device, stream, T, S, bl)
        err = lib.sh_tile_compact(
            out.data_ptr(), totals.data_ptr(), overflow.data_ptr(), T, S, bl, K, cap_local,
            rows.data_ptr(), scratch.data_ptr(), tiles_cap, epoch, stream,
        )
    _launched("sharded.cu", err, "tile_compact")
    return rows
