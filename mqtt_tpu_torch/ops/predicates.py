"""The device half of MQTT+ payload predicates: the rule table and the
window reduction.

The host (``mqtt_tpu_torch.predicates``) compiles the live predicate set
into a RULE TABLE — parallel ``[R]`` arrays of op code, feature slot,
float32 threshold and contains-bit — resident on the card. Per staged
batch the stage ships the publishes' feature matrix (float32 ``[B, S]``
field values, NaN = absent, and a ``[B, W]`` bitmask of the interned
substrings and string equalities) and ONE kernel evaluates every rule on
every publish, packing the verdicts 32 to a word (``rules_eval``, K4 in
``csrc/predicates.cu``). Large aggregation windows reduce in one launch
per fan-out tick (``agg_reduce``, K5), over the tick's windows laid out
ragged in one int32 buffer (``pack_windows``) that crosses to the card in
one copy from pinned memory, the aggregates coming back in one copy.

Each entry point takes CPU tensors through its plain PyTorch version and
CUDA tensors through its kernel; nothing falls back from one to the
other. Shapes are padded as the JAX package pads them (rules to a power
of two of at least 32, batches to a power of two of at least 16), so the
packed rows, pad bits included, equal JAX's. Aggregation windows are not
padded: the JAX package pads them with NaN to powers of two for its jit's
static shapes, and the ragged layout gives the same aggregates.

Bit patterns of u32 words travel in int32 tensors: PyTorch on the CPU has
no shifts for ``uint32``, so the plain versions compute in int64 masked
to 32 bits.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from . import kernels
from .flat import _bucket, resolve_device

# op codes: the shared vocabulary with mqtt_tpu_torch.predicates and
# csrc/predicates.cu
OP_NONE = 0
OP_GT = 1
OP_GTE = 2
OP_LT = 3
OP_LTE = 4
OP_EQ = 5
OP_NE = 6
OP_CONTAINS = 7
# aggregation ops: host-stateful windows whose reduction runs on the card
# for large windows (agg_reduce)
OP_MEAN = 8
OP_MAX = 9
OP_MIN = 10
# string equality: rides the host-computed bitmask like CONTAINS
OP_EQS = 11
# compounds never reach the table: their children do, and the host
# combines the child bits
OP_AND = 12
OP_OR = 13

_U32 = 0xFFFFFFFF


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


def rules_eval_plain(op, slot, thresh, cbit, feats, cmask):
    """The plain version of K4 (``rules_eval_core``): packed pass bits
    ``[B, R/32]`` (u32 bits in int32)."""
    B, S = feats.shape
    R = op.shape[0]
    W = cmask.shape[1]
    f = feats[:, slot.clamp(0, S - 1).long()]  # [B, R]
    t = thresh[None, :]
    o = op[None, :]
    res = f != t  # OP_NE and the OP_NONE pad rows
    for code, hit in ((OP_GT, f > t), (OP_GTE, f >= t), (OP_LT, f < t),
                      (OP_LTE, f <= t), (OP_EQ, f == t)):
        res = torch.where(o == code, hit, res)
    res = res | torch.isnan(f)  # skip-to-pass
    cb = cbit.clamp(min=0).long()
    word_i = cb >> 5
    words = cmask.long() & _U32  # [B, W]
    # jnp.take's fill mode: a word past the mask reads as all ones
    cword = torch.where(word_i < W, words[:, word_i.clamp(max=W - 1)], torch.full_like(words[:, :1], _U32))
    cpass = ((cword >> (cb & 31)) & 1) != 0
    bitop = (o == OP_CONTAINS) | (o == OP_EQS)
    res = torch.where(bitop, cpass, res)
    bits = res.long().reshape(B, R // 32, 32)
    weights = torch.ones(32, dtype=torch.int64, device=feats.device) << torch.arange(32, device=feats.device)
    return _as_int32_bits((bits * weights).sum(dim=2))


def rules_eval(op, slot, thresh, cbit, feats, cmask):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if feats.device.type == "cpu":
        return rules_eval_plain(op, slot, thresh, cbit, feats, cmask)
    return kernels.rules_eval(op, slot, thresh, cbit, feats, cmask)


def pack_windows(windows, ops, counts=None, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The ragged layout K5 reads, as one int32 array of ``3W + 1 + n``:
    offsets ``[W+1]`` (window ``w``'s samples are ``offsets[w]`` up to
    ``offsets[w+1]``), ``ops [W]``, ``counts [W]`` (each window's sample
    count unless given: the mean's divisor), then the ``n`` samples of all
    windows in order as float32 bits. ``windows`` is a sequence of sample
    sequences (NaN samples are skipped by the reduction but count).
    Written into ``out[:3W + 1 + n]`` where given (a pinned staging view),
    else into a new array."""
    W = len(windows)
    lengths = np.fromiter((len(v) for v in windows), dtype=np.int64, count=W)
    n = int(lengths.sum())
    size = 3 * W + 1 + n
    buf = np.empty(size, dtype=np.int32) if out is None else out[:size]
    buf[0] = 0
    buf[1 : W + 1] = np.cumsum(lengths)
    buf[W + 1 : 2 * W + 1] = ops
    buf[2 * W + 1 : 3 * W + 1] = lengths if counts is None else counts
    buf[3 * W + 1 :].view(np.float32)[:] = np.fromiter(
        itertools.chain.from_iterable(windows), dtype=np.float32, count=n
    )
    return buf


def agg_reduce_plain(buf, W: int):
    """The plain version of K5 (``agg_reduce_core``) on the ragged layout
    (``pack_windows``; offsets nondecreasing from 0): MEAN/MAX/MIN of the
    ``W`` windows. It lays the windows out NaN-padded, as the JAX package
    does, and reduces them as ``agg_reduce_core`` does: the mean divides
    the live sum by ``max(counts, 1)``."""
    off = buf[: W + 1].to(torch.int64)
    ops = buf[W + 1 : 2 * W + 1]
    counts = buf[2 * W + 1 : 3 * W + 1]
    samples = buf[3 * W + 1 :].view(torch.float32)
    lengths = off[1:] - off[:-1]
    N = max(1, int(lengths.max())) if W else 1
    seg = torch.repeat_interleave(torch.arange(W, device=buf.device), lengths)
    pos = torch.arange(seg.shape[0], device=buf.device) + off[0]
    vals = torch.full((W, N), float("nan"), dtype=torch.float32, device=buf.device)
    vals[seg, pos - off[seg]] = samples[pos]
    live = ~torch.isnan(vals)
    s = torch.where(live, vals, torch.zeros_like(vals)).sum(dim=1)
    mean = s / torch.clamp(counts.to(torch.float32), min=1.0)
    mx = torch.where(live, vals, torch.full_like(vals, float("-inf"))).amax(dim=1)
    mn = torch.where(live, vals, torch.full_like(vals, float("inf"))).amin(dim=1)
    return torch.where(ops == OP_MEAN, mean, torch.where(ops == OP_MAX, mx, mn))


def agg_reduce(buf, W: int):
    """K5 on a CUDA buffer, its plain version on a CPU one."""
    if buf.device.type == "cpu":
        return agg_reduce_plain(buf, W)
    return kernels.agg_reduce(buf, W)


class _AggStaging:
    """The pinned host buffers one card's window reductions cross through,
    each grown by doubling. A tick holds ``lock`` from filling the input
    until it has read the output back, so ticks from several threads take
    turns and a buffer is never refilled under a copy in flight."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.host_in = torch.empty((0,), dtype=torch.int32)
        self.host_out = torch.empty((0,), dtype=torch.float32)
        self.done: Optional[torch.cuda.Event] = None

    @staticmethod
    def grown(t: torch.Tensor, n: int) -> torch.Tensor:
        if t.numel() >= n:
            return t
        return torch.empty((max(n, 2 * t.numel(), 1024),), dtype=t.dtype, pin_memory=True)


_agg_staging: dict = {}
_agg_staging_lock = threading.Lock()


def _staging_for(device: torch.device) -> _AggStaging:
    key = device.index if device.index is not None else torch.cuda.current_device()
    with _agg_staging_lock:
        st = _agg_staging.get(key)
        if st is None:
            st = _agg_staging[key] = _AggStaging()
        return st


def agg_reduce_batch(pending: list, device="cuda") -> np.ndarray:
    """One window-reduction launch for ``pending``, a list of
    ``(op_code, values)`` with non-empty ``values``: float32
    ``[len(pending)]`` aggregates. On a card: the ragged buffer
    (``pack_windows``) is written into this card's pinned staging buffer,
    crosses in one ``non_blocking`` copy, K5 reduces it, and the
    aggregates come back in one ``non_blocking`` copy into a pinned output
    behind one event wait."""
    device = resolve_device(device)
    W = len(pending)
    ops = np.fromiter((op for op, _values in pending), dtype=np.int32, count=W)
    windows = [values for _op, values in pending]
    if device.type == "cpu":
        return agg_reduce(torch.from_numpy(pack_windows(windows, ops)), W).numpy()
    st = _staging_for(device)
    with st.lock:
        size = 3 * W + 1 + sum(len(v) for v in windows)
        st.host_in = st.grown(st.host_in, size)
        st.host_out = st.grown(st.host_out, W)
        pack_windows(windows, ops, out=st.host_in.numpy())
        buf = st.host_in[:size].to(device, non_blocking=True)
        out = st.host_out[:W]
        out.copy_(agg_reduce(buf, W), non_blocking=True)
        if st.done is None:
            st.done = torch.cuda.Event()
        st.done.record(torch.cuda.current_stream(device))
        st.done.synchronize()
        return out.numpy().copy()


class RuleTable:
    """One compiled, device-resident rule table (immutable once built):
    a batch issued against it keeps it alive until it resolves, so a
    rebuild never pulls the table from under a batch in flight."""

    __slots__ = ("arrays", "n_rules", "n_slots", "n_cwords")

    def __init__(self, arrays: tuple, n_rules: int, n_slots: int, n_cwords: int) -> None:
        self.arrays = arrays  # (op, slot, thresh, cbit), each [R_padded]
        self.n_rules = n_rules
        self.n_slots = n_slots
        self.n_cwords = n_cwords


class DeviceRuleEvaluator:
    """The device-resident predicate rule table and its batched
    evaluation.

    ``rebuild`` compiles a rule list into padded device arrays (rule order
    is the dense index the host decodes pass bits with); ``eval_async``
    issues one batch and returns a zero-arg resolver that waits for the
    D2H copy of the packed rows. The stage runs that resolver in the same
    executor call as the topic match's."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.table: Optional[RuleTable] = None
        # per resolved batch on the card: (bytes, ms) of the rows' D2H copy,
        # from CUDA events around it
        self.d2h_log: deque = deque(maxlen=4096)

    @property
    def n_rules(self) -> int:
        return 0 if self.table is None else self.table.n_rules

    def rebuild(self, specs: list, slots: list, cbits: list, n_slots: int, n_cwords: int) -> None:
        """Compile the rule table to device arrays. ``specs`` are
        ``PredicateSpec`` (non-aggregation ops only); ``slots``/``cbits``
        the per-rule feature slot and contains bit. The new table
        replaces the old one; batches in flight keep the old one."""
        R = len(specs)
        if R == 0:
            self.table = None
            return
        # pad to a power of two (at least 32): pad rows are OP_NONE
        pad = max(32, _bucket(R, minimum=32))
        op = np.zeros(pad, dtype=np.int32)
        slot = np.zeros(pad, dtype=np.int32)
        thresh = np.zeros(pad, dtype=np.float32)
        cbit = np.zeros(pad, dtype=np.int32)
        for i, spec in enumerate(specs):
            op[i] = spec.op
            slot[i] = max(0, slots[i])
            thresh[i] = np.float32(spec.value)
            cbit[i] = max(0, cbits[i])
        arrays = tuple(torch.from_numpy(a).to(self.device) for a in (op, slot, thresh, cbit))
        self.table = RuleTable(arrays, R, max(1, n_slots), max(1, n_cwords))

    def eval_async(self, feats: np.ndarray, cmask: np.ndarray, table: Optional[RuleTable] = None) -> Callable:
        """Issue one evaluation batch against ``table`` (default: the
        current one): ``feats`` float32 ``[B, S]``, ``cmask`` uint32
        ``[B, W]``. Returns the resolver yielding uint32
        ``[B, R_padded/32]`` pass-bit rows."""
        table = table if table is not None else self.table
        if table is None:
            raise ValueError("the evaluator has no compiled rules")
        B = feats.shape[0]
        pad_b = _bucket(max(1, B), minimum=16)
        f = np.zeros((pad_b, feats.shape[1]), dtype=np.float32)
        m = np.zeros((pad_b, cmask.shape[1]), dtype=np.uint32)
        f[:B] = feats
        m[:B] = cmask
        f_t = torch.from_numpy(f)
        m_t = torch.from_numpy(m.view(np.int32))
        if self.device.type == "cpu":
            rows = rules_eval(*table.arrays, f_t, m_t)

            def resolve_cpu() -> np.ndarray:
                return rows.numpy().view(np.uint32)[:B]

            return resolve_cpu
        f_dev = f_t.pin_memory().to(self.device, non_blocking=True)
        m_dev = m_t.pin_memory().to(self.device, non_blocking=True)
        rows_dev = rules_eval(*table.arrays, f_dev, m_dev)
        # the rows come back into a pinned buffer of this batch's own,
        # behind an event the resolver waits on
        host = torch.empty(rows_dev.shape, dtype=torch.int32, pin_memory=True)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(self.device)
        start.record(stream)
        host.copy_(rows_dev, non_blocking=True)
        done.record(stream)
        # the table, the inputs and the device rows stay referenced until
        # the batch resolves
        in_flight = (table, f_dev, m_dev, rows_dev)

        def resolve() -> np.ndarray:
            done.synchronize()
            assert in_flight
            self.d2h_log.append((host.numel() * 4, start.elapsed_time(done)))
            return host.numpy().view(np.uint32)[:B]

        return resolve
