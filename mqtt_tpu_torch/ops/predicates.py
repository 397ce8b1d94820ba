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
per fan-out tick (``agg_reduce``, K5).

Each entry point takes CPU tensors through its plain PyTorch version and
CUDA tensors through its kernel; nothing falls back from one to the
other. Shapes are padded as the JAX package pads them (rules to a power
of two of at least 32, batches to a power of two of at least 16, windows
to powers of two), so the packed rows, pad bits included, equal JAX's.

Bit patterns of u32 words travel in int32 tensors: PyTorch on the CPU has
no shifts for ``uint32``, so the plain versions compute in int64 masked
to 32 bits.
"""

from __future__ import annotations

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


def agg_reduce_plain(vals, ops, counts):
    """The plain version of K5 (``agg_reduce_core``): MEAN/MAX/MIN of
    ``W`` NaN-padded windows. The mean divides the live sum by
    ``max(counts, 1)``."""
    live = ~torch.isnan(vals)
    s = torch.where(live, vals, torch.zeros_like(vals)).sum(dim=1)
    mean = s / torch.clamp(counts.to(torch.float32), min=1.0)
    mx = torch.where(live, vals, torch.full_like(vals, float("-inf"))).amax(dim=1)
    mn = torch.where(live, vals, torch.full_like(vals, float("inf"))).amin(dim=1)
    return torch.where(ops == OP_MEAN, mean, torch.where(ops == OP_MAX, mx, mn))


def agg_reduce(vals, ops, counts):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if vals.device.type == "cpu":
        return agg_reduce_plain(vals, ops, counts)
    return kernels.agg_reduce(vals, ops, counts)


def agg_reduce_batch(pending: list, device="cuda") -> np.ndarray:
    """One window-reduction launch for ``pending``, a list of
    ``(op_code, values)`` with non-empty ``values``: float32
    ``[len(pending)]`` aggregates. Windows pad to a power of two of at
    least 2, samples to one of at least 8, as in the JAX package."""
    device = resolve_device(device)
    w = len(pending)
    n = max(len(values) for _op, values in pending)
    wp = _bucket(max(1, w), minimum=2)
    np_ = _bucket(max(1, n), minimum=8)
    vals = np.full((wp, np_), np.nan, dtype=np.float32)
    ops = np.zeros(wp, dtype=np.int32)
    counts = np.ones(wp, dtype=np.int32)
    for i, (op, values) in enumerate(pending):
        vals[i, : len(values)] = np.asarray(values, dtype=np.float32)
        ops[i] = op
        counts[i] = len(values)
    out = agg_reduce(
        torch.from_numpy(vals).to(device), torch.from_numpy(ops).to(device),
        torch.from_numpy(counts).to(device),
    )
    return out.cpu().numpy()[:w]


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
        start.record()
        host.copy_(rows_dev, non_blocking=True)
        done.record()
        # the table, the inputs and the device rows stay referenced until
        # the batch resolves
        in_flight = (table, f_dev, m_dev, rows_dev)

        def resolve() -> np.ndarray:
            done.synchronize()
            assert in_flight
            self.d2h_log.append((host.numel() * 4, start.elapsed_time(done)))
            return host.numpy().view(np.uint32)[:B]

        return resolve
