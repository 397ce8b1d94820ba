"""The device pipeline profiler: per-batch dispatch and D2H windows
folded into duty cycle, overlap and idle-gap aggregates, per card.

A copy of the JAX package's ``mqtt_tpu/tracing.py`` device profiler
(``BatchProfile``, ``BYTE_BOUNDS``, ``_DevWindow``, ``DeviceProfiler``),
with the same arithmetic operation for operation, so the same stamps
give the same floats. The matchers stamp each batch: the issue leg runs
from before tokenizing to after the launch and the asynchronous D2H copy
are queued; the device window closes when the resolver's wait on that
copy returns (``torch.cuda.Event.synchronize`` and the read of the
pinned buffer), so the window holds the kernel and the transfer. A
device id is the card's CUDA index (0 for the host).

Not ported here: the sampled span trees and their export (the JAX
package's ``Tracer``, ``PublishTrace``, ``check_trace_events``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from .telemetry import Histogram


class BatchProfile:
    """One batch's device-timing record, created at issue and carried
    WITH the batch (the resolver closure and the staging queue both hold
    it), so profile boundaries can never be attributed to a different
    batch — the stage resolves batches on executor threads, so no
    "most recent resolve" pairing could hold. Tuple assignments are
    atomic under the GIL; a reader sees either None or a complete
    window."""

    __slots__ = (
        "dispatch", "d2h", "d2h_bytes", "d2h_bytes_ranges",
        "d2h_bytes_dense", "compact", "compact_overflow", "devices",
    )

    def __init__(self) -> None:
        # (start, end) of the tokenize+dispatch issue leg; None until
        # the batch actually dispatched to the device (the exact-map
        # fast path and host fallbacks never set it)
        self.dispatch: Optional[tuple[float, float]] = None
        # (start, end) of the blocking D2H result sync
        self.d2h: Optional[tuple[float, float]] = None
        # transfer accounting: the actual D2H result bytes this batch moved, beside the bytes the
        # pre-compaction geometries would have moved — ranges = the
        # packed [B, 2P+2] form, dense = the padded [B, max_hits] slot
        # buffer. 0 = the matcher did not stamp this batch.
        self.d2h_bytes = 0
        self.d2h_bytes_ranges = 0
        self.d2h_bytes_dense = 0
        # True when the result came back as compacted (topic, sid) pairs;
        # compact_overflow marks the per-batch padded-path fallback
        self.compact = False
        self.compact_overflow = False
        # device ids this batch's window ran on, stamped by the matcher
        # at dispatch (TorchMatcher: the output buffer's card; sharded:
        # every card of the mesh). None = unstamped, folds as device 0.
        self.devices: Optional[tuple] = None


# D2H transfer sizes: single compact rows (~tens of bytes) up to the
# dense padded geometries (tens of MB)
BYTE_BOUNDS = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
    1048576.0, 4194304.0, 16777216.0, 67108864.0,
)


class _DevWindow:
    """One device's replica of the profiler's busy/overlap/idle fold:
    same arithmetic, keyed by device id, so a single-card run's window 0
    is bit-identical to the unlabeled aggregates and a mesh over several
    cards gets one window per card."""

    __slots__ = (
        "first_t", "last_t", "busy_until", "busy_s", "window_s",
        "overlap_s", "batches", "d2h_bytes_total",
        "issue_hist", "d2h_hist", "idle_hist", "bytes_hist",
    )

    def __init__(self) -> None:
        self.first_t: Optional[float] = None
        self.last_t = 0.0
        self.busy_until = 0.0
        self.busy_s = 0.0
        self.window_s = 0.0
        self.overlap_s = 0.0
        self.batches = 0
        self.d2h_bytes_total = 0
        self.issue_hist = Histogram()
        self.d2h_hist = Histogram()
        self.idle_hist = Histogram()
        self.bytes_hist = Histogram(bounds=BYTE_BOUNDS)

    def duty_cycle(self) -> float:
        if self.first_t is None or self.last_t <= self.first_t:
            return 0.0
        return self.busy_s / (self.last_t - self.first_t)

    def overlap_ratio(self) -> float:
        return self.overlap_s / self.window_s if self.window_s > 0 else 0.0


class DeviceProfiler:
    """Host-side device pipeline profiler: each batch's dispatch and
    D2H windows land on its own :class:`BatchProfile` record and fold
    into duty-cycle / overlap / idle-gap aggregates.

    A batch's **device window** runs from dispatch-return (the kernel is
    queued and the host moves on) to the end of the blocking D2H sync —
    kernel execution plus result transfer, the best host-observable
    proxy without a device-side profiler (``torch.profiler`` gives the
    card's own timeline). Aggregates:

    - ``duty_cycle`` = union of device windows / wall time since the
      first dispatch — how busy the device actually is.
    - ``overlap_ratio`` = overlapped window time / summed window time —
      how deep the staging pipeline actually runs (0 = strictly serial,
      approaching (depth-1)/depth for a depth-N pipeline).
    - ``idle_gap`` histogram = device-idle stretches between windows —
      exactly the gaps a 3-deep pipeline must close.

    Dispatches and resolves may come from different threads (the
    stage issues on its dispatch thread; resolves run in an executor);
    everything mutates under one lock, held for arithmetic only."""

    def __init__(self, registry: Any = None) -> None:
        self._lock = threading.Lock()
        self._registry = registry
        # per-device window replicas, keyed by device id;
        # mutated under _lock, child registration happens outside it
        self._dev: dict[int, _DevWindow] = {}
        self.batches = 0
        self._first_t: Optional[float] = None
        self._last_t = 0.0
        self._busy_until = 0.0
        self._busy_s = 0.0  # union of device windows
        self._window_s = 0.0  # sum of device windows
        self._overlap_s = 0.0
        # device-resident compaction accounting: bytes
        # actually transferred vs the pre-compaction geometries, and the
        # compacted-batch / overflow-fallback split — stamped per batch
        # on its BatchProfile by the matcher
        self.compact_batches = 0
        self.compact_overflows = 0
        self.d2h_bytes_total = 0
        self.d2h_bytes_ranges_total = 0
        self.d2h_bytes_dense_total = 0
        self._bytes_batches = 0  # batches that stamped transfer bytes
        if registry is not None:
            self.issue_hist = registry.histogram(
                "mqtt_tpu_device_issue_seconds",
                "Per-batch host tokenize + device dispatch (H2D issue) wall time",
            )
            self.d2h_hist = registry.histogram(
                "mqtt_tpu_device_d2h_seconds",
                "Per-batch blocking D2H result-sync wall time",
            )
            self.idle_gap_hist = registry.histogram(
                "mqtt_tpu_device_idle_gap_seconds",
                "Device-idle stretches between consecutive batch windows",
            )
            self.compact_d2h_hist = registry.histogram(
                "mqtt_tpu_device_compact_d2h_seconds",
                "Blocking D2H sync wall time of compacted-result batches "
                "(the compaction d2h leg)",
            )
            registry.gauge(
                "mqtt_tpu_device_duty_cycle_ratio",
                "Union of device-busy windows over wall time since first dispatch",
                fn=self.duty_cycle,
            )
            registry.gauge(
                "mqtt_tpu_device_overlap_ratio",
                "Overlapped device-window time over summed window time "
                "(pipeline depth proxy)",
                fn=self.overlap_ratio,
            )
        else:
            self.issue_hist = Histogram()
            self.d2h_hist = Histogram()
            self.idle_gap_hist = Histogram()
            self.compact_d2h_hist = Histogram()

    # -- recording (matcher hooks) -----------------------------------------

    def open_batch(self) -> BatchProfile:
        """A fresh per-batch record; the matcher fills it and whoever
        holds the batch (the stage) reads it."""
        return BatchProfile()

    def ensure_device(self, did: int) -> _DevWindow:
        """The window replica for one device id, creating it (and its
        ``device``-labeled metric children) on first sight. Idempotent;
        registration runs outside the fold lock."""
        with self._lock:
            dw = self._dev.get(did)
        if dw is not None:
            return dw
        dw = _DevWindow()
        with self._lock:
            have = self._dev.setdefault(did, dw)
        if have is not dw:
            return have  # lost the race: the winner registered children
        reg = self._registry
        if reg is not None:
            dev = str(did)
            reg.histogram(
                "mqtt_tpu_device_issue_seconds",
                fn=lambda d=dw: d.issue_hist, device=dev,
            )
            reg.histogram(
                "mqtt_tpu_device_d2h_seconds",
                fn=lambda d=dw: d.d2h_hist, device=dev,
            )
            reg.histogram(
                "mqtt_tpu_device_idle_gap_seconds",
                fn=lambda d=dw: d.idle_hist, device=dev,
            )
            reg.histogram(
                "mqtt_tpu_device_d2h_bytes",
                "Per-batch D2H result bytes attributed to each device "
                "(even split across a sharded batch's mesh)",
                bounds=BYTE_BOUNDS,
                fn=lambda d=dw: d.bytes_hist, device=dev,
            )
            reg.gauge(
                "mqtt_tpu_device_duty_cycle_ratio",
                fn=lambda d=dw: d.duty_cycle(), device=dev,
            )
            reg.gauge(
                "mqtt_tpu_device_overlap_ratio",
                fn=lambda d=dw: d.overlap_ratio(), device=dev,
            )
        return dw

    def note_dispatch(self, rec: BatchProfile, t0: float, t1: float) -> None:
        """One batch issued: tokenize + device dispatch ran [t0, t1];
        the device window opens at t1."""
        rec.dispatch = (t0, t1)
        self.issue_hist.observe(t1 - t0)
        for did in rec.devices or (0,):
            self.ensure_device(did).issue_hist.observe(t1 - t0)

    def note_resolve(self, rec: BatchProfile, sync_start: float, sync_end: float) -> None:
        """One batch's blocking D2H sync ran [sync_start, sync_end];
        fold its device window (dispatch-return -> sync end) into the
        busy/overlap/idle accounting. Pairing is exact — the window
        boundaries live on the batch's own record."""
        rec.d2h = (sync_start, sync_end)
        self.d2h_hist.observe(sync_end - sync_start)
        if getattr(rec, "compact", False):
            self.compact_d2h_hist.observe(sync_end - sync_start)
        if rec.dispatch is None:
            return  # never dispatched (shouldn't happen): histogram only
        t_disp = rec.dispatch[1]
        devs = rec.devices or (0,)
        windows = [self.ensure_device(d) for d in devs]
        # transfer bytes attribute evenly across a sharded batch's mesh
        # (each chip moved ~1/n of the result) — exact for one device
        per_dev_bytes = getattr(rec, "d2h_bytes", 0) // len(devs)
        with self._lock:
            if getattr(rec, "d2h_bytes", 0):
                self._bytes_batches += 1
                self.d2h_bytes_total += rec.d2h_bytes
                self.d2h_bytes_ranges_total += rec.d2h_bytes_ranges
                self.d2h_bytes_dense_total += rec.d2h_bytes_dense
            if getattr(rec, "compact", False):
                if rec.compact_overflow:
                    self.compact_overflows += 1
                else:
                    self.compact_batches += 1
            end = max(sync_end, t_disp)
            self.batches += 1
            if self._first_t is None:
                self._first_t = t_disp
            self._last_t = max(self._last_t, end)
            self._window_s += end - t_disp
            if t_disp >= self._busy_until:
                if self._busy_until > 0.0:
                    self.idle_gap_hist.observe(t_disp - self._busy_until)
                self._busy_s += end - t_disp
            else:
                self._overlap_s += max(0.0, min(self._busy_until, end) - t_disp)
                self._busy_s += max(0.0, end - self._busy_until)
            self._busy_until = max(self._busy_until, end)
            # the same fold, replicated per participating device: a
            # single-device run's window 0 tracks the aggregates exactly
            for dw in windows:
                dw.batches += 1
                dw.d2h_hist.observe(sync_end - sync_start)
                if per_dev_bytes:
                    dw.bytes_hist.observe(per_dev_bytes)
                    dw.d2h_bytes_total += per_dev_bytes
                if dw.first_t is None:
                    dw.first_t = t_disp
                dw.last_t = max(dw.last_t, end)
                dw.window_s += end - t_disp
                if t_disp >= dw.busy_until:
                    if dw.busy_until > 0.0:
                        dw.idle_hist.observe(t_disp - dw.busy_until)
                    dw.busy_s += end - t_disp
                else:
                    dw.overlap_s += max(0.0, min(dw.busy_until, end) - t_disp)
                    dw.busy_s += max(0.0, end - dw.busy_until)
                dw.busy_until = max(dw.busy_until, end)

    # -- aggregates ---------------------------------------------------------

    def duty_cycle(self) -> float:
        with self._lock:
            if self._first_t is None or self._last_t <= self._first_t:
                return 0.0
            return self._busy_s / (self._last_t - self._first_t)

    def overlap_ratio(self) -> float:
        with self._lock:
            return self._overlap_s / self._window_s if self._window_s > 0 else 0.0

    def device_snapshot(self) -> dict:
        """Per-device window aggregates keyed by device id — what
        DeviceStatsPlane.snapshot() merges into the /devices body."""
        out: dict[int, dict] = {}
        with self._lock:
            for did, dw in sorted(self._dev.items()):
                out[did] = {
                    "duty_cycle": round(dw.duty_cycle(), 4),
                    "overlap_ratio": round(dw.overlap_ratio(), 4),
                    "batches": dw.batches,
                    "d2h_bytes_total": dw.d2h_bytes_total,
                    "issue_p99_ms": round(
                        dw.issue_hist.percentile(0.99) * 1e3, 3
                    ),
                    "d2h_p99_ms": round(dw.d2h_hist.percentile(0.99) * 1e3, 3),
                    "idle_gap_p99_ms": round(
                        dw.idle_hist.percentile(0.99) * 1e3, 3
                    ),
                }
        return out

    def bench_block(self) -> dict:
        """The device-pipeline block of a benchmark record: batches,
        duty cycle, overlap, the legs' p99s and the transfer ledger."""
        out = {
            "batches": self.batches,
            "duty_cycle": round(self.duty_cycle(), 4),
            "overlap_ratio": round(self.overlap_ratio(), 4),
            "issue_p99_ms": round(self.issue_hist.percentile(0.99) * 1e3, 3),
            "d2h_p99_ms": round(self.d2h_hist.percentile(0.99) * 1e3, 3),
            "idle_gap_p99_ms": round(
                self.idle_gap_hist.percentile(0.99) * 1e3, 3
            ),
            "idle_gap_count": self.idle_gap_hist.count,
        }
        with self._lock:
            nb = self._bytes_batches
            if nb:
                # the compaction transfer ledger: actual result bytes per batch beside the
                # pre-compaction geometries and the reduction they imply
                out["d2h_bytes_per_batch"] = round(self.d2h_bytes_total / nb)
                out["d2h_bytes_ranges_per_batch"] = round(
                    self.d2h_bytes_ranges_total / nb
                )
                out["d2h_bytes_padded_per_batch"] = round(
                    self.d2h_bytes_dense_total / nb
                )
                out["d2h_reduction_vs_padded"] = round(
                    self.d2h_bytes_dense_total / max(1, self.d2h_bytes_total), 2
                )
                out["d2h_reduction_vs_ranges"] = round(
                    self.d2h_bytes_ranges_total / max(1, self.d2h_bytes_total),
                    2,
                )
            out["compact_batches"] = self.compact_batches
            out["compact_overflows"] = self.compact_overflows
        if self.compact_d2h_hist.count:
            out["compact_d2h_p99_ms"] = round(
                self.compact_d2h_hist.percentile(0.99) * 1e3, 3
            )
        return out
