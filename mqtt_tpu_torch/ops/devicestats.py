"""Per-card observability: memory gauges, a first-launch ledger and
shard-skew instruments.

A copy of the JAX package's ``mqtt_tpu/ops/devicestats.py`` for the
port's device plane. Three cooperating pieces, all host-side (no
kernels):

* ``CompileLedger`` / ``KernelWatch`` — PyTorch runs eagerly and the
  port's kernels are built once, so there is no jit compile to note.
  The ledger notes instead the FIRST launch of each (kernel, signature):
  every CUDA wrapper in ``ops/kernels.py`` runs inside a ``KernelWatch``
  under its own name, and the sharded matcher watches its whole mesh
  step as the JAX package names it (``sharded_step``,
  ``sharded_tile_compact_c<cap>``). A watch times the first call on the
  host clock: what it notes is the host's enqueue of the launch (the
  argument checks, the ctypes call and ``cudaGetLastError``), not the
  kernel's run on the card, which it never waits for. The ``nvcc``
  build of each CUDA source and the ``cc`` build of each C source are
  noted at first use under their own names (``nvcc:<source>``,
  ``cc:<source>``), with their wall time. A note in steady state is a
  new shape reaching a kernel: ``mqtt_tpu_matcher_recompiles_total
  {kernel}`` counts them, under the JAX package's family names.

* ``DeviceStatsPlane`` — per-card memory gauges (live, peak and limit),
  the ``device_skew_ratio`` gauge and per-tile hit/fill families (fed by
  ``ShardedTorchMatcher``), and the JSON snapshot and ``$SYS`` rows. Live
  and peak are the caching allocator's ``allocated_bytes.all.current``
  and ``.peak`` (``torch.cuda.memory_stats``), the limit is the card's
  total memory (``torch.cuda.mem_get_info``). Every device tensor of the
  port is such an allocation: its kernels allocate nothing themselves.
  ``device="cuda"`` (the default) lists every visible card and raises
  when there is none; ``device="cpu"`` lists the host as device 0, which
  cannot answer memory queries and reports the JAX plane's sentinel
  (-1 on /metrics, ``null`` in JSON). Per-card duty/overlap/idle-gap
  windows live in ``tracing.DeviceProfiler``; the plane only reads them.

The ledger lock is ``device_stats``; it is a leaf — registry child
registration happens OUTSIDE it.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..telemetry import Histogram
from ..utils.locked import InstrumentedLock

# first-launch and build wall-times: tens of microseconds (a launch's
# enqueue) up to minute-scale builds
COMPILE_BOUNDS = (
    0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 60.0,
)

# one attribution ring, not per kernel: recent-first is what a failing
# steady-state assert wants to print
_EVENT_RING = 256

# memory gauge value when the device cannot answer (the host); /metrics
# carries the sentinel, JSON carries null
HBM_UNKNOWN = -1.0


def _sig_of(args: tuple, kwargs: dict) -> tuple:
    """The signature key for one call: tensor and array args by (shape,
    dtype, device), hashable non-array args by value — a NEW key is a new
    shape (or capacity, or device) reaching the kernel."""
    key: list = []
    for a in args:
        shp = getattr(a, "shape", None)
        if shp is not None:
            key.append((tuple(shp), getattr(a, "dtype", None), getattr(a, "device", None)))
        else:
            key.append(a if isinstance(a, (int, float, bool, str, type(None))) else type(a).__name__)
    for k in sorted(kwargs):
        v = kwargs[k]
        shp = getattr(v, "shape", None)
        if shp is not None:
            key.append((k, tuple(shp), getattr(v, "dtype", None), getattr(v, "device", None)))
        else:
            key.append((k, v if isinstance(v, (int, float, bool, str, type(None))) else type(v).__name__))
    return tuple(key)


def _shape_bucket(args: tuple, kwargs: dict) -> str:
    """Human-readable signature for the attribution ring: array shapes
    plus the static kwargs, e.g. ``"64x8,64x8,capacity=512"``."""
    parts: list[str] = []
    for a in args:
        shp = getattr(a, "shape", None)
        if shp is not None:
            parts.append("x".join(str(d) for d in shp) or "scalar")
    for k in sorted(kwargs):
        v = kwargs[k]
        if isinstance(v, (int, float, bool, str)):
            parts.append(f"{k}={v}")
    return ",".join(parts)[:160]


class CompileLedger:
    """Bounded record of first-launch and build events with per-kernel
    counts. One module-level instance (``LEDGER``) serves every kernel in
    the process; registries bind to it so the labeled counter family and
    the seconds histogram appear on each registry without the ledger
    holding them alive."""

    def __init__(self) -> None:
        self._lock = InstrumentedLock("device_stats")
        self._counts: dict[str, int] = {}
        self._events: deque = deque(maxlen=_EVENT_RING)
        self._total = 0
        self.compile_hist = Histogram(bounds=COMPILE_BOUNDS)
        self._registries: "weakref.WeakSet" = weakref.WeakSet()

    # -- registry binding --------------------------------------------------

    def bind_registry(self, registry) -> None:
        """Expose this ledger on a ``MetricsRegistry``: the seconds
        histogram plus a labeled counter per already-seen kernel (later
        first-seen kernels register their child on the fly). Idempotent;
        holds no ledger lock while talking to the registry."""
        with self._lock:
            kernels = list(self._counts)
        self._registries.add(registry)
        registry.histogram(
            "mqtt_tpu_matcher_compile_seconds",
            "Host seconds of each first launch per signature (the enqueue, "
            "not the kernel) and of each kernel or C build",
            bounds=COMPILE_BOUNDS,
            fn=lambda: self.compile_hist,
        )
        for kernel in kernels:
            self._register_kernel(registry, kernel)

    def _register_kernel(self, registry, kernel: str) -> None:
        registry.counter(
            "mqtt_tpu_matcher_recompiles_total",
            "First launches per new signature, and builds, per kernel (a "
            "NONZERO steady-state rate is a new shape reaching a kernel)",
            fn=lambda k=kernel: self.count(k),
            kernel=kernel,
        )

    # -- event intake ------------------------------------------------------

    def note_compile(self, kernel: str, shape_bucket: str, seconds: float) -> None:
        """Record one event; the single seam every watch and build
        funnels through."""
        with self._lock:
            first = kernel not in self._counts
            self._counts[kernel] = self._counts.get(kernel, 0) + 1
            self._total += 1
            self.compile_hist.observe(seconds)
            self._events.append(
                {
                    "kernel": kernel,
                    "shape_bucket": shape_bucket,
                    "seconds": round(seconds, 6),
                    "time_unix": time.time(),  # wall-clock event stamp, not an interval
                }
            )
        if first:
            # child registration outside the ledger lock: device_stats
            # stays a leaf in the lock-order graph
            for registry in list(self._registries):
                self._register_kernel(registry, kernel)

    # -- reads -------------------------------------------------------------

    def count(self, kernel: str) -> int:
        with self._lock:
            return self._counts.get(kernel, 0)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return self._total

    def events(self, n: Optional[int] = None) -> list:
        """Most-recent-last events (the attribution ring)."""
        with self._lock:
            evs = list(self._events)
        return evs if n is None else evs[-n:]

    def attribution(self, since_total: int = 0) -> str:
        """Human-readable blame for events past ``since_total`` — what a
        failed steady-state assert prints."""
        evs = self.events()
        new = max(0, self.total() - since_total)
        tail = evs[-new:] if new else []
        if not tail:
            return "no compile events recorded"
        lines = [
            f"  {e['kernel']}[{e['shape_bucket']}] {e['seconds'] * 1e3:.1f}ms"
            for e in tail
        ]
        return f"{new} compile event(s):\n" + "\n".join(lines)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total": self._total,
                "kernels": dict(self._counts),
                "recent": list(self._events)[-32:],
                "seconds": self.compile_hist.summary(),
            }


LEDGER = CompileLedger()

# A/B switch: with the watch disabled the wrapped kernels skip signature
# computation entirely
_ENABLED = True


def set_watch_enabled(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def watch_enabled() -> bool:
    return _ENABLED


class KernelWatch:
    """Wrap a launching callable; time the first call per new signature
    on the host clock and note it in the ledger. The time is the host's
    enqueue of the launch, not the kernel's run: the watch does not wait
    for the card. A call that raises notes nothing. The steady-state cost
    is one signature tuple per call plus a set lookup.

    ``sig``, where given, replaces the exact signature for a kernel whose
    shapes vary call by call: ``sig(*args, **kwargs)`` returns the key, a
    tuple whose first item is the shape label noted in the ledger (for
    example a size by its power-of-two bucket, so the ledger stays
    bounded)."""

    __slots__ = ("kernel", "fn", "ledger", "sig", "_seen", "_lock")

    def __init__(
        self,
        kernel: str,
        fn: Callable,
        ledger: Optional[CompileLedger] = None,
        sig: Optional[Callable] = None,
    ) -> None:
        self.kernel = kernel
        self.fn = fn
        self.ledger = LEDGER if ledger is None else ledger
        self.sig = sig
        self._seen: set = set()
        self._lock = threading.Lock()  # anonymous: guards _seen only, never calls out

    def __call__(self, *args, **kwargs):
        if not _ENABLED:
            return self.fn(*args, **kwargs)
        key = _sig_of(args, kwargs) if self.sig is None else self.sig(*args, **kwargs)
        if key in self._seen:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        with self._lock:
            new = key not in self._seen
            self._seen.add(key)
        if new:
            label = _shape_bucket(args, kwargs) if self.sig is None else key[0]
            self.ledger.note_compile(self.kernel, label, seconds)
        return out


def skew_of(tile_hits) -> float:
    """max/mean over per-tile hit counts — 1.0 is a perfectly balanced
    mesh, ``n_tiles`` is one hot tile doing all the work, 0.0 means no
    hits yet (no skew claim before traffic)."""
    arr = np.asarray(tile_hits, dtype=np.float64)
    if arr.size == 0:
        return 0.0
    mean = float(arr.mean())
    if mean <= 0.0:
        return 0.0
    return float(arr.max()) / mean


class _Card:
    """One device the plane reports: its id (the CUDA index; 0 for the
    host), its platform, the ``torch.device`` it reads memory from (None
    for the host, which cannot answer) and, for a card, its kind
    (``torch.cuda.get_device_name``; None for the host)."""

    __slots__ = ("id", "platform", "device", "kind")

    def __init__(self, did: int, platform: str, device, kind: Optional[str] = None) -> None:
        self.id = did
        self.platform = platform
        self.device = device
        self.kind = kind


class DeviceStatsPlane:
    """The per-card snapshot/surface layer: owns the memory gauges and
    the skew gauge, binds the ledger to the registry, and renders the
    JSON and ``$SYS`` rows. Stateless beyond its attachment points — all
    live numbers come from torch, the profiler, the matcher, and the
    ledger at read time.

    ``device`` is ``"cuda"`` (every visible card; raises when CUDA is
    absent) or ``"cpu"`` (the host as device 0, answering every memory
    query with the sentinel)."""

    def __init__(
        self,
        registry=None,
        hbm_watermark: float = 0.9,
        ledger: Optional[CompileLedger] = None,
        device="cuda",
    ) -> None:
        self.registry = registry
        self.hbm_watermark = float(hbm_watermark)
        self.ledger = LEDGER if ledger is None else ledger
        self.profiler = None  # tracing.DeviceProfiler, per-card windows
        self.matcher = None  # ShardedTorchMatcher for tile/skew state
        kind = torch.device(device).type
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceStatsPlane(device='cuda'): CUDA is not available")
            self._devices = [
                _Card(i, "gpu", torch.device("cuda", i), torch.cuda.get_device_name(i))
                for i in range(torch.cuda.device_count())
            ]
        elif kind == "cpu":
            self._devices = [_Card(0, "cpu", None)]
        else:
            raise ValueError(f"DeviceStatsPlane takes 'cuda' or 'cpu', got {device!r}")
        if registry is not None:
            self.ledger.bind_registry(registry)
            for d in self._devices:
                did = str(d.id)
                for name, key in (
                    ("mqtt_tpu_device_hbm_live_bytes", "bytes_in_use"),
                    ("mqtt_tpu_device_hbm_peak_bytes", "peak_bytes_in_use"),
                    ("mqtt_tpu_device_hbm_limit_bytes", "bytes_limit"),
                ):
                    registry.gauge(
                        name,
                        "Per-card memory: the caching allocator's live and "
                        "peak bytes, the card's total (-1: cannot answer)",
                        fn=lambda d=d, k=key: self._mem(d, k),
                        device=did,
                    )
                registry.gauge(
                    "mqtt_tpu_device_hbm_ratio",
                    "live/limit memory occupancy per card (0.0 unknown) — "
                    "the memory-watermark source",
                    fn=lambda d=d: self._mem_ratio(d),
                    device=did,
                )
            registry.gauge(
                "mqtt_tpu_device_skew_ratio",
                "max/mean per-tile hit counts across the shard mesh "
                "(1.0 balanced, 0.0 no traffic)",
                fn=self.skew_ratio,
            )

    # -- memory ------------------------------------------------------------

    @staticmethod
    def _mem(card: _Card, key: str) -> float:
        """One memory reading under the JAX plane's key:
        ``bytes_in_use`` and ``peak_bytes_in_use`` from the caching
        allocator, ``bytes_limit`` the card's total memory; the sentinel
        where the device cannot answer."""
        if card.device is None:
            return HBM_UNKNOWN
        if key == "bytes_limit":
            return float(torch.cuda.mem_get_info(card.device)[1])
        stats = torch.cuda.memory_stats(card.device)
        field = "allocated_bytes.all.current" if key == "bytes_in_use" else "allocated_bytes.all.peak"
        return float(stats.get(field, 0))

    @classmethod
    def _mem_ratio(cls, card: _Card) -> float:
        live = cls._mem(card, "bytes_in_use")
        limit = cls._mem(card, "bytes_limit")
        if live < 0.0 or limit <= 0.0:
            return 0.0
        return live / limit

    def hbm_ratio(self) -> float:
        """The worst (max) per-card live/limit ratio."""
        ratios = [self._mem_ratio(d) for d in self._devices]
        return max(ratios) if ratios else 0.0

    def hbm_degraded(self) -> bool:
        ratio = self.hbm_ratio()
        # a device that cannot answer (ratio 0.0) is never degraded
        return ratio > 0.0 and ratio >= self.hbm_watermark

    # -- attachments -------------------------------------------------------

    def attach_profiler(self, profiler) -> None:
        self.profiler = profiler

    def attach_matcher(self, matcher) -> None:
        """Adopt a matcher's tile-skew state (``ShardedTorchMatcher``
        exports tile_hit_counts/tile_fill_hists; a single-card
        ``TorchMatcher`` has neither and the skew gauge stays 0.0)."""
        self.matcher = matcher
        hists = getattr(matcher, "tile_fill_hists", None)
        if self.registry is not None and hists:
            for t, h in enumerate(hists):
                self.registry.counter(
                    "mqtt_tpu_device_tile_hits_total",
                    "Cumulative matcher hits landing on each batch tile",
                    fn=lambda m=matcher, t=t: int(m.tile_hit_counts()[t]),
                    tile=str(t),
                )
                self.registry.histogram(
                    "mqtt_tpu_device_tile_fill_ratio",
                    "Per-batch fill of each tile's compact capacity",
                    bounds=h.bounds,
                    fn=lambda h=h: h,
                    tile=str(t),
                )

    def skew_ratio(self) -> float:
        m = self.matcher
        if m is None:
            return 0.0
        fn = getattr(m, "device_skew_ratio", None)
        return float(fn()) if fn is not None else 0.0

    # -- renders -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The per-card JSON body."""
        prof = self.profiler
        windows = prof.device_snapshot() if prof is not None else {}
        devices = []
        for d in self._devices:
            live = self._mem(d, "bytes_in_use")
            peak = self._mem(d, "peak_bytes_in_use")
            limit = self._mem(d, "bytes_limit")
            entry: dict = {
                "id": d.id,
                "platform": d.platform,
            }
            if d.kind is not None:
                # a card names its kind; the host's entry is the JAX
                # plane's CPU entry, which has none
                entry["kind"] = d.kind
            entry["hbm"] = {
                "live_bytes": None if live < 0 else int(live),
                "peak_bytes": None if peak < 0 else int(peak),
                "limit_bytes": None if limit < 0 else int(limit),
                "ratio": round(self._mem_ratio(d), 6),
            }
            entry.update(
                windows.get(
                    d.id,
                    {
                        "duty_cycle": 0.0,
                        "overlap_ratio": 0.0,
                        "batches": 0,
                        "d2h_bytes_total": 0,
                        "issue_p99_ms": 0.0,
                        "d2h_p99_ms": 0.0,
                        "idle_gap_p99_ms": 0.0,
                    },
                )
            )
            devices.append(entry)
        m = self.matcher
        tile_hits = (
            [int(x) for x in m.tile_hit_counts()]
            if m is not None and hasattr(m, "tile_hit_counts")
            else []
        )
        return {
            "time_unix": int(time.time()),  # wall-clock snapshot stamp, not an interval
            "n_devices": len(self._devices),
            "devices": devices,
            "skew": {
                "ratio": round(self.skew_ratio(), 6),
                "tile_hits": tile_hits,
            },
            "hbm": {
                "watermark": self.hbm_watermark,
                "ratio": round(self.hbm_ratio(), 6),
                "degraded": self.hbm_degraded(),
            },
            "compiles": self.ledger.snapshot(),
        }

    def sys_tree(self) -> dict:
        """Flat ``suffix -> value`` rows for ``$SYS/broker/devices/#``."""
        out: dict[str, Any] = {}
        snap = self.snapshot()
        for dev in snap["devices"]:
            base = str(dev["id"])
            hbm = dev["hbm"]
            if "kind" in dev:
                out[f"{base}/kind"] = dev["kind"]
            out[f"{base}/hbm_live_bytes"] = (
                -1 if hbm["live_bytes"] is None else hbm["live_bytes"]
            )
            out[f"{base}/hbm_ratio"] = hbm["ratio"]
            out[f"{base}/duty_cycle"] = round(float(dev["duty_cycle"]), 6)
            out[f"{base}/d2h_bytes_total"] = int(dev["d2h_bytes_total"])
            out[f"{base}/batches"] = int(dev["batches"])
        out["skew_ratio"] = snap["skew"]["ratio"]
        out["hbm_watermark_degraded"] = int(snap["hbm"]["degraded"])
        out["compiles/total"] = snap["compiles"]["total"]
        for kernel, n in sorted(snap["compiles"]["kernels"].items()):
            out[f"compiles/{kernel}"] = n
        return out
