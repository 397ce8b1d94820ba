"""Host hot-path observatory: sampling wall profiler over every broker
thread, flamegraph/Perfetto exports, and the topic-cardinality sketch.

A copy of the JAX package's ``mqtt_tpu/profiling.py``. The device
profiler (tracing.DeviceProfiler) says how idle the card is; this module
answers the host half: where does wall time actually go across the
asyncio data plane, the staging resolver threads, the breaker guard
pool, and the flight/trace writers.

- ``SamplingProfiler``: an always-on, low-overhead wall profiler. A
  daemon thread wakes at ``hz`` and snapshots ``sys._current_frames()``
  — no tracing hooks, no per-call overhead on the profiled threads, no
  locks shared with the data plane (the governor/breaker paths are
  never acquired from the sampler). Samples aggregate into per-thread
  collapsed stacks (flamegraph.pl / speedscope ready) and a bounded
  ring of raw samples that reconstructs into Chrome trace events (a
  flame CHART per thread — Perfetto-loadable), both served at
  ``GET /profile`` (listeners/http.py) and written beside trigger
  dumps.
- ``TopicSketch``: a space-saving top-K sketch over published topics
  (Metwally et al.'s Stream-Summary bounds: a topic's true count is
  within ``err`` of the sketch count, and any topic with true count
  above the minimum tracked count IS in the sketch). Sizes the
  device-side compaction buffers: the observed
  avg-hits-per-topic is exactly the compaction fan-in estimate.
- ``check_collapsed``: a ~15-line pure-Python validator for the
  collapsed-text export (the /profile analog of
  ``telemetry.check_exposition``), used by the tests and
  ``chip_smoke.py``. The trace export is validated by the existing
  ``tracing.check_trace_events``.

Knobs live on ``Options`` (``profile``, ``profile_hz``,
``profile_ring``, ``profile_locks``, ``profile_topics``); the plane is
ON by default whenever telemetry is.
"""

from __future__ import annotations

import collections
import os
import re
import sys
import threading
import time
from typing import Any, Callable, Optional

def _frame_label(frame: Any) -> str:
    """One collapsed-stack frame: ``func (file.py:line)`` with the
    separator characters (';' joins frames, ' ' ends the stack) made
    safe."""
    code = frame.f_code
    label = (
        f"{code.co_name} ({os.path.basename(code.co_filename)}:{frame.f_lineno})"
    )
    return label.replace(";", ",")


class SamplingProfiler:
    """Sampling wall profiler over all broker threads.

    The sweep runs on its own daemon thread: ``sys._current_frames()``
    returns every thread's current frame without cooperation from the
    profiled threads, so the broker's hot paths pay ZERO per-call cost —
    total overhead is ``hz`` sweeps/second of stack walking, measured by
    the ``mqtt_tpu_profile_sweep_seconds`` histogram so the claim is
    checkable on /metrics. Aggregation state mutates only under the
    profiler's private mutex (held for dict arithmetic; the sweep's
    frame walk runs outside it), which is deliberately NOT part of the
    broker lock plane: the profiler must observe contention, not add
    to it.

    ``sample_once()`` is the deterministic seam — tests (and the bench
    overhead probe) drive sweeps directly, with an injectable
    ``frames_fn``/``clock``, so collapsed output for a known thread
    workload is reproducible without racing a timer thread.
    """

    def __init__(
        self,
        hz: float = 29.0,
        ring: int = 2048,
        registry: Any = None,
        max_stacks: int = 4096,
        max_depth: int = 64,
        frames_fn: Callable[[], dict] = sys._current_frames,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.hz = max(0.1, float(hz))
        self.max_stacks = max(16, int(max_stacks))
        self.max_depth = max(4, int(max_depth))
        self.frames_fn = frames_fn
        self.clock = clock
        self._mutex = threading.Lock()
        # frame-label memo keyed on (code object, lineno): steady-state
        # sweeps see the same frames over and over, so the basename +
        # format work runs once per distinct code point, not per sweep
        # (bounded — cleared wholesale at the cap; code objects stay
        # referenced, which is fine: they are module-lifetime anyway)
        self._labels: dict[tuple, str] = {}
        # (thread_name, stack tuple) -> sample count
        self._agg: dict[tuple[str, tuple[str, ...]], int] = {}
        # recent raw samples for the timeline export:
        # (t, {tid: (thread_name, stack tuple)})
        self._ring: collections.deque = collections.deque(maxlen=max(16, int(ring)))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0  # sweeps taken
        self.thread_samples = 0  # per-thread stacks recorded
        self.dropped_stacks = 0  # distinct-stack cap overflows
        self.last_thread_count = 0
        # wall anchor for the trace export: perf_counter + anchor = unix
        # seconds, the same convention as tracing.Tracer so /profile and
        # /traces land on one Perfetto timeline.
        # brokerlint: ok=R3 one-shot wall anchor so exported profile timestamps are operator-correlatable; durations stay monotonic
        self._anchor = time.time() - time.perf_counter()
        self.sweep_hist: Any = None
        if registry is not None:
            self.sweep_hist = registry.histogram(
                "mqtt_tpu_profile_sweep_seconds",
                "Wall cost of one profiler sweep over all thread stacks "
                "(the low-overhead claim, checkable)",
            )
            registry.counter(
                "mqtt_tpu_profile_samples_total",
                "Profiler sweeps taken since start",
                fn=lambda: self.samples,
            )
            registry.counter(
                "mqtt_tpu_profile_stacks_dropped_total",
                "Distinct stacks dropped at the aggregation cap",
                fn=lambda: self.dropped_stacks,
            )
            registry.gauge(
                "mqtt_tpu_profile_threads",
                "Threads seen by the last profiler sweep",
                fn=lambda: self.last_thread_count,
            )
            registry.gauge(
                "mqtt_tpu_profile_distinct_stacks",
                "Distinct (thread, stack) aggregation entries held",
                fn=lambda: len(self._agg),
            )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mqtt-torch-profiler"
        )
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:  # pragma: no cover  # brokerlint: ok=R4 a torn frame walk (thread exiting mid-sweep) costs one sample; the next sweep self-heals
                pass

    # -- sampling -----------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """One sweep over every live thread's stack; returns the number
        of threads sampled. The frame walk runs OUTSIDE the mutex; only
        the aggregation arithmetic holds it."""
        t0 = self.clock()
        frames = self.frames_fn()
        own = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        snap: dict[int, tuple[str, tuple[str, ...]]] = {}
        for tid, frame in frames.items():
            if tid == own:
                # never profile the sweeping thread: on the timer thread
                # that is the sampler observing itself; a direct
                # sample_once() caller (tests, bench probe) is likewise
                # measurement machinery, not broker work
                continue
            stack: list[str] = []
            f = frame
            depth = 0
            labels = self._labels
            while f is not None and depth < self.max_depth:
                key = (f.f_code, f.f_lineno)
                label = labels.get(key)
                if label is None:
                    if len(labels) >= 16384:
                        labels.clear()
                    label = labels[key] = _frame_label(f)
                stack.append(label)
                f = f.f_back
                depth += 1
            stack.reverse()  # root-first, collapsed-stack convention
            snap[tid] = (names.get(tid, f"thread-{tid}"), tuple(stack))
        when = now if now is not None else t0
        with self._mutex:
            for entry in snap.values():
                n = self._agg.get(entry)
                if n is not None:
                    self._agg[entry] = n + 1
                elif len(self._agg) < self.max_stacks:
                    self._agg[entry] = 1
                else:
                    self.dropped_stacks += 1
            self._ring.append((when, snap))
            self.samples += 1
            self.thread_samples += len(snap)
            self.last_thread_count = len(snap)
        if self.sweep_hist is not None:
            self.sweep_hist.observe(self.clock() - t0)
        return len(snap)

    def reset(self) -> None:
        with self._mutex:
            self._agg.clear()
            self._ring.clear()
            self.samples = 0
            self.thread_samples = 0
            self.dropped_stacks = 0

    # -- exports ------------------------------------------------------------

    def collapsed(self) -> str:
        """The aggregate as flamegraph-collapsed text: one line per
        distinct stack — ``thread;frame;frame... <count>`` — loadable by
        flamegraph.pl, speedscope, and inferno."""
        with self._mutex:
            items = sorted(self._agg.items(), key=lambda kv: -kv[1])
        lines = []
        for (tname, stack), count in items:
            head = tname.replace(";", ",")
            lines.append(";".join((head,) + stack) + f" {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def trace_events(self, pid: int = 0) -> dict:
        """The sample ring reconstructed as a Chrome trace-event flame
        chart: per thread, consecutive samples sharing a frame at depth
        d merge into one ``"ph": "X"`` span. Wall-anchored microseconds,
        one ``tid`` per thread — drop the JSON into Perfetto next to a
        /traces export and both land on the same timeline."""
        with self._mutex:
            ring = list(self._ring)
        events: list[dict] = []
        # thread id -> (open frame label, open start) per depth
        open_spans: dict[int, list[tuple[str, float]]] = {}
        names: dict[int, str] = {}
        last_t = 0.0
        period = 1.0 / self.hz

        def close_from(tid: int, depth: int, t_end: float) -> None:
            spans = open_spans.get(tid, [])
            while len(spans) > depth:
                label, t_start = spans.pop()
                events.append(
                    {
                        "name": label,
                        "cat": "sample",
                        "ph": "X",
                        "ts": round((t_start + self._anchor) * 1e6, 3),
                        "dur": round(max(0.0, t_end - t_start) * 1e6, 3),
                        "pid": pid,
                        "tid": tid % 1_000_000,
                        "args": {"thread": names.get(tid, str(tid))},
                    }
                )

        for t, snap in ring:
            last_t = max(last_t, t)
            for tid in list(open_spans):
                if tid not in snap:  # thread vanished between samples
                    close_from(tid, 0, t)
                    del open_spans[tid]
            for tid, (tname, stack) in snap.items():
                names[tid] = tname
                spans = open_spans.setdefault(tid, [])
                # find the first depth where the stack diverges
                keep = 0
                for keep, (label, _t0) in enumerate(spans):
                    if keep >= len(stack) or stack[keep] != label:
                        break
                else:
                    keep = len(spans)
                if keep < len(spans):
                    close_from(tid, keep, t)
                for d in range(len(spans), len(stack)):
                    spans.append((stack[d], t))
        for tid in list(open_spans):
            close_from(tid, 0, last_t + period)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def top_stacks(self, k: int = 5) -> list[tuple[str, int]]:
        """The k hottest collapsed stacks (bench/test convenience)."""
        with self._mutex:
            items = sorted(self._agg.items(), key=lambda kv: -kv[1])[:k]
        return [
            (";".join((tname,) + stack), count)
            for (tname, stack), count in items
        ]

    def bench_block(self) -> dict:
        """The BENCH-json host-profile block."""
        top = self.top_stacks(3)
        return {
            "samples": self.samples,
            "thread_samples": self.thread_samples,
            "threads_live": self.last_thread_count,
            "distinct_stacks": len(self._agg),
            "dropped_stacks": self.dropped_stacks,
            "sweep_p99_ms": (
                round(self.sweep_hist.percentile(0.99) * 1e3, 3)
                if self.sweep_hist is not None and self.sweep_hist.count
                else None
            ),
            "top_stacks": [
                {"stack": s[-160:], "count": c} for s, c in top
            ],
        }


_COLLAPSED_RE = re.compile(r"^\S.* [0-9]+$")


def check_collapsed(text: str) -> int:
    """A minimal pure-Python checker for flamegraph-collapsed text (the
    /profile analog of ``telemetry.check_exposition``): every non-empty
    line must be ``stack<space>count`` with a positive integer count and
    a non-empty ``;``-joined stack. Returns the line count."""
    lines = 0
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if not _COLLAPSED_RE.match(line):
            raise ValueError(f"line {i}: malformed collapsed stack: {line!r}")
        stack, _, count = line.rpartition(" ")
        if int(count) <= 0:
            raise ValueError(f"line {i}: non-positive count: {line!r}")
        if not all(stack.split(";")):
            raise ValueError(f"line {i}: empty frame in stack: {line!r}")
        lines += 1
    if lines == 0:
        raise ValueError("no stacks in collapsed export")
    return lines


class TopicSketch:
    """Space-saving (Stream-Summary) top-K sketch over published topics.

    Bounds (Metwally et al. 2005): with capacity k, every tracked
    topic's TRUE count lies in ``[count - err, count]``, and any topic
    whose true count exceeds ``min_count`` is guaranteed tracked. The
    min-eviction scan is O(k) but runs only when an UNTRACKED topic
    arrives with the sketch full — the steady state (hot topics
    dominating) is a dict hit. The broker observes SAMPLED publishes
    (the stage-clock verdict), so the heavy-churn worst case is paid
    1-in-N.

    ``avg_hits_per_topic`` = total observations / distinct admissions —
    the device-side compaction-buffer sizing number (the compacted
    result packs (topic_idx, subscriber_id) pairs sized by exactly this
    fan-in). Admissions over-count topics that re-enter after eviction,
    so the average is a LOWER bound on the true per-topic hit rate;
    the bias direction is safe for buffer sizing (never under-sizes).
    """

    def __init__(self, k: int = 512) -> None:
        self.k = max(8, int(k))
        self._mutex = threading.Lock()
        self._counts: dict[str, list] = {}  # topic -> [count, err]
        self.total = 0
        self.admissions = 0
        self.evictions = 0

    def observe(self, topic: str, n: int = 1) -> None:
        with self._mutex:
            self.total += n
            entry = self._counts.get(topic)
            if entry is not None:
                entry[0] += n
                return
            if len(self._counts) < self.k:
                self._counts[topic] = [n, 0]
                self.admissions += 1
                return
            # evict the minimum; the newcomer inherits its count as err
            victim = min(self._counts, key=lambda t: self._counts[t][0])
            m = self._counts[victim][0]
            del self._counts[victim]
            self._counts[topic] = [m + n, m]
            self.admissions += 1
            self.evictions += 1

    def top(self, n: int = 10) -> list[dict]:
        with self._mutex:
            items = sorted(
                self._counts.items(), key=lambda kv: -kv[1][0]
            )[: max(0, n)]
        return [
            {"topic": t, "count": c, "err": e} for t, (c, e) in items
        ]

    @property
    def tracked(self) -> int:
        with self._mutex:
            return len(self._counts)

    def min_count(self) -> int:
        """The guarantee threshold: any topic with true count above this
        is tracked."""
        with self._mutex:
            if not self._counts:
                return 0
            return min(c for c, _e in self._counts.values())

    def avg_hits_per_topic(self) -> float:
        with self._mutex:
            if self.admissions == 0:
                return 0.0
            return self.total / self.admissions

    def bench_block(self, top_n: int = 5) -> dict:
        return {
            "observed": self.total,
            "tracked": self.tracked,
            "admissions": self.admissions,
            "evictions": self.evictions,
            "avg_hits_per_topic": round(self.avg_hits_per_topic(), 3),
            "top_topics": self.top(top_n),
        }
