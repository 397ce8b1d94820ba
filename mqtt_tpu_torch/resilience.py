"""The device matcher's breaker: a circuit breaker, a hang watchdog and
half-open probes around every dispatch.

A copy of the JAX package's ``resilience`` module. ``ResilientMatcher``
wraps the server's ``DeltaMatcher``: every batch issues and resolves on a
``GuardPool`` thread, and the caller waits at most ``watchdog_s``. A batch
that raises (a kernel or copy failure, ``KernelError``), hangs past the
watchdog, or whose sampled topics differ from the live trie's walk
(``subscribers_equal``) is answered from the trie walk, the subscriber set
every device result is held to, so a publish the broker acknowledged still
reaches its subscribers. Each such batch is logged and counted
(``fallback_batches``, ``fallback_topics``, the breaker's
``failure_kinds``); ``failure_threshold`` failures in a row trip the
breaker OPEN, which sends live batches to the walk with no device round
trip until ``probe_successes`` verified probes (a background thread, on an
exponential backoff with jitter) close it again. ``breaker_gauges`` is
exported under ``$SYS/broker/matcher/breaker/`` and ``/healthz`` reports a
breaker that is not closed as degraded.

Only runtime faults reach the breaker: the server builds and loads the
kernel libraries when it is constructed, so a failed build, a failed load
or an absent card raises there and never becomes a guarded batch.
``Backoff`` is also the re-dial schedule the cluster plane takes.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .topics import Subscribers, TopicsIndex

_log = logging.getLogger("mqtt_tpu_torch.resilience")

# breaker states (exported as $SYS gauges; the ints are stable codes)
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
_STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class GuardTimeout(TimeoutError):
    """A guarded dispatch exceeded the watchdog budget."""


class Backoff:
    """Exponential backoff with bounded jitter, deterministic under a
    seed. Shared by the breaker's half-open probe schedule and the
    cluster's peer-link re-dial loop."""

    def __init__(
        self,
        initial: float = 0.5,
        maximum: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ) -> None:
        self.initial = initial
        self.maximum = maximum
        self.factor = factor
        self.jitter = jitter
        self._rng = random.Random(seed)
        self.attempts = 0

    def next(self) -> float:
        """The delay before the next attempt; successive calls grow it
        geometrically up to ``maximum``, +/- ``jitter`` fraction so a
        fleet of workers does not re-dial in lockstep."""
        # clamp the exponent: factor**1024 overflows a float BEFORE min()
        # can cap it, and a peer/device down for hours must not kill the
        # re-dial loop with an OverflowError (any real maximum is reached
        # long before 2**63)
        exp = self.factor ** min(self.attempts, 63)
        delay = min(self.maximum, self.initial * exp)
        self.attempts += 1
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, delay)

    def reset(self) -> None:
        self.attempts = 0


class CircuitBreaker:
    """A three-state (CLOSED / OPEN / HALF_OPEN) circuit breaker.

    Thread-safe: the stage drainer records outcomes from executor
    threads while the probe thread acquires probe slots. Live traffic
    consults :meth:`allow`; only the probe path runs against the guarded
    resource while not CLOSED.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        backoff: Optional[Backoff] = None,
        probe_successes: int = 2,
        clock: Callable[[], float] = time.monotonic,
        on_trip: Optional[Callable[[], None]] = None,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.backoff = backoff or Backoff()
        self.probe_successes = max(1, probe_successes)
        self.clock = clock
        self.on_trip = on_trip
        # on the port's lock plane (utils.locked): executor resolve
        # threads record outcomes here while the probe thread acquires
        # probe slots — a measured contention point under storms
        from .utils.locked import InstrumentedLock

        self._lock = InstrumentedLock("matcher_breaker")
        self._state = CLOSED
        self._retry_at = 0.0
        self._probe_inflight = False
        self._probe_ok = 0
        # counters (exported via as_dict)
        self.trips = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.successes = 0
        self.probes = 0
        self.probe_failures = 0
        self.failure_kinds: dict[str, int] = {}
        self.last_failure = ""

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May LIVE traffic use the guarded resource right now?"""
        with self._lock:
            return self._state == CLOSED

    def _trip_locked(self) -> None:
        self._state = OPEN
        self.trips += 1
        self._probe_ok = 0
        self._probe_inflight = False
        self._retry_at = self.clock() + self.backoff.next()

    def _fire_on_trip(self) -> None:
        """Invoke the trip observer AFTER the breaker lock is released: a
        slow or re-registering observer under the lock would stall every
        record_* caller on the data plane."""
        cb = self.on_trip
        if cb is not None:
            try:
                cb()
            except Exception:  # pragma: no cover - observer must not break us
                _log.exception("breaker on_trip observer failed")

    def record_failure(self, kind: str = "error") -> None:
        """A LIVE dispatch failed. Only CLOSED-state failures drive
        transitions: a stale in-flight batch failing after the trip (or
        during a probe) is counted but must not be mistaken for the
        probe's outcome — probes report via record_probe_failure."""
        tripped = False
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            self.failure_kinds[kind] = self.failure_kinds.get(kind, 0) + 1
            self.last_failure = kind
            if (
                self._state == CLOSED
                and self.consecutive_failures >= self.failure_threshold
            ):
                _log.warning(
                    "circuit breaker OPEN after %d consecutive failures "
                    "(last: %s); matching degrades to the host trie",
                    self.consecutive_failures,
                    kind,
                )
                self._trip_locked()
                tripped = True
        if tripped:
            self._fire_on_trip()

    def record_success(self) -> None:
        """A LIVE dispatch verified healthy. A stale batch resolving
        during HALF_OPEN must not claim the probe slot's outcome, so
        this never advances probe accounting (record_probe_success
        does)."""
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0

    def record_probe_failure(self, kind: str = "error") -> None:
        """The HALF_OPEN probe (the acquire_probe holder) failed:
        re-open with grown backoff."""
        with self._lock:
            self.failures += 1
            self.failure_kinds[kind] = self.failure_kinds.get(kind, 0) + 1
            self.last_failure = kind
            self.probe_failures += 1
            self._trip_locked()
        self._fire_on_trip()

    def record_probe_success(self) -> None:
        """The HALF_OPEN probe verified healthy; enough of these in a
        row close the breaker."""
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0
            if self._state != HALF_OPEN:
                return  # a concurrent probe failure already re-tripped
            self._probe_inflight = False
            self._probe_ok += 1
            if self._probe_ok >= self.probe_successes:
                _log.info(
                    "circuit breaker CLOSED after %d verified probes",
                    self._probe_ok,
                )
                self._state = CLOSED
                self._probe_ok = 0
                self.backoff.reset()
            else:
                # healthy but not yet convincing: fast-follow probe at
                # the base cadence (no extra backoff growth)
                self._state = OPEN
                self._retry_at = self.clock() + self.backoff.initial

    def seconds_until_probe(self) -> Optional[float]:
        """Time until the next probe may run; None when CLOSED."""
        with self._lock:
            if self._state == CLOSED:
                return None
            return max(0.0, self._retry_at - self.clock())

    def acquire_probe(self, force: bool = False) -> bool:
        """Claim the single half-open probe slot. True moves the breaker
        to HALF_OPEN and the caller MUST follow with record_success or
        record_failure."""
        with self._lock:
            if self._state == CLOSED:
                return False
            if self._probe_inflight and not force:
                return False
            if not force and self.clock() < self._retry_at:
                return False
            self._state = HALF_OPEN
            self._probe_inflight = True
            self.probes += 1
            return True

    def as_dict(self) -> dict:
        with self._lock:
            d = {
                "state": self._state,
                "state_code": _STATE_CODES[self._state],
                "trips": self.trips,
                "failures": self.failures,
                "consecutive_failures": self.consecutive_failures,
                "successes": self.successes,
                "probes": self.probes,
                "probe_failures": self.probe_failures,
                "last_failure": self.last_failure or "none",
            }
            for kind, n in self.failure_kinds.items():
                d[f"failures_{kind}"] = n
            return d


class _GuardTask:
    """One guarded call: the waiter may abandon it at the watchdog
    budget; the worker thread discovers the abandonment when the call
    eventually returns. ``counted`` is pool-lock-guarded wedge
    accounting — set by ``report_wedged`` only if the call was still
    unfinished, so a call completing in the raise-to-report window never
    skews the wedge count."""

    __slots__ = ("_done", "_lock", "_result", "_exc", "abandoned", "counted")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self.abandoned = False
        self.counted = False

    def wait(self, timeout: Optional[float]) -> Any:
        if not self._done.wait(timeout):
            with self._lock:
                if not self._done.is_set():
                    self.abandoned = True
                    raise GuardTimeout(f"guarded call exceeded {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class GuardPool:
    """A tiny daemon-thread pool whose workers are REPLACEABLE: when a
    caller abandons a task at the watchdog budget, the worker running it
    is presumed wedged (a hung device call cannot be interrupted), a
    substitute thread is spawned so capacity recovers, and the wedged
    worker retires itself if/when the hung call finally returns.

    Unlike ``concurrent.futures.ThreadPoolExecutor``, threads are daemon
    (a permanently hung dispatch must not block interpreter exit) and
    wedge accounting is first-class (``saturated`` lets the caller skip
    the queue entirely once everything is stuck)."""

    # hard cap on replacement spawns: a device whose every call hangs
    # forever costs at most target+MAX_WEDGED threads, never one per
    # probe attempt. Past it, probes short-circuit (live_unwedged == 0)
    # until some hung call returns and frees a worker.
    MAX_WEDGED = 16

    def __init__(self, workers: int = 4, name: str = "mqtt-torch-guard") -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._name = name
        self._target = max(1, workers)
        self._lock = threading.Lock()
        self._wedged = 0
        self._spawned = 0
        self._live = 0  # threads currently inside _run (incl. wedged)
        self._owed_retires = 0  # replacements spawned for wedged workers
        self._closed = False
        with self._lock:
            for _ in range(self._target):
                self._spawn()

    def _spawn(self) -> None:
        # caller holds self._lock
        self._spawned += 1
        self._live += 1
        t = threading.Thread(
            target=self._run, daemon=True, name=f"{self._name}-{self._spawned}"
        )
        t.start()

    def _run(self) -> None:
        while True:
            item: Optional[tuple[_GuardTask, Callable[[], object]]] = self._q.get()
            if item is None:
                with self._lock:
                    self._live -= 1
                return
            task, fn = item
            exc: Optional[BaseException] = None
            result = None
            try:
                result = fn()
            except BaseException as e:  # noqa: BLE001 - ferried to the waiter
                exc = e
            with task._lock:
                task._result = result
                task._exc = exc
                abandoned = task.abandoned
                task._done.set()
            if abandoned:
                # the waiter gave up on this call long ago: the wedge is
                # over (if it was ever counted — a completion racing the
                # report window was not). Retire ONLY if a replacement
                # was actually spawned — otherwise keep serving, or the
                # pool bleeds capacity past MAX_WEDGED toward zero
                with self._lock:
                    if task.counted:
                        self._wedged -= 1
                        if self._owed_retires > 0:
                            self._owed_retires -= 1
                            self._live -= 1
                            return

    @property
    def saturated(self) -> bool:
        """All original capacity is wedged on hung calls."""
        with self._lock:
            return self._wedged >= self._target

    @property
    def wedged(self) -> int:
        with self._lock:
            return self._wedged

    @property
    def live_unwedged(self) -> int:
        """Workers able to take new tasks right now. 0 means every
        thread is stuck in a hung call — submissions would only queue,
        so the probe path must skip dispatching rather than burn more
        threads (ResilientMatcher._probe_once)."""
        with self._lock:
            return self._live - self._wedged

    def report_wedged(self, task: _GuardTask) -> None:
        """The caller abandoned ``task``: account the wedged worker and
        spawn a substitute, bounded by MAX_WEDGED in total — a device
        whose every call hangs FOREVER must cost a bounded number of
        threads, not one per probe attempt; recovery then rides on the
        hung calls eventually returning (a healed tunnel unblocks them),
        which un-wedges workers without new spawns. A task that
        completed in the raise-to-report race window is not a wedge at
        all and leaves the accounting untouched."""
        with self._lock:
            if task._done.is_set() or task.counted:
                return  # completed just after the deadline: no wedge
            task.counted = True
            self._wedged += 1
            if not self._closed and self._wedged <= self.MAX_WEDGED:
                self._owed_retires += 1
                self._spawn()

    def submit(self, fn: Callable[[], object]) -> _GuardTask:
        with self._lock:
            if self._closed:
                raise RuntimeError("guard pool closed")
        task = _GuardTask()
        self._q.put((task, fn))
        return task

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = self._live
        for _ in range(max(0, live)):
            self._q.put(None)


@dataclass
class BreakerConfig:
    """Knobs for the degradation manager (Options / config file map the
    ``breaker_*`` keys here; see README.md)."""

    failure_threshold: int = 3
    # per-batch hang budget: a dispatch not resolved within this is
    # abandoned and served from the host trie. This is a LAST-RESORT hang
    # bound, not a latency control (staging's latency_budget_s is that) —
    # it must sit above worst-case cold-compile time.
    watchdog_s: float = 5.0
    probe_backoff_s: float = 0.5
    probe_backoff_max_s: float = 30.0
    probe_jitter: float = 0.1
    probe_successes: int = 2
    # topics differentially re-walked on the host per healthy batch (0
    # disables the corrupt-result check outside probes)
    verify_sample: int = 1
    # deterministic jitter/probe schedule for tests; None = entropy
    seed: Optional[int] = None
    guard_workers: int = 4


class ResilientMatcher:
    """Wraps a device matcher (``DeltaMatcher`` or anything exposing
    ``match_topics_async``) with the circuit breaker + watchdog + probe
    machinery. Drop-in: the staging loop and ``subscribers`` callers see
    the same interface, every result stays bit-identical to the host
    trie (the host walk IS the fallback), and no caller ever waits past
    ``watchdog_s`` for a wedged device.

    Unknown attributes delegate to the wrapped matcher (``flush``,
    ``stats``, ``pending_deltas``, ...)."""

    def __init__(
        self,
        matcher: Any,
        topics: TopicsIndex,
        config: Optional[BreakerConfig] = None,
        host_walk: Optional[Callable[[str], Subscribers]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        cfg = config or BreakerConfig()
        self.inner = matcher
        self.topics_index = topics
        self.host_walk = host_walk or topics.subscribers
        self.config = cfg
        self._trip_wake = threading.Event()
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.failure_threshold,
            backoff=Backoff(
                initial=cfg.probe_backoff_s,
                maximum=cfg.probe_backoff_max_s,
                jitter=cfg.probe_jitter,
                seed=cfg.seed,
            ),
            probe_successes=cfg.probe_successes,
            clock=clock,
            on_trip=self._trip_wake.set,
        )
        self.pool = GuardPool(workers=cfg.guard_workers)
        self._stop = threading.Event()
        self._verify_rot = 0
        # replayable probe material: the last few live topics (a probe
        # against real traffic shapes exercises the real index paths)
        self._recent: list[str] = []
        self._recent_lock = threading.Lock()
        # fallback accounting (breaker_gauges)
        self.fallback_batches = 0
        self.fallback_topics = 0
        self.verified_batches = 0
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="mqtt-torch-breaker-probe"
        )
        self._probe_thread.start()

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        # only consulted for attributes not found on self: delegate the
        # wrapped matcher's surface (stats, flush, pending_deltas, ...)
        if name == "inner":  # not yet bound (partially-initialized self)
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- matching ----------------------------------------------------------

    def _host_batch(self, topics: list[str]) -> list[Subscribers]:
        self.fallback_batches += 1
        self.fallback_topics += len(topics)
        walk = self.host_walk
        return [walk(t) if t else Subscribers() for t in topics]

    def match_topics_async(
        self, topics: list[str], profile: Any = None
    ) -> Callable[[], list[Subscribers]]:
        """Issue one guarded batch; returns a zero-arg resolver whose
        wait is bounded by the watchdog budget. ``profile`` is the
        caller's optional per-batch BatchProfile (``tracing``),
        forwarded to the wrapped matcher — the record rides WITH the
        batch, so eager guard-thread resolution can never attribute its
        device windows to another batch."""
        if topics:
            with self._recent_lock:
                self._recent.append(topics[0])
                del self._recent[:-8]
        if not self.breaker.allow() or self.pool.saturated:
            return lambda: self._host_batch(topics)
        inner = self.inner
        # verification baseline: a mutation any time after issue makes a
        # device-vs-host mismatch indeterminate (the device result is
        # bit-identical at RESOLVE time; the host walk at verify time may
        # legitimately have moved on), so _verify compares against this
        v_issue = self.topics_index.version
        try:
            # issue + resolve BOTH run on the guard thread: a dead link
            # can hang the upload/compile at issue time just as easily as
            # the D2H sync at resolve time, and neither may wedge the
            # caller (the event loop issues, the drainer resolves). The
            # submit happens NOW, so batch N+1's dispatch overlaps batch
            # N's resolve exactly as the unguarded pipeline did.
            if profile is None:
                # no kwarg when no record: wrapped matchers that predate
                # the profile contract (fault doubles, embedder shims)
                # keep working untouched
                issue = lambda: inner.match_topics_async(topics)()  # noqa: E731
            else:
                issue = lambda: inner.match_topics_async(  # noqa: E731
                    topics, profile=profile
                )()
            task = self.pool.submit(issue)
        except RuntimeError:  # pool closed (shutdown race)
            return lambda: self._host_batch(topics)

        def resolve() -> list[Subscribers]:
            try:
                results = task.wait(self.config.watchdog_s)
            except GuardTimeout:
                self.pool.report_wedged(task)
                self.breaker.record_failure("hang")
                _log.warning(
                    "device batch exceeded the %.3fs watchdog; host fallback",
                    self.config.watchdog_s,
                )
                return self._host_batch(topics)
            except Exception:
                self.breaker.record_failure("error")
                _log.exception("device batch failed; host fallback")
                return self._host_batch(topics)
            if not self._verify(topics, results, v_issue):
                self.breaker.record_failure("corrupt")
                _log.error(
                    "device result diverged from the host trie; host fallback"
                )
                return self._host_batch(topics)
            self.breaker.record_success()
            return results

        return resolve

    def match_topics(self, topics: list[str]) -> list[Subscribers]:
        return self.match_topics_async(topics)()

    def subscribers(self, topic: str) -> Subscribers:
        """Drop-in for ``TopicsIndex.subscribers`` (batch of one)."""
        return self.match_topics([topic])[0]

    # -- differential verification -----------------------------------------

    def _verify(
        self, topics: list[str], results: list[Subscribers], v_issue: int
    ) -> bool:
        """Re-walk ``verify_sample`` of the batch on the live host trie
        and compare. A mismatch while the trie has mutated since the batch
        was issued is indeterminate — the device result was bit-identical at resolve
        time, but the live walk may legitimately have moved on (e.g. a
        SUBSCRIBE between resolve and verify) — and is skipped rather
        than counted as corruption."""
        from .ops.matcher import subscribers_equal

        k = self.config.verify_sample
        if k <= 0 or not topics:
            return True
        candidates = [i for i, t in enumerate(topics) if t]
        if not candidates:
            return True
        self._verify_rot += 1
        start = self._verify_rot % len(candidates)
        for j in range(min(k, len(candidates))):
            i = candidates[(start + j) % len(candidates)]
            host = self.host_walk(topics[i])
            if not subscribers_equal(results[i], host):
                if self.topics_index.version != v_issue:
                    continue  # churn window: indeterminate, skip
                return False
        self.verified_batches += 1
        return True

    # -- half-open probing --------------------------------------------------

    def _probe_topics(self) -> list[str]:
        with self._recent_lock:
            recent = list(dict.fromkeys(self._recent))
        return recent[-4:] or ["mqtt-torch/breaker/probe"]

    def probe_now(self) -> bool:
        """Force one synchronous probe (tests / operator tooling); True
        when the probe verified healthy."""
        if not self.breaker.acquire_probe(force=True):
            return False
        return self._probe_once()

    def _probe_once(self) -> bool:
        """One HALF_OPEN probe: a small guarded batch, 100% verified
        against the live host walk. The caller must hold the probe slot;
        outcomes report through the probe-specific breaker paths so a
        stale live batch resolving mid-probe cannot claim the slot."""
        topics = self._probe_topics()
        from .ops.matcher import subscribers_equal

        if self.pool.live_unwedged <= 0:
            # every guard thread is stuck in a hung call: dispatching
            # another probe would only queue behind them and burn the
            # thread budget — recovery requires a hung call to return
            # first (a healed link unblocks them)
            self.breaker.record_probe_failure("saturated")
            return False
        v_issue = self.topics_index.version
        try:
            task = self.pool.submit(
                lambda: self.inner.match_topics_async(topics)()
            )
            results = task.wait(self.config.watchdog_s)
        except GuardTimeout:
            self.pool.report_wedged(task)
            self.breaker.record_probe_failure("hang")
            return False
        except Exception:
            self.breaker.record_probe_failure("error")
            return False
        for t, r in zip(topics, results):
            if not subscribers_equal(r, self.host_walk(t)):
                if self.topics_index.version != v_issue:
                    continue  # churn window: indeterminate
                self.breaker.record_probe_failure("corrupt")
                return False
        self.breaker.record_probe_success()
        return True

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self._trip_wake.wait()
            if self._stop.is_set():
                return
            self._trip_wake.clear()
            while not self._stop.is_set():
                delay = self.breaker.seconds_until_probe()
                if delay is None:  # CLOSED again: back to sleep
                    break
                if self._stop.wait(min(delay, 1.0)):
                    return
                if self.breaker.seconds_until_probe() not in (None, 0.0):
                    continue  # backoff not elapsed yet (bounded waits so
                    # close() never blocks behind a long schedule)
                if self.breaker.acquire_probe():
                    try:
                        self._probe_once()
                    except Exception:  # pragma: no cover - probe must not die
                        _log.exception("half-open probe crashed")
                        self.breaker.record_probe_failure("error")

    # -- observability / lifecycle -----------------------------------------

    def breaker_gauges(self) -> dict:
        """The $SYS gauge map (server.publish_sys_topics exports it under
        ``$SYS/broker/matcher/breaker/``)."""
        d = self.breaker.as_dict()
        d["fallback_batches"] = self.fallback_batches
        d["fallback_topics"] = self.fallback_topics
        d["verified_batches"] = self.verified_batches
        d["wedged_workers"] = self.pool.wedged
        return d

    def close(self) -> None:
        self._stop.set()
        self._trip_wake.set()
        self._probe_thread.join(timeout=2)
        self.pool.close()
        inner_close = getattr(self.inner, "close", None)
        if callable(inner_close):
            inner_close()
