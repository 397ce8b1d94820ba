"""The publish staging loop: micro-batch concurrent PUBLISHes into device
match batches.

The reference matches synchronously inside ``processPublish``
(server.go:984-1021) — free when the walk is an in-process trie, ruinous
when it is a device round trip. The stage turns the device matcher into a
pipelined batch engine:

- ``submit(topic)`` parks the publish on a future and returns immediately;
  the caller awaits it, so *that* client blocks while every other client
  keeps being served.
- A collector task gathers everything submitted within the accumulation
  window (or up to the batch cap) and issues ONE ``match_topics_async``
  dispatch. The issue leg (host tokenize + H2D + async device dispatch)
  runs on its OWN dispatch thread, the blocking D2H wait + host
  materialization on another, and the kernel itself is asynchronous on
  the device — a ``pipeline_depth``-deep (default 3) overlapped pipeline
  in which batch N+2 tokenizes while N+1 matches and N drains.
- The window and the batch cap ADAPT to the measured per-batch service
  time against ``latency_budget_s``: under light load the window shrinks
  toward immediate dispatch; under heavy load batches grow until the
  service-time EWMA approaches the budget, then the cap backs off so
  publish latency stays bounded instead of batches compounding.
- A drainer task resolves batches IN ORDER off the event loop and
  completes the futures in submission order — per-publish fan-out order is
  exactly submission order, as in the reference.
- MQTT+ payload predicates and tenant decryption ride the SAME batch:
  ``submit(topic, feats=..., rjob=...)`` parks the publish's feature
  carrier (``predicates.PublishFeatures``) and decrypt job
  (``tenancy.RecryptJob``); the issue leg launches the rule evaluation
  (``PredicateEngine.eval_batch_async``) and the keystream
  (``RecryptEngine.issue_batch``) beside the match, the drain leg waits
  for all three in one executor call and stamps the pass-bit rows and
  keystreams onto their carriers before the futures complete.
- With a device profiler (``tracing.DeviceProfiler``, ``profiler=``)
  the issue leg opens each batch's ``BatchProfile`` on the dispatch
  thread and hands it to the matcher, which stamps the batch's issue and
  D2H windows on it (attach the same profiler to the matcher's snapshot,
  ``DeltaMatcher.snapshot.profiler``).
- A failure on any leg (a kernel that fails to build or launch, a failed
  copy) is set on the affected batch's futures, so it reaches each
  publisher: a host path would move the work off the card without a
  word. The stage goes on with the next batch.
- Admission is BOUNDED (``max_pending``): under a publish storm the parked
  list never grows past its cap — overflow (and submissions whose
  projected pipeline wait already exceeds the deadline) resolves via the
  host walk immediately.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from .topics import Subscribers

_log = logging.getLogger("mqtt_tpu_torch.staging")

MIN_BATCH = 64  # the adaptive batch cap never shrinks below this


class MatchStage:
    """Micro-batching pipeline between ``process_publish`` and a device
    matcher (``DeltaMatcher`` or any object with ``match_topics_async``).
    The device is the matcher's."""

    def __init__(
        self,
        matcher,
        host_fallback: Callable[[str], Subscribers],
        predicates=None,
        recrypt=None,
        window_s: float = 0.002,
        max_batch: int = 4096,
        max_inflight: int = 4,
        latency_budget_s: Optional[float] = 0.25,
        max_pending: int = 8192,
        pipeline_depth: int = 3,
        profiler=None,
    ) -> None:
        self.matcher = matcher
        self.host_fallback = host_fallback
        # device pipeline profiler (tracing.DeviceProfiler) or None: the
        # issue leg opens each batch's record for the matcher to stamp
        self.profiler = profiler
        # the predicate plane (predicates.PredicateEngine) and the tenant
        # re-encryption engine (tenancy.RecryptEngine), or None
        self.predicates = predicates
        self.recrypt = recrypt
        # overlapped-staging depth: how many batches may be in flight across
        # the issue / device / drain legs (0 falls back to max_inflight).
        # Depth 3 keeps one batch per leg.
        self.pipeline_depth = pipeline_depth if pipeline_depth > 0 else max_inflight
        self.window_s = window_s  # the MAXIMUM accumulation window
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        # p99 target for one staged publish: wait + service must fit it.
        # None disables adaptation (fixed window + cap)
        self.latency_budget_s = latency_budget_s
        # bounded admission: _pending may never grow past this
        self.max_pending = max(1, max_pending)
        self.admission_fallbacks = 0
        self.peak_pending = 0
        # host-walk resolutions by class (admission, stop)
        self.fallbacks: dict[str, int] = {}
        # parked publishes: (topic, future, feats, rjob). submit(), the collector and the
        # drainer all run on the stage's loop (start()'s), so no lock
        self._pending: list[tuple] = []
        self._wake: Optional[asyncio.Event] = None
        self._queue: Optional[asyncio.Queue] = None
        self._tasks: list[asyncio.Task] = []
        # the resolve leg's executor and the issue leg's SINGLE dispatch
        # thread (batch order must hold on the issue leg)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._h2d_executor: Optional[ThreadPoolExecutor] = None
        # batches currently inside the pipeline (enqueued or draining)
        self.inflight_batches = 0
        self._stopping = False
        self._ewma_s = 0.0  # per-batch service-time EWMA (drainer-updated)
        # the most recent batches' (size, resolve seconds): the D2H wait
        # plus host materialization of each batch, in drain order
        self.service_log: deque = deque(maxlen=4096)
        self._batch_cap = max_batch if latency_budget_s is None else max(
            MIN_BATCH, min(max_batch, 1024)
        )

    def _window(self) -> float:
        """The adaptive accumulation sleep: a fraction of the measured
        service time, never exceeding the configured maximum window or the
        latency budget's headroom. A submitted publish waits for every batch
        already queued, so the headroom is depth-scaled; once depth x
        service alone exceeds the budget the window collapses to 0."""
        budget = self.latency_budget_s
        if budget is None or self._ewma_s <= 0.0:
            return self.window_s
        depth = 1 if self._queue is None else self._queue.qsize() + 1
        headroom = budget - depth * self._ewma_s
        if headroom <= 0.0:
            return 0.0  # over budget already: dispatch immediately
        return min(self.window_s, 0.5 * self._ewma_s, headroom)

    def _observe_service(self, dt: float, n: int, depth: int) -> None:
        """Feed one batch's resolve wall time into the controller: grow
        the cap while service time is comfortably under budget, shrink it
        proportionally when a batch overruns. ``depth`` is the number of
        batches that were queued behind this one: the budget bounds
        depth x service, not one batch's service."""
        self._ewma_s = dt if self._ewma_s == 0.0 else (
            0.7 * self._ewma_s + 0.3 * dt
        )
        budget = self.latency_budget_s
        if budget is None or n <= 0:
            return
        effective = dt * max(1, depth)
        if effective > 0.8 * budget:
            target = max(int(n * 0.6 * budget / effective), MIN_BATCH)
            if target < self._batch_cap:
                self._batch_cap = target
        elif effective < 0.4 * budget and n >= self._batch_cap:
            # only grow when the cap actually bound the batch
            self._batch_cap = min(self.max_batch, self._batch_cap * 2)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Create the collector/drainer tasks on the running loop."""
        loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=max(2, self.max_inflight),
            thread_name_prefix="mqtt-torch-resolve",
        )
        self._h2d_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mqtt-torch-h2d"
        )
        # bounded: if resolution falls behind, collection backpressures
        # instead of queueing unbounded device batches
        self._queue = asyncio.Queue(maxsize=self.pipeline_depth)
        self.inflight_batches = 0  # a restarted stage begins empty
        self._tasks = [
            loop.create_task(self._collect_loop(), name="mqtt-torch-stage-collect"),
            loop.create_task(self._drain_loop(), name="mqtt-torch-stage-drain"),
        ]

    async def stop(self) -> None:
        """Stop the pipeline; anything still parked resolves via the host
        walk so no publish is ever lost."""
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        parked, self._pending = self._pending, []
        self._fallback_all(parked, klass="stop")
        queue = self._queue
        if queue is not None:
            while not queue.empty():
                futs, topics = queue.get_nowait()[1:3]
                self.inflight_batches -= 1
                self._fallback_all(list(zip(topics, futs)), klass="stop")
        if self._executor is not None:
            # in-flight resolves may finish on their own time; queued
            # ones are dead (their futures just resolved via fallback)
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
        if self._h2d_executor is not None:
            self._h2d_executor.shutdown(wait=False, cancel_futures=True)
            self._h2d_executor = None

    # -- submission --------------------------------------------------------

    def submit(self, topic: str, feats=None, rjob=None) -> "asyncio.Future[Subscribers]":
        """Park one publish; the future resolves with its Subscribers.
        Call it on the stage's loop. ``feats`` is the publish's optional
        payload-feature carrier and ``rjob`` its optional decrypt job:
        their device results come back ON the carriers; a publish the host
        walk resolves leaves them unstamped (the fan-out's host paths
        decide).

        Admission is bounded: once ``max_pending`` publishes are parked,
        or the pipeline's projected wait already exceeds the deadline
        (2x the latency budget), the publish resolves immediately via
        the host walk instead of growing the backlog."""
        fut = asyncio.get_running_loop().create_future()
        wake = self._wake
        if self._stopping or wake is None:
            fut.set_result(self.host_fallback(topic))
            return fut
        admitted = not (len(self._pending) >= self.max_pending or self._past_deadline())
        if admitted:
            self._pending.append((topic, fut, feats, rjob))
            self.peak_pending = max(self.peak_pending, len(self._pending))
        if not admitted:
            self.admission_fallbacks += 1
            self._note_fallback("admission", 1)
            fut.set_result(self.host_fallback(topic))
            return fut
        wake.set()
        return fut

    def _past_deadline(self) -> bool:
        """Deadline-aware admission: a new submission waits behind every
        queued batch plus every parked batch-worth of _pending; when that
        projected wait exceeds twice the latency budget, the host walk
        serves it now. An IDLE pipeline always admits, whatever the EWMA
        says (the estimate only heals through real dispatches)."""
        budget = self.latency_budget_s
        if budget is None or self._ewma_s <= 0.0:
            return False
        qdepth = self._queue.qsize() if self._queue is not None else 0
        if qdepth == 0 and not self._pending:
            return False  # idle: admit, and let the EWMA re-learn
        depth = 1 + qdepth + len(self._pending) // max(1, self._batch_cap)
        return depth * self._ewma_s > 2.0 * budget

    # -- pipeline ----------------------------------------------------------

    async def _collect_loop(self) -> None:
        wake, queue = self._wake, self._queue
        assert wake is not None and queue is not None  # start() created us
        while True:
            await wake.wait()
            wake.clear()
            if not self._pending:
                continue
            # the accumulation window: give concurrent publishers a beat to
            # land in this batch, adaptively sized and capped
            cap = self._batch_cap
            if len(self._pending) < cap:
                w = self._window()
                if w > 0:
                    await asyncio.sleep(w)
                cap = self._batch_cap  # the drainer may have adapted it
            batch, self._pending = self._pending[:cap], self._pending[cap:]
            if self._pending:
                wake.set()  # leftovers start the next window now
            # a caller future cancelled mid-window is dead weight
            batch = [item for item in batch if not item[1].cancelled()]
            if not batch:
                continue
            topics = [item[0] for item in batch]
            futs = [item[1] for item in batch]
            feats = [item[2] for item in batch]
            rjobs = [item[3] for item in batch]
            matcher, predicates, recrypt = self.matcher, self.predicates, self.recrypt
            profiler = self.profiler

            def issue():
                if profiler is not None:
                    # the batch's OWN record: resolves on the executor can
                    # never cross-attribute another batch's windows
                    resolver = matcher.match_topics_async(topics, profile=profiler.open_batch())
                else:
                    resolver = matcher.match_topics_async(topics)
                pred_resolver = predicates.eval_batch_async(feats) if predicates is not None else None
                rec_resolver = recrypt.issue_batch(rjobs) if recrypt is not None else None
                return resolver, pred_resolver, rec_resolver

            loop = asyncio.get_running_loop()
            try:
                resolvers = await loop.run_in_executor(self._h2d_executor, issue)
            except asyncio.CancelledError:
                # stop() cancelled us with this batch in hand: resolve it
                self._fallback_all(batch, klass="stop")
                raise
            except Exception as e:
                _log.exception("stage issue failed")
                self._fail_all(futs, e)
                continue
            self.inflight_batches += 1
            try:
                await queue.put((resolvers, futs, topics, feats))
            except asyncio.CancelledError:
                self.inflight_batches -= 1
                self._fallback_all(batch, klass="stop")
                raise

    async def _drain_loop(self) -> None:
        loop = asyncio.get_running_loop()
        queue = self._queue
        assert queue is not None  # start() created us
        while True:
            resolvers, futs, topics, feats = await queue.get()
            try:
                # the D2H waits block — run them off the loop, all three
                # legs in one executor call. Queue depth is sampled at
                # resolve time: batches still queued waited for this one,
                # so the controller budgets depth x service.
                depth = queue.qsize() + 1
                t0 = loop.time()
                results, pred_rows, rec_rows = await loop.run_in_executor(
                    self._executor, lambda: tuple(r() if r is not None else None for r in resolvers)
                )
                if pred_rows is not None:
                    self.predicates.attach_rows(feats, pred_rows)
                if rec_rows is not None:
                    self.recrypt.attach(rec_rows)
                dt = loop.time() - t0
                self.service_log.append((len(topics), dt))
                self._observe_service(dt, len(topics), depth)
            except asyncio.CancelledError:
                # stop() cancelled us with this batch already popped
                self.inflight_batches -= 1
                self._fallback_all(list(zip(topics, futs)), klass="stop")
                raise
            except Exception as e:
                self.inflight_batches -= 1
                _log.exception("stage resolve failed")
                self._fail_all(futs, e)
                continue
            self.inflight_batches -= 1
            for fut, subs in zip(futs, results):
                if not fut.done():
                    fut.set_result(subs)

    @staticmethod
    def _fail_all(futs, exc: BaseException) -> None:
        for fut in futs:
            if not fut.done():
                fut.set_exception(exc)

    def _note_fallback(self, klass: str, n: int) -> None:
        self.fallbacks[klass] = self.fallbacks.get(klass, 0) + n

    def _fallback_all(self, items, klass: str = "stop") -> None:
        """Resolve parked items via the host walk. ``items`` yield
        ``(topic, future, ...)``."""
        n = 0
        for item in items:
            topic, fut = item[0], item[1]
            if fut.done():
                continue
            n += 1
            try:
                fut.set_result(self.host_fallback(topic))
            except Exception as e:  # pragma: no cover - host walk is total
                fut.set_exception(e)
        if n:
            self._note_fallback(klass, n)
