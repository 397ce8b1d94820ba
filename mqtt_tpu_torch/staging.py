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
- With a telemetry plane (``telemetry.Telemetry``, ``telemetry=``) every
  batch's resolve time and fill go to its histograms, the h2d and d2h
  legs' handoff waits to ``mqtt_tpu_staging_leg_wait_seconds``, and host
  resolutions to the fallback counters. A sampled publish's stage clock
  (``submit(topic, clock)``) is stamped ``staging_wait`` when its batch
  forms; when the batch resolves, its ``BatchProfile`` splits the device
  trip into three stamps. ``h2d`` ends when the issue leg returns: the
  tokenizing, the index copies and the launch and the asynchronous D2H
  copy queued on the card's stream. ``device_dispatch`` ends when the
  resolver starts its wait on the copy's event, so it holds the time the
  batch sat queued behind the pipeline and whatever of the kernel the
  host did not wait for. ``d2h`` ends when ``torch.cuda.Event.synchronize``
  returns and the pinned buffer is read: the rest of the kernel and the
  transfer. A batch with no device window (the exact map, a host route,
  no profiler attached) is stamped ``device_batch`` whole.
- ``pressure()`` is the overload governor's ``staging`` signal: parked
  publishes over ``max_pending``, and the batch queue's fill at half
  weight.
- A failure on any leg (a kernel that fails to build or launch, a failed
  copy) is set on the affected batch's futures, so it reaches each
  publisher: a host path would move the work off the card without a
  word. The stage goes on with the next batch.
- Admission is BOUNDED (``max_pending``): under a publish storm the parked
  list never grows past its cap — overflow (and submissions whose
  projected pipeline wait already exceeds the deadline) resolves via the
  host walk at once.
- The window and the cap read each batch's service on the event loop's
  clock, as in the JAX stage: a batch's completion and its publishers'
  wake-ups run on the loop, so the loop's delay is part of what a bigger
  batch costs. The admission deadline reads the same leg timed on the
  resolve thread itself (the D2H wait and the materialization): the JAX
  stage reads the loop's clock there too, so a loop busy with the
  publishers' I/O trips its deadline although the device keeps up, and
  the host walk it diverts to runs on that same busy loop.

The restart leg (``bulk_register``, ``bulk_inflight``, ``bulk_retain``)
re-seats persisted subscriptions, inflight and retained messages in
fixed-size batches, one lock acquisition per chunk.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from .topics import Subscribers
from .utils.loopwitness import DEFAULT_LOOP_PLANE as _LOOP_PLANE

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
        telemetry=None,
    ) -> None:
        self.matcher = matcher
        # the telemetry plane (telemetry.Telemetry) or None: batch service
        # and fill histograms, the legs' handoff waits, the fallback
        # counters and the sampled stage clocks' stamps flow through it
        self.telemetry = telemetry
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
        # parked publishes: (topic, future, clock, feats, rjob). Guarded
        # by _plock: under the event-loop shard fabric (shards) submit()
        # runs on every shard's loop while the collector drains on the
        # stage's own loop. Futures are created on the SUBMITTING loop and
        # resolved back onto it (_resolve/_reject), so each publisher
        # awaits a loop-local future.
        self._pending: list[tuple] = []
        self._plock = threading.Lock()
        # the loop the collector and drainer run on (start()'s loop)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
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
        # the same leg timed on the resolve thread: the deadline's input
        self._resolve_ewma_s = 0.0
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

    def _observe_service(self, dt: float, n: int, depth: int, resolve_s: float) -> None:
        """Feed one batch's resolve wall time into the controller: grow
        the cap while service time is comfortably under budget, shrink it
        proportionally when a batch overruns. ``depth`` is the number of
        batches that were queued behind this one: the budget bounds
        depth x service, not one batch's service. ``resolve_s`` is the
        same leg on the resolve thread's clock, for the deadline."""
        self._ewma_s = dt if self._ewma_s == 0.0 else (
            0.7 * self._ewma_s + 0.3 * dt
        )
        self._resolve_ewma_s = resolve_s if self._resolve_ewma_s == 0.0 else (
            0.7 * self._resolve_ewma_s + 0.3 * resolve_s
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

    @property
    def batch_cap(self) -> int:
        """The current adaptive batch-size cap (<= max_batch)."""
        return self._batch_cap

    @property
    def pending_depth(self) -> int:
        return len(self._pending)

    def alive(self) -> bool:
        """Pipeline liveness for ``GET /healthz``: started, not stopping,
        and both loop tasks still running (a crashed collector or drainer
        would strand every parked publish)."""
        if self._stopping or self._wake is None:
            return False
        return bool(self._tasks) and all(not t.done() for t in self._tasks)

    def pressure(self) -> float:
        """Normalized staging pressure for the overload governor: parked
        admission depth against its cap, plus the batch queue's fill at
        half weight (a full queue is normal pipelining; sustained
        _pending growth is the real overload signal)."""
        p = len(self._pending) / self.max_pending
        q = 0.0
        if self._queue is not None and self.pipeline_depth > 0:
            q = self._queue.qsize() / self.pipeline_depth
        return max(p, 0.5 * q)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Create the collector/drainer tasks on the running loop."""
        loop = asyncio.get_running_loop()
        self._loop = loop
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
        with self._plock:
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

    def submit(self, topic: str, clock=None, feats=None, rjob=None) -> "asyncio.Future[Subscribers]":
        """Park one publish; the future resolves with its Subscribers.
        Any loop may call it: under the shard fabric every shard's loop
        does, and the future resolves on the caller's loop. ``clock`` is an
        optional sampled stage clock (telemetry.StageClock), stamped when
        the batch forms (``staging_wait``) and when it resolves. ``feats``
        is the publish's optional payload-feature carrier and ``rjob`` its
        optional decrypt job:
        their device results come back ON the carriers; a publish the host
        walk resolves leaves them unstamped (the fan-out's host paths
        decide).

        Admission is bounded: once ``max_pending`` publishes are parked,
        or the pipeline's projected wait already exceeds the deadline
        (2x the latency budget), the publish resolves immediately via
        the host walk instead of growing the backlog."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if _LOOP_PLANE.active:
            w = _LOOP_PLANE.witness
            if w is not None:
                w.note_crossing(
                    "match_stage", "submit_local", "submit_cross", self._loop
                )
        wake = self._wake
        if self._stopping or wake is None:
            fut.set_result(self.host_fallback(topic))
            return fut
        with self._plock:
            admitted = not (len(self._pending) >= self.max_pending or self._past_deadline())
            if admitted:
                self._pending.append((topic, fut, clock, feats, rjob))
                self.peak_pending = max(self.peak_pending, len(self._pending))
        if not admitted:
            self.admission_fallbacks += 1
            self._note_fallback("admission", 1)
            fut.set_result(self.host_fallback(topic))
            return fut
        # the wake Event is loop-affine: a shard loop's submission marshals
        # the set() onto the stage's loop. A never-started stage (_loop
        # None: a harness that drives the collector by hand) sets it here.
        if self._loop is None or loop is self._loop:
            wake.set()
        else:
            try:
                self._loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                # the stage's loop is gone mid-shutdown: walk it now
                if not fut.done():
                    fut.set_result(self.host_fallback(topic))
        return fut

    def _past_deadline(self) -> bool:
        """Deadline-aware admission: a new submission waits behind every
        queued batch plus every parked batch-worth of _pending; when that
        projected wait exceeds twice the latency budget, the host walk
        serves it now. The wait is projected from the resolve thread's
        EWMA: the device side's time, which the walk can save. An IDLE
        pipeline always admits, whatever the EWMA says (the estimate only
        heals through real dispatches)."""
        budget = self.latency_budget_s
        if budget is None or self._resolve_ewma_s <= 0.0:
            return False
        qdepth = self._queue.qsize() if self._queue is not None else 0
        if qdepth == 0 and not self._pending:
            return False  # idle: admit, and let the EWMA re-learn
        depth = 1 + qdepth + len(self._pending) // max(1, self._batch_cap)
        return depth * self._resolve_ewma_s > 2.0 * budget

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
            with self._plock:
                batch, self._pending = self._pending[:cap], self._pending[cap:]
                leftovers = bool(self._pending)
            if leftovers:
                wake.set()  # leftovers start the next window now
            # a caller future cancelled mid-window is dead weight
            batch = [item for item in batch if not item[1].cancelled()]
            if not batch:
                continue
            topics = [item[0] for item in batch]
            futs = [item[1] for item in batch]
            clocks = [item[2] for item in batch]
            feats = [item[3] for item in batch]
            rjobs = [item[4] for item in batch]
            for c in clocks:
                if c is not None:  # end of the accumulation/park wait
                    c.stamp("staging_wait")
            t_formed = time.perf_counter()
            matcher, predicates, recrypt = self.matcher, self.predicates, self.recrypt
            profiler, telemetry = self.profiler, self.telemetry

            def issue():
                if telemetry is not None:
                    # h2d-leg handoff wait: batch formed -> issue start
                    telemetry.observe_leg_wait("h2d", time.perf_counter() - t_formed)
                # the batch's OWN record: resolves on the executor (or the
                # breaker's guard threads) can never cross-attribute
                # another batch's windows
                rec = profiler.open_batch() if profiler is not None else None
                if rec is not None:
                    resolver = matcher.match_topics_async(topics, profile=rec)
                else:
                    resolver = matcher.match_topics_async(topics)
                pred_resolver = predicates.eval_batch_async(feats) if predicates is not None else None
                rec_resolver = recrypt.issue_batch(rjobs) if recrypt is not None else None
                return (resolver, pred_resolver, rec_resolver), rec

            loop = asyncio.get_running_loop()
            try:
                resolvers, rec = await loop.run_in_executor(self._h2d_executor, issue)
            except asyncio.CancelledError:
                # stop() cancelled us with this batch in hand: resolve it
                self._fallback_all(batch, klass="stop")
                raise
            except Exception as e:
                _log.exception("stage issue failed")
                self._fail_all(futs, e)
                continue
            t_ready = time.perf_counter()
            self.inflight_batches += 1
            try:
                await queue.put((resolvers, futs, topics, feats, clocks, rec, t_ready))
            except asyncio.CancelledError:
                self.inflight_batches -= 1
                self._fallback_all(batch, klass="stop")
                raise

    async def _drain_loop(self) -> None:
        loop = asyncio.get_running_loop()
        queue = self._queue
        assert queue is not None  # start() created us
        telemetry = self.telemetry
        while True:
            resolvers, futs, topics, feats, clocks, rec, t_ready = await queue.get()
            try:
                # the D2H waits block — run them off the loop, all three
                # legs in one executor call. Queue depth is sampled at
                # resolve time: batches still queued waited for this one,
                # so the controller budgets depth x service.
                depth = queue.qsize() + 1
                t0 = loop.time()

                def sync(resolvers=resolvers, t_ready=t_ready):
                    t_sync = time.perf_counter()
                    if telemetry is not None:
                        # d2h-leg handoff wait: issued (queued behind the
                        # pipeline) -> the resolve leg starts
                        telemetry.observe_leg_wait("d2h", t_sync - t_ready)
                    out = tuple(r() if r is not None else None for r in resolvers)
                    return out, time.perf_counter() - t_sync

                (results, pred_rows, rec_rows), resolve_s = await loop.run_in_executor(self._executor, sync)
                if pred_rows is not None:
                    self.predicates.attach_rows(feats, pred_rows)
                if rec_rows is not None:
                    self.recrypt.attach(rec_rows)
                dt = loop.time() - t0
                self.service_log.append((len(topics), dt))
                self._observe_service(dt, len(topics), depth, resolve_s)
                if telemetry is not None:
                    telemetry.observe_batch(dt, len(topics), self._batch_cap)
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
            # this batch's own device-timing record: both windows are set
            # only when the batch dispatched to the card and synced; the
            # exact map and the host routes leave them None, and the
            # coarse device_batch stamp applies
            dispatch = rec.dispatch if rec is not None else None
            d2h = rec.d2h if rec is not None else None
            for fut, subs, ck in zip(futs, results, clocks):
                if ck is not None:
                    if dispatch is not None and d2h is not None:
                        ck.stamp_until("h2d", dispatch[1])
                        ck.stamp_until("device_dispatch", d2h[0])
                        ck.stamp_until("d2h", d2h[1])
                    else:
                        ck.stamp("device_batch")
                self._resolve(fut, subs)

    def _settle(self, fut: "asyncio.Future", setter) -> None:
        """Complete one caller future ON ITS OWN LOOP: a future parked by
        a shard loop's submitter must not be completed from the stage's
        loop (its done-callbacks would run on the wrong thread). A future
        of the stage's loop completes inline."""
        loop = fut.get_loop()
        local = self._loop is None or loop is self._loop
        if _LOOP_PLANE.active:
            w = _LOOP_PLANE.witness
            if w is not None:
                w.note(
                    "match_stage",
                    "resolve_local" if local else "resolve_marshal",
                )

        def _set() -> None:
            if not fut.done():
                setter()

        if local:
            _set()
            return
        try:
            loop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass  # the submitter's loop closed; nobody is awaiting

    def _resolve(self, fut: "asyncio.Future", value) -> None:
        self._settle(fut, lambda: fut.set_result(value))

    def _reject(self, fut: "asyncio.Future", exc: BaseException) -> None:
        self._settle(fut, lambda: fut.set_exception(exc))

    def _fail_all(self, futs, exc: BaseException) -> None:
        for fut in futs:
            self._reject(fut, exc)

    def _note_fallback(self, klass: str, n: int) -> None:
        self.fallbacks[klass] = self.fallbacks.get(klass, 0) + n
        if self.telemetry is not None:
            self.telemetry.note_fallback(klass, n)

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
                self._resolve(fut, self.host_fallback(topic))
            except Exception as e:  # pragma: no cover - host walk is total
                self._reject(fut, e)
        if n:
            self._note_fallback(klass, n)


# -- restart re-registration (the durable session plane's bulk path) ---------


def bulk_register(topics, entries, batch: int = 4096) -> tuple[int, int]:
    """Re-register persisted subscriptions through the trie's bulk-insert
    path in fixed-size batches, the restart leg of the durable session
    plane. ``entries`` yield ``(client_id, Subscription)``;
    each chunk of ``batch`` pays ONE trie lock acquisition via
    ``TopicsIndex.subscribe_bulk`` instead of a per-subscription
    ``subscribe`` round-trip, which is the difference between a bounded
    and an unbounded restart at a million sessions. Returns
    ``(new_subscriptions, batches)`` so recovery metrics can prove the
    path was actually batched."""
    added = 0
    batches = 0
    chunk: list = []
    for entry in entries:
        chunk.append(entry)
        if len(chunk) >= batch:
            added += topics.subscribe_bulk(chunk)
            batches += 1
            chunk = []
    if chunk:
        added += topics.subscribe_bulk(chunk)
        batches += 1
    return added, batches


def bulk_inflight(clients, messages, batch: int = 4096) -> tuple[int, int]:
    """Restore persisted inflight (QoS1/QoS2 window) messages in
    fixed-size per-client batches via ``Inflight.set_bulk``: one lock
    acquisition per chunk, mirroring :func:`bulk_register` (the unacked
    window survives a kill through the same batched restart leg as
    subscriptions and retained). ``messages``
    yield storage ``Message`` records (``.client`` + ``.to_packet()``);
    records for clients with no live session are skipped (their session
    re-inflates them on reconnect via the subscription restore path).
    Returns ``(restored, batches)``."""
    restored = 0
    batches = 0
    per_client: dict = {}
    for msg in messages:
        cl = clients.get(msg.client)
        if cl is None:
            continue
        chunk = per_client.setdefault(msg.client, (cl, []))[1]
        chunk.append(msg.to_packet())
        if len(chunk) >= batch:
            restored += cl.state.inflight.set_bulk(chunk)
            batches += 1
            chunk.clear()
    for cl, chunk in per_client.values():
        if chunk:
            restored += cl.state.inflight.set_bulk(chunk)
            batches += 1
    return restored, batches


def bulk_retain(topics, packets, batch: int = 4096) -> tuple[int, int]:
    """Re-seat persisted retained messages in fixed-size batches via
    ``TopicsIndex.retain_bulk`` (one lock acquisition per chunk).
    Returns ``(retained, batches)``."""
    retained = 0
    batches = 0
    chunk: list = []
    for pk in packets:
        chunk.append(pk)
        if len(chunk) >= batch:
            retained += topics.retain_bulk(chunk)
            batches += 1
            chunk = []
    if chunk:
        retained += topics.retain_bulk(chunk)
        batches += 1
    return retained, batches
