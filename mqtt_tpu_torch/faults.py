"""Deterministic fault injection for the device matcher and worker mesh.

A copy of the JAX package's ``mqtt_tpu/faults.py``: the same plans, the
same rng streams draw for draw (one seed gives one schedule in both
packages), over the port's matcher, LogKV store and cluster. One
departure: an ``error`` fault runs the wrapped resolver before it raises,
so a batch of ``TorchMatcher``'s compact route drops the pin it holds on
its table buffer (``ops.matcher``; the JAX matcher holds no pin, and its
injector never runs the resolver). The caller sees the same failure.

The resilience layer (``resilience``) exists to survive hardware
that flaps; this module is how the chaos tests and the chaos hook
(``hooks.chaos``) make a healthy machine behave like that hardware —
reproducibly, from one seed:

- :class:`FaultPlan` — a seeded schedule mapping dispatch index -> fault
  kind, either by per-kind probability or by explicit indices, so a
  failing chaos run replays exactly from its seed.
- :class:`FaultyMatcher` — wraps any matcher exposing
  ``match_topics_async`` and injects the scheduled fault into the issue
  or resolve side of each dispatch:

  * ``issue_error`` — ``match_topics_async`` itself raises;
  * ``error``       — the returned resolver raises (after running the
    wrapped resolver, whose result it drops);
  * ``hang``        — the resolver blocks (releasable, so suites can
    un-wedge abandoned guard threads at teardown);
  * ``slow``        — the resolver sleeps ``slow_s`` then resolves (a
    degraded-but-alive link: must NOT trip the breaker);
  * ``corrupt``     — the resolver returns real results with one
    deterministically-chosen entry falsified (must be caught by the
    degradation manager's differential re-walk).

- Mesh helpers — :func:`sever_peer_link` kills a live peer link
  mid-traffic; :func:`stall_peer_reads` gates a worker's mesh reads
  shut so its peers' write buffers back up against ``MAX_PEER_BUFFER``;
  :func:`asymmetric_partition` loses one peer's return path only (the
  peer-health SUSPECT/PARTITIONED drill); :func:`lose_gossip` drops a
  seeded fraction of inbound pressure-gossip frames (the federation
  signal's decay/TTL drill); :class:`FlapPlan`/:func:`drive_link_flaps`
  run a seeded, bounded link-flap storm over whatever link set the
  fabric holds (all-pairs or spanning tree); :func:`partition_peers`
  cuts a whole peer SET at once (the subtree-partition shape the tree's
  scoped re-election exists for); :class:`LinkShape` /
  :func:`shape_cluster_links` impose a seeded WAN profile (latency,
  jitter, loss, bandwidth) on chosen inbound edges — netem semantics
  with no netem, so cross-machine conditions reproduce in tests on one
  box.

- :class:`StormPlan` — a seeded publish-storm schedule (publisher ->
  topic/payload/qos sequence, deterministic from the seed) plus
  :func:`drive_storm`, the async driver that blasts the schedule through
  raw writers at an offered load far above sustainable. The stress
  driver's storm (``stress.run_storm``) replays these plans against the
  overload governor (``overload``).

- Durable-store crash plans — :class:`StorageCrashPlan` kills a
  :class:`~mqtt_tpu_torch.hooks.storage.logkv.LogKVStore` at a seeded append
  index or named crash point (rotation / snapshot / compaction), with a
  torn-write mode that leaves a seeded PREFIX of the record on disk;
  :func:`lose_unsynced` models power-loss page-cache loss by truncating
  the active segment to its fsync watermark; :func:`tear_tail` /
  :func:`dup_last_segment` mutate segment files directly. A replay
  test drives every point and asserts the reopened map is bit-identical
  to the durable state.

Only test/ops tooling imports this module; nothing on the hot path
references it.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from .packets import Subscription

FAULT_KINDS = ("hang", "error", "issue_error", "corrupt", "slow")

# the falsified client id a corrupt fault plants; never a real client
CHAOS_CLIENT = "\x00chaos"


class DeviceFault(RuntimeError):
    """The injected dispatch failure."""


@dataclass
class FaultPlan:
    """A deterministic fault schedule.

    ``at`` pins explicit dispatch indices to fault kinds (checked first);
    the ``*_rate`` fields draw per-dispatch from a ``random.Random(seed)``
    stream, so a given (seed, rates) pair always yields the same fault
    sequence regardless of wall clock or interleaving.
    """

    seed: int = 0
    hang_rate: float = 0.0
    error_rate: float = 0.0
    issue_error_rate: float = 0.0
    corrupt_rate: float = 0.0
    slow_rate: float = 0.0
    hang_s: float = 30.0
    slow_s: float = 0.05
    at: dict[int, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        for kind in self.at.values():
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind: {kind}")

    def draw(self, dispatch_index: int) -> Optional[str]:
        """The fault for this dispatch, or None. The rng stream advances
        exactly once per call, keeping the schedule a pure function of
        (seed, call sequence)."""
        r = self._rng.random()
        pinned = self.at.get(dispatch_index)
        if pinned is not None:
            return pinned
        for kind, rate in (
            ("hang", self.hang_rate),
            ("error", self.error_rate),
            ("issue_error", self.issue_error_rate),
            ("corrupt", self.corrupt_rate),
            ("slow", self.slow_rate),
        ):
            if r < rate:
                return kind
            r -= rate
        return None


class FaultyMatcher:
    """A matcher wrapper that injects :class:`FaultPlan` faults into
    every dispatch. Unknown attributes delegate to the wrapped matcher,
    so it interposes transparently under the degradation manager
    (``ResilientMatcher.inner``) or directly under the staging loop."""

    def __init__(self, inner: Any, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        self.dispatches = 0
        self.injected: dict[str, int] = {}
        self._lock = threading.Lock()
        # hung resolvers block on this (bounded by plan.hang_s): suites
        # release it at teardown so abandoned guard threads retire
        self.release = threading.Event()
        # hung resolvers still running: each holds its batch's table pin
        # until it returns (wait_released)
        self._hung = 0
        self._idle = threading.Condition(self._lock)

    def __getattr__(self, name: str) -> Any:
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1

    def match_topics_async(
        self, topics: list[str], profile: Optional[Any] = None
    ) -> Callable[[], Any]:
        with self._lock:
            i = self.dispatches
            self.dispatches += 1
        fault = self.plan.draw(i)
        if fault == "issue_error":
            self._count(fault)
            raise DeviceFault(f"injected issue failure (dispatch {i})")
        # forward the per-batch profile record (tracing) only
        # when one was passed — inner doubles without the kwarg keep
        # working
        if profile is None:
            resolver = self.inner.match_topics_async(topics)
        else:
            resolver = self.inner.match_topics_async(topics, profile=profile)
        if fault is None:
            return resolver
        self._count(fault)
        if fault == "error":

            def failing():
                # run the real resolver first: a compact-route batch keeps
                # its table buffer pinned until its resolver has run, and
                # an injected failure must not leave that pin behind
                try:
                    resolver()
                except Exception:  # noqa: BLE001 - the injected failure is what the caller sees
                    pass
                raise DeviceFault(f"injected resolve failure (dispatch {i})")

            return failing
        if fault == "hang":

            def hanging():
                with self._lock:
                    self._hung += 1
                try:
                    self.release.wait(self.plan.hang_s)
                    return resolver()
                finally:
                    with self._idle:
                        self._hung -= 1
                        self._idle.notify_all()

            return hanging
        if fault == "slow":

            def slow():
                time.sleep(self.plan.slow_s)
                return resolver()

            return slow

        # corrupt: plausible results with one entry falsified — the shape
        # a bitrotted table or torn upload produces. The corrupted index
        # derives from the dispatch index, not the rng stream, so the
        # schedule stays replayable.
        def corrupting():
            results = resolver()
            if results:
                j = i % len(results)
                topic = topics[j] if j < len(topics) and topics[j] else "chaos"
                results[j].subscriptions[CHAOS_CLIENT] = Subscription(
                    filter=topic, qos=0
                )
            return results

        return corrupting

    def match_topics(self, topics: list[str]) -> Any:
        return self.match_topics_async(topics)()

    def wait_released(self, timeout: Optional[float] = None) -> bool:
        """Block until no hung resolver is still running (set ``release``
        first); each one that returns has run its batch's resolver and so
        dropped its table pin. False when ``timeout`` passes first."""
        with self._idle:
            return self._idle.wait_for(lambda: self._hung == 0, timeout)


# -- durable-store crash plans ----------------------------------------------

STORAGE_CRASH_POINTS = (
    "rotate",
    "snapshot.begin",
    "snapshot.rename",
    "snapshot.prune",
    "compact.rewrite",
    "compact.prune",
)


@dataclass
class StorageCrashPlan:
    """A deterministic kill schedule for the log-structured store.

    Attach to ``LogKVStore.crash_plan``; the store consults it at every
    append (``append_record``) and at the named maintenance points
    (``reach``). The plan raises
    :class:`~mqtt_tpu_torch.hooks.storage.logkv.SimulatedCrash` at its chosen
    kill point — the test then abandons the store (no ``stop()``, the
    kill -9 shape) and asserts a fresh open replays to the expected map.

    ``crash_at_op`` kills at the Nth append since attach; with ``torn``
    set, a seeded prefix of the record reaches the file first (the
    torn-write shape replay's CRC/EOF checks exist for). ``crash_point``
    kills at the ``point_hits``-th arrival at a named point instead —
    e.g. between a compaction's rewrite and its prune, where old and new
    segments overlap on disk.
    """

    seed: int = 0
    crash_at_op: int = -1
    torn: bool = False
    crash_point: str = ""
    point_hits: int = 1

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self.appends_seen = 0
        self.points_seen: dict[str, int] = {}
        if self.crash_point and self.crash_point not in STORAGE_CRASH_POINTS:
            raise ValueError(f"unknown crash point: {self.crash_point}")

    def append_record(self, store: Any, rec: bytes) -> None:
        from .hooks.storage.logkv import SimulatedCrash

        i = self.appends_seen
        self.appends_seen += 1
        if i != self.crash_at_op:
            return
        if self.torn and len(rec) > 1:
            # the torn write: a seeded strict prefix hits the platter
            cut = 1 + self._rng.randrange(len(rec) - 1)
            store._file.write(rec[:cut])
            store._file.flush()
        raise SimulatedCrash(f"injected kill at append {i} (torn={self.torn})")

    def reach(self, point: str, store: Any) -> None:
        from .hooks.storage.logkv import SimulatedCrash

        n = self.points_seen.get(point, 0) + 1
        self.points_seen[point] = n
        if point == self.crash_point and n == self.point_hits:
            raise SimulatedCrash(f"injected kill at {point} (hit {n})")


def lose_unsynced(store: Any) -> int:
    """Power-loss page-cache loss: truncate the ACTIVE segment back to
    its last-fsync watermark (``synced_bytes``), as a kernel that never
    flushed would. Returns the number of bytes lost. Under the
    ``always`` policy this loses nothing; under ``batch`` at most one
    flush interval; under ``off`` the whole active segment."""
    import os

    path = store._active_path
    try:
        store._file.close()
    except (OSError, ValueError, AttributeError):
        pass
    size = os.path.getsize(path)
    keep = min(store.synced_bytes, size)
    os.truncate(path, keep)
    return size - keep


def tear_tail(dir_path: str, nbytes: int = 0, seed: int = 0) -> str:
    """Tear the newest segment's tail: drop ``nbytes`` from its end (a
    seeded 1..18 — inside the last record's frame — when 0). Returns the
    torn segment's filename."""
    import os

    from .hooks.storage.logkv import _segments

    name = _segments(dir_path)[-1]
    p = os.path.join(dir_path, name)
    size = os.path.getsize(p)
    if nbytes <= 0:
        nbytes = 1 + random.Random(seed).randrange(18)
    os.truncate(p, max(0, size - nbytes))
    return name


def dup_last_segment(dir_path: str) -> str:
    """Duplicate the NEWEST segment at the next sequence number — the
    crash shape where a rotation/copy completed but the original was
    never retired. Replaying the same record suffix twice is convergent
    (records carry absolute values); duplicating an OLDER segment would
    not be, which is why only this shape occurs in practice. Returns the
    duplicate's filename."""
    import os

    from .hooks.storage.logkv import _seg_seq, _segments

    name = _segments(dir_path)[-1]
    dup = f"seg{_seg_seq(name) + 1:06d}.log"
    with open(os.path.join(dir_path, name), "rb") as src:
        data = src.read()
    with open(os.path.join(dir_path, dup), "wb") as dst:
        dst.write(data)
    return dup


# -- publish storms ----------------------------------------------------------


@dataclass
class StormPlan:
    """A deterministic publish-storm schedule.

    ``schedule()`` expands to per-publisher lists of
    ``(seq, topic, payload, qos)`` — a pure function of the plan fields,
    so a failing storm run replays exactly from its seed. Payloads embed
    the publisher index and sequence number, which lets the receiving
    side match deliveries back to offered messages (latency/loss
    accounting without any side channel)."""

    seed: int = 0
    publishers: int = 8
    msgs_per_publisher: int = 100
    topic_space: int = 16
    topic_prefix: str = "storm"
    qos1_fraction: float = 0.5
    payload_pad: int = 0

    def schedule(self) -> list[list[tuple[int, str, bytes, int]]]:
        rng = random.Random(self.seed)
        plans: list[list[tuple[int, str, bytes, int]]] = []
        pad = b"x" * self.payload_pad
        for p in range(self.publishers):
            msgs = []
            for m in range(self.msgs_per_publisher):
                topic = (
                    f"{self.topic_prefix}/p{p}/"
                    f"t{rng.randrange(self.topic_space)}"
                )
                qos = 1 if rng.random() < self.qos1_fraction else 0
                msgs.append((m, topic, f"s{p}-{m}|".encode() + pad, qos))
            plans.append(msgs)
        return plans


async def drive_storm(
    writers: Iterable[Any],
    plan: StormPlan,
    burst: int = 16,
    pause_s: float = 0.0,
    version: int = 5,
    stamp_times: Optional[dict] = None,
) -> dict:
    """Blast ``plan``'s schedule through the given per-publisher
    ``asyncio.StreamWriter``s as fast as the sockets accept it (offered
    load >> sustainable — the storm the overload governor exists for).
    QoS1 packet ids are sequential per publisher starting at 1; the
    caller owns reading the acks. ``stamp_times`` (payload tag ->
    perf_counter) records per-message send times for latency accounting.
    Returns offered-traffic accounting."""
    import asyncio

    from .packets import PUBLISH, FixedHeader, Packet, encode_packet

    schedules = plan.schedule()
    offered = {"qos0": 0, "qos1": 0}

    async def blast(writer, msgs) -> None:
        pid = 0
        buf = bytearray()
        for i, (seq, topic, payload, qos) in enumerate(msgs):
            if qos:
                pid += 1
            buf += encode_packet(
                Packet(
                    fixed_header=FixedHeader(type=PUBLISH, qos=qos),
                    protocol_version=version,
                    topic_name=topic,
                    packet_id=pid if qos else 0,
                    payload=payload,
                )
            )
            offered["qos1" if qos else "qos0"] += 1
            if stamp_times is not None:
                stamp_times[payload.split(b"|", 1)[0]] = time.perf_counter()
            if (i + 1) % burst == 0:
                writer.write(bytes(buf))
                buf.clear()
                await writer.drain()
                if pause_s:
                    await asyncio.sleep(pause_s)
        if buf:
            writer.write(bytes(buf))
            await writer.drain()

    await asyncio.gather(
        *(blast(w, msgs) for w, msgs in zip(writers, schedules))
    )
    offered["total"] = offered["qos0"] + offered["qos1"]
    return offered


# -- worker-mesh faults ------------------------------------------------------


def sever_peer_link(cluster: Any, peer: int) -> bool:
    """Abort the live link to ``peer`` (connection-reset mid-traffic, as
    a crashed worker or yanked cable would). Returns False when no link
    is up. The surviving side must withdraw the peer's presence and the
    dial side must reconnect with backoff (cluster._dial)."""
    writer = cluster._writers.get(peer)
    if writer is None:
        return False
    writer.transport.abort()
    return True


def asymmetric_partition(cluster: Any, peer: int) -> Callable[[], None]:
    """An ASYMMETRIC partition of one link: ``cluster`` silently loses
    everything ``peer`` sends it (pongs included) while its own writes
    keep succeeding — the lost-return-path failure a dead switch port or
    a one-way firewall rule produces. ``cluster``'s ping loop then sees
    unanswered pings and must walk the peer through SUSPECT (QoS>0
    forwards parked) toward PARTITIONED; a plain severed link would
    instead error the socket immediately. Returns release()."""
    return partition_peers(cluster, {peer})


def lose_gossip(cluster: Any, rate: float, seed: int = 0) -> Callable[[], None]:
    """Seeded gossip loss: ``cluster`` drops each inbound pressure-gossip
    frame with probability ``rate`` (deterministic from the seed), while
    data/presence/ping traffic flows untouched — the degraded-telemetry
    plan the federation signal's decay/TTL machinery exists for. Returns
    release()."""
    from .cluster import _T_GOSSIP

    rng = random.Random(seed)
    prev = cluster._rx_filter

    def drop_gossip(p: int, mtype: int, payload: bytes) -> bool:
        if mtype == _T_GOSSIP and rng.random() < rate:
            return False
        return prev is None or prev(p, mtype, payload)

    cluster._rx_filter = drop_gossip

    def release() -> None:
        if cluster._rx_filter is drop_gossip:
            cluster._rx_filter = prev

    return release


@dataclass
class FlapPlan:
    """A seeded link-flap schedule: sever one random LIVE
    link every ``interval_s`` (jittered) for ``duration_s``, then stop —
    so a drill has a storm phase and a guaranteed heal phase. The plan
    is topology-agnostic by construction: it draws from whatever link
    set the fabric currently holds, so the same plan drives the
    all-pairs mesh and the spanning tree (where a severed link is a
    severed tree EDGE and the heal path includes re-election).

    A plain sever heals on the next re-dial (tens of ms) — enough to
    exercise park/replay but never the partition machinery. With
    ``partition_rate`` > 0, that fraction of draws instead CUTS the peer
    for ``partition_hold_s``: inbound frames from it are dropped (pongs
    included) while the hold lasts, so the health clock walks the edge
    through SUSPECT to PARTITIONED and, in tree mode, fires the scoped
    re-election — a real partition storm, not just flaps. Every hold is
    released by the end of the schedule: heal is guaranteed."""

    seed: int = 0
    interval_s: float = 0.5
    duration_s: float = 5.0
    jitter: float = 0.5  # +/- fraction of interval per draw
    partition_rate: float = 0.0
    partition_hold_s: float = 2.0


async def drive_link_flaps(cluster: Any, plan: FlapPlan) -> int:
    """Run one worker's flap schedule to completion; returns the number
    of links actually disturbed. Draws are deterministic from the seed;
    which PEER each draw lands on depends on the live link set at that
    instant (the healing mesh decides), so the schedule is reproducible
    while the storm stays adversarial. The hold set is managed by ONE
    rx filter installed for the schedule's lifetime and removed in a
    finally — out-of-order releases can never leak a permanent cut."""
    rng = random.Random(plan.seed)
    disturbed = 0
    cut: dict = {}  # peer -> hold release deadline (monotonic)
    prev = cluster._rx_filter

    def flap_filter(p: int, mtype: int, payload: bytes) -> bool:
        if p in cut:
            return False
        return prev is None or prev(p, mtype, payload)

    cluster._rx_filter = flap_filter
    try:
        deadline = time.monotonic() + plan.duration_s
        while time.monotonic() < deadline:
            pause = plan.interval_s * (
                1 + plan.jitter * (2 * rng.random() - 1)
            )
            await _asyncio_sleep(
                min(pause, max(0.0, deadline - time.monotonic()))
            )
            now = time.monotonic()
            for p in [p for p, t in cut.items() if t <= now]:
                del cut[p]  # hold expired: the edge may heal
            peers = sorted(cluster._writers)
            if not peers:
                continue
            peer = rng.choice(peers)
            if rng.random() < plan.partition_rate:
                cut[peer] = now + plan.partition_hold_s
                sever_peer_link(cluster, peer)
                disturbed += 1
            elif sever_peer_link(cluster, peer):
                disturbed += 1
        # drain the remaining holds so the schedule ENDS healed
        while cut:
            now = time.monotonic()
            horizon = max(cut.values())
            await _asyncio_sleep(max(0.05, horizon - now))
            now = time.monotonic()
            for p in [p for p, t in cut.items() if t <= now]:
                del cut[p]
    finally:
        if cluster._rx_filter is flap_filter:
            cluster._rx_filter = prev
    return disturbed


async def _asyncio_sleep(s: float) -> None:
    import asyncio

    await asyncio.sleep(s)


def partition_peers(cluster: Any, peers: Iterable[int]) -> Callable[[], None]:
    """Partition ``cluster`` from a SET of peers at once — the
    subtree-cut shape: every inbound frame from any of them is lost
    (pongs included) while writes keep succeeding, so the per-edge
    health clocks walk all the cut edges through SUSPECT toward
    PARTITIONED together and, in tree mode, the scoped re-election
    excises the whole unreachable side. Returns release()."""
    cut = frozenset(peers)
    prev = cluster._rx_filter

    def drop_from_cut(p: int, mtype: int, payload: bytes) -> bool:
        if p in cut:
            return False
        return prev is None or prev(p, mtype, payload)

    cluster._rx_filter = drop_from_cut

    def release() -> None:
        if cluster._rx_filter is drop_from_cut:
            cluster._rx_filter = prev

    return release


@dataclass
class LinkShape:
    """A seeded WAN profile for one direction of a peer link:
    propagation delay + uniform jitter, segment loss probability, and a
    serialization bandwidth — everything netem would shape, reproducible
    on one box from one seed with no root and no qdiscs.

    The shaper models a TCP path, not a raw lossy wire: frames arrive IN
    ORDER (each link's delivery horizon only moves forward, so a slow
    frame head-of-line-blocks everything behind it exactly as a single
    TCP stream would), and a "lost" DATA frame is delivered late — one
    retransmit penalty (``retransmit_s``, defaulting to
    ``max(0.2, 2 * delay_s)``, the RTO shape) — because TCP retransmits;
    only idempotent CONTROL frames (pings, gossip, epoch digests — all
    re-sent every tick by design) are actually dropped, which is what
    keeps loss observable without ever violating the mesh's reliable-
    stream assumptions.

    Crucially, propagation delay is LATENCY, not OCCUPANCY: delayed
    frames are handed to a per-link drainer task and the read loop moves
    on, so a 25ms-delay link still carries arbitrarily many frames in
    flight (sleeping inline would cap a shaped link at 1/delay frames/s
    and melt the mesh's ping clock under drill load — a WAN does not do
    that). Only ``rate_bytes_s`` consumes link time per byte."""

    seed: int = 0
    delay_s: float = 0.0  # one-way propagation delay (RTT/2 per direction)
    jitter_s: float = 0.0  # uniform [0, jitter_s) added per frame
    loss: float = 0.0  # per-frame loss probability
    rate_bytes_s: float = 0.0  # serialization bandwidth (0 = unlimited)
    retransmit_s: float = 0.0  # data-frame loss penalty (0 = RTO default)


def shape_cluster_links(
    cluster: Any, shape: LinkShape, peers: Optional[Iterable[int]] = None
) -> Callable[[], None]:
    """Install ``shape`` on ``cluster``'s INBOUND links from ``peers``
    (every peer when None) — the cross-"machine" half of a drill splits
    the worker set into groups and shapes only inter-group edges. Frames
    from unshaped peers chain to any previously installed shaper, so
    per-edge profiles stack. Per-(receiver, sender) rng streams derive
    from (seed, worker, peer): the same storm replays exactly from its
    seed, whatever the interleaving. Returns release()."""
    import asyncio

    from .cluster import _CONTROL_TYPES

    sel = None if peers is None else frozenset(peers)
    rngs: dict[int, random.Random] = {}
    clocks: dict[int, float] = {}  # per-link serialization horizon
    queues: dict[int, deque] = {}  # per-link (deliver_at, mtype, payload)
    wakeups: dict[int, asyncio.Event] = {}
    drainers: dict[int, asyncio.Task] = {}
    horizons: dict[int, float] = {}  # per-link in-order delivery horizon
    prev = cluster._rx_shaper

    async def _drain(p: int) -> None:
        """Deliver peer ``p``'s delayed frames in order at their
        scheduled times — off the read loop, so delay never throttles
        the link. The arrival-time rx filter still applies (a frame in
        flight when a partition lands is swallowed by the cut)."""
        q = queues[p]
        ev = wakeups[p]
        while not getattr(cluster, "_stopping", False):
            if not q:
                ev.clear()
                try:
                    # the timeout is an exit poll (cluster stopped with
                    # the link idle), not a delivery cadence
                    await asyncio.wait_for(ev.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            at, mtype, payload = q[0]
            lag = at - time.monotonic()
            if lag > 0:
                await asyncio.sleep(lag)
            q.popleft()
            rx = cluster._rx_filter
            if rx is None or rx(p, mtype, payload):
                cluster._rx_dispatch(p, mtype, payload)

    async def shaped(p: int, mtype: int, payload: bytes) -> bool:
        if sel is not None and p not in sel:
            return prev is None or await prev(p, mtype, payload)
        rng = rngs.get(p)
        if rng is None:
            rng = rngs[p] = random.Random(
                (shape.seed << 24) ^ (cluster.worker_id << 12) ^ p
            )
        delay = shape.delay_s
        if shape.jitter_s > 0:
            delay += shape.jitter_s * rng.random()
        if shape.rate_bytes_s > 0:
            now = time.monotonic()
            horizon = max(clocks.get(p, 0.0), now)
            horizon += (len(payload) + 5) / shape.rate_bytes_s
            clocks[p] = horizon
            delay += horizon - now
        if shape.loss > 0 and rng.random() < shape.loss:
            if mtype in _CONTROL_TYPES:
                return False  # idempotent, re-sent next tick: really lost
            # data frames ride a reliable stream: late, never lost
            delay += shape.retransmit_s or max(0.2, 2 * shape.delay_s)
        if delay <= 0:
            return True
        # in-order: the link's horizon only moves forward, so jitter (or
        # a retransmit penalty) delays everything BEHIND it too, exactly
        # like head-of-line blocking on one TCP stream
        at = max(horizons.get(p, 0.0), time.monotonic() + delay)
        horizons[p] = at
        if p not in queues:
            queues[p] = deque()
            wakeups[p] = asyncio.Event()
            drainers[p] = asyncio.get_running_loop().create_task(_drain(p))
        queues[p].append((at, mtype, payload))
        wakeups[p].set()
        return False  # the drainer owns this frame now

    cluster._rx_shaper = shaped

    def release() -> None:
        if cluster._rx_shaper is shaped:
            cluster._rx_shaper = prev
        for t in drainers.values():
            t.cancel()
        drainers.clear()
        queues.clear()

    return release


def stall_peer_reads(cluster: Any) -> Callable[[], None]:
    """Gate ``cluster``'s mesh reads shut: frames from every peer queue
    in the socket until the returned release() is called, so the peers'
    write buffers climb toward MAX_PEER_BUFFER (the backpressure-drop /
    wedged-link-close paths). Must be called on the cluster's loop."""
    import asyncio

    gate = asyncio.Event()
    inner_recv = type(cluster)._recv

    async def gated(reader):
        await gate.wait()
        return await inner_recv(reader)

    cluster._recv = gated  # instance attribute shadows the staticmethod

    def release() -> None:
        try:
            del cluster._recv
        except AttributeError:
            pass
        gate.set()

    return release


def drop_fleet(writers: list, k: int, seed: int) -> list:
    """Seeded mass disconnect: abruptly close ``k`` of the
    fleet's client transports in one tick — no DISCONNECT packet, the
    TCP-RST shape a power failure or network cut leaves behind, so every
    victim's will fires (or delays) server-side. ``writers`` are the
    CLIENT-side StreamWriters (or anything carrying ``.transport``);
    returns the chosen indices, sorted, drawn from ``seed`` so the
    will-storm and reconnect scenarios replay exactly.

    The close is ``transport.abort()`` — never ``close()``, which would
    flush and read as a graceful teardown."""
    rng = random.Random(seed)
    n = len(writers)
    k = max(0, min(k, n))
    victims = sorted(rng.sample(range(n), k))
    for i in victims:
        w = writers[i]
        tr = getattr(w, "transport", None) or w
        try:
            tr.abort()
        except (OSError, RuntimeError):  # already-dead victim: no-op
            pass
    return victims
