"""Broker-wide overload control plane: admission, backpressure, and
graceful load shedding under publish storms.

A copy of the JAX package's ``mqtt_tpu/overload.py``. The matcher's
breaker (resilience) protects the broker against a *faulty* device; this
module protects it against *too much healthy traffic*: brokers fail by
OOM and latency collapse — not clean errors — under sustained overload,
so every layer that can accumulate unbounded work reports a pressure
signal here and obeys the governor's verdict:

- An explicit NORMAL -> THROTTLE -> SHED state machine driven by the MAX
  of normalized pressure signals (staging pending depth + batch queue,
  aggregate client outbound backlog, cluster peer-buffer occupancy,
  RSS watermark). Transitions use hysteresis bands — escalation is
  immediate at the ``*_enter`` thresholds, de-escalation requires the
  pressure to fall below the lower ``*_exit`` threshold AND a minimum
  dwell, so a storm flapping around one threshold cannot make the broker
  oscillate between postures.
- THROTTLE pauses reads from persistently over-quota publishers
  (``read_delay``): the kernel's TCP window then backpressures the
  publisher — the same lever v5 receive-maximum gives for QoS>0 flows,
  extended to QoS0 (which receive-maximum cannot touch).
- SHED admits a bounded per-client budget per evaluation window
  (``admit``) and sheds the excess gracefully: QoS0 is dropped
  (counted), QoS1/2 is acked with v5 reason 0x97 Quota Exceeded —
  a clean error instead of latency collapse. Slow consumers whose
  outbound queue stays full past ``eviction_grace_s`` are evicted with
  DISCONNECT 0x97 (``evict_due`` + the server's sweep), freeing their
  backlog. The cluster's QoS0 forward tier sheds at a reduced
  peer-buffer cap (``qos0_forward_fraction``); control traffic
  (presence) never sheds.

Mesh federation extends the plane across workers: peer
gossip observations fold into a decayed-max ``peers`` pressure signal
(:class:`PeerPressureSignal` — a shedding peer raises this worker's
posture too), new CONNECTs are refused at the listener while
THROTTLE/SHED (``admit_connect``, CONNACK 0x97, with a small
always-admit reserve for admin-ACL clients), and the per-client shed
and publish quotas are weighted by a config-driven priority class
(``priority_weights`` — storming low-priority publishers shed first).

State, transition counts, sheds, evictions, and per-signal pressures
surface as ``$SYS/broker/overload/...`` gauges (server.publish_sys_topics).
All knobs are ``Options.overload_*`` fields and config-file keys; the
governor is ON by default — an unprotected broker wedges by OOM, a
governed one degrades predictably.

A worker of the cluster (``cluster.Cluster``) turns federation on when it
attaches (``Options.overload_federation``): its pressure gossip feeds
``PeerPressureSignal`` and the peers' reserve spend the mesh reserve.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

_log = logging.getLogger("mqtt_tpu_torch.overload")

# governor states (exported as $SYS gauges; the ints are stable codes)
NORMAL = "normal"
THROTTLE = "throttle"
SHED = "shed"
_STATE_CODES = {NORMAL: 0, THROTTLE: 1, SHED: 2}


class PeerPressureSignal:
    """The mesh-federation pressure signal (cluster gossip):
    each peer worker's advertised governor state + scalar pressure is
    folded into ONE normalized signal — the decayed max over recent
    gossip — so a shedding peer raises this whole worker's posture.

    - A peer advertising SHED/THROTTLE contributes at least the state's
      floor (a peer deep in SHED may report a pressure its own signals
      have already shed back down; the STATE is the stronger fact).
    - Contributions decay linearly to zero over ``ttl_s`` and stale
      entries age out entirely, so a worker that stopped gossiping
      (dead, partitioned) cannot pin the mesh's posture forever.
    - The whole signal is scaled by ``weight`` < 1: one shedding peer
      raises the mesh to THROTTLE, not to a full sympathetic SHED
      cascade (the defaults put a SHED advert at 0.9 * 0.95 = 0.855 —
      above throttle_enter, below shed_enter).

    Thread-safe: gossip arrives on the cluster's read loops, the
    governor samples from evaluate().
    """

    # minimum advertised-state contributions (keyed by state code)
    STATE_FLOORS = {1: 0.75, 2: 0.95}

    def __init__(
        self,
        weight: float = 0.9,
        ttl_s: float = 15.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.weight = weight
        self.ttl_s = max(1e-3, ttl_s)
        self.clock = clock
        # lock-plane adoption: gossip observes from the cluster's read
        # loops while the governor samples value() per evaluation
        from .utils.locked import InstrumentedLock

        self._lock = InstrumentedLock("overload_peer_pressure")
        # peer -> (contribution, observed-at monotonic)
        self._peers: dict[int, tuple[float, float]] = {}
        # peer -> advertised per-signal breakdown
        self._peer_signals: dict[int, dict[str, float]] = {}
        self.observations = 0

    def observe(
        self,
        peer: int,
        state_code: int,
        pressure: float,
        signals: "Optional[dict[str, float]]" = None,
    ) -> None:
        """Fold one gossip advert from ``peer`` into the signal; the
        optional per-signal breakdown feeds the diagnostic gauges only —
        the folded contribution stays the scalar max, unchanged."""
        contribution = max(
            max(0.0, float(pressure)), self.STATE_FLOORS.get(int(state_code), 0.0)
        )
        with self._lock:
            self._peers[peer] = (contribution, self.clock())
            if signals:
                self._peer_signals[peer] = dict(signals)
            else:
                # an advert WITHOUT a breakdown refreshes the decay clock
                # (keyed on the scalar advert's stamp), so a stale stored
                # breakdown would otherwise read at full strength forever
                self._peer_signals.pop(peer, None)
            self.observations += 1

    def forget(self, peer: int) -> None:
        """Drop a peer's advert immediately (link torn down)."""
        with self._lock:
            self._peers.pop(peer, None)
            self._peer_signals.pop(peer, None)

    def _decay(self, peer: int, now: float) -> float:
        """The linear TTL decay factor for one peer's advert (0 when
        stale); call under the lock."""
        rec = self._peers.get(peer)
        if rec is None:
            return 0.0
        age = now - rec[1]
        if age >= self.ttl_s:
            return 0.0
        return 1.0 - age / self.ttl_s

    def signal_names(self) -> "set[str]":
        """Every per-signal breakdown name seen so far (gauge
        registration keys off it)."""
        with self._lock:
            out: set = set()
            for sigs in self._peer_signals.values():
                out.update(sigs)
            return out

    def signal_value(self, name: str) -> float:
        """Decayed max of ONE advertised signal across peers — the
        per-signal analog of :meth:`value` (unweighted: these gauges
        answer 'why', the weighted fold answers 'how much')."""
        now = self.clock()
        worst = 0.0
        with self._lock:
            for peer, sigs in self._peer_signals.items():
                v = sigs.get(name)
                if v is not None:
                    worst = max(worst, max(0.0, float(v)) * self._decay(peer, now))
        return worst

    def signal_values(self) -> "dict[str, float]":
        """Every per-signal decayed max (the $SYS breakdown map)."""
        now = self.clock()
        out: dict[str, float] = {}
        with self._lock:
            for peer, sigs in self._peer_signals.items():
                d = self._decay(peer, now)
                for name, v in sigs.items():
                    contrib = max(0.0, float(v)) * d
                    if contrib > out.get(name, 0.0):
                        out[name] = contrib
        return out

    def value(self) -> float:
        """The decayed max over live adverts, scaled by ``weight`` —
        the governor's ``peers`` pressure source."""
        now = self.clock()
        worst = 0.0
        with self._lock:
            stale = []
            for peer, (c, t) in self._peers.items():
                age = now - t
                if age >= self.ttl_s:
                    stale.append(peer)
                    continue
                worst = max(worst, c * (1.0 - age / self.ttl_s))
            for peer in stale:
                del self._peers[peer]
        return worst * self.weight


@dataclass
class OverloadConfig:
    """Knobs for the overload governor (Options / config file map the
    ``overload_*`` keys here; see README.md)."""

    # hysteresis bands over the max normalized pressure in [0, 1+):
    # escalate at *_enter, de-escalate below *_exit (enter > exit)
    throttle_enter: float = 0.70
    throttle_exit: float = 0.50
    shed_enter: float = 0.90
    shed_exit: float = 0.65
    # minimum seconds in a state before DE-escalating (escalation is
    # always immediate); bounds posture flapping around a threshold
    min_dwell_s: float = 0.5
    # evaluation cadence: admit()/read_delay() lazily re-evaluate when
    # the last sample is older than this (the server event loop also
    # forces one evaluation per housekeeping tick)
    eval_interval_s: float = 0.25
    # per-client quota window: the wall-clock period the publish_quota /
    # shed_quota budgets cover. 0 = same as eval_interval_s. Decoupled
    # from evaluation frequency so sampling faster never refills budgets
    # faster
    quota_window_s: float = 0.0
    # THROTTLE: publishes per client per evaluation window before the
    # read loop starts pausing that client's socket reads
    publish_quota: int = 2048
    throttle_delay_s: float = 0.05
    # SHED: publishes admitted per client per evaluation window; the
    # excess is shed (QoS0 dropped, QoS1/2 acked 0x97)
    shed_quota: int = 256
    # SHED: a client whose outbound queue has been full this long is
    # evicted with DISCONNECT 0x97 (slow-consumer eviction)
    eviction_grace_s: float = 2.0
    # cluster QoS0 forward tier: fraction of MAX_PEER_BUFFER at which
    # QoS0 forwards shed while throttling/shedding (QoS>0 keeps the
    # full cap; control traffic never sheds)
    qos0_forward_throttle_fraction: float = 0.5
    qos0_forward_shed_fraction: float = 0.25
    # per-listener CONNECT admission: while THROTTLE/SHED new CONNECTs
    # refuse with CONNACK 0x97 (0x89 while the server drains), except a
    # small always-admit reserve per quota window for $SYS/admin-ACL
    # clients (the operator's monitoring session must get in)
    admission_reserve: int = 2
    # priority-weighted shedding: priority class -> quota multiplier
    # applied to BOTH shed_quota and publish_quota (a class at 0 sheds
    # everything past zero budget; unknown classes weigh 1.0)
    priority_weights: dict = field(default_factory=dict)


class OverloadGovernor:
    """The broker-wide admission/backpressure/shedding state machine.

    Pressure sources are registered by the layers that own the signals
    (staging, server outbound sweep, cluster, memory watermark); each is
    a zero-arg callable returning a normalized pressure (1.0 = at its
    configured cap). ``evaluate`` samples them all and moves the state
    machine; the data-plane verdict methods (``read_delay``, ``admit``,
    ``evict_due``, ``qos0_forward_fraction``) are cheap and re-evaluate
    lazily so a storm is noticed between housekeeping ticks.

    Thread-safe (resilience.py gauge idiom): verdicts run on the event
    loop, but embedders and the cluster may read gauges from other
    threads.
    """

    def __init__(
        self,
        config: Optional[OverloadConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or OverloadConfig()
        self.clock = clock
        # lock-plane adoption (utils.locked): admit()/
        # read_delay() verdicts from every client read loop serialize
        # here, so governor-lock contention is measured, not guessed
        from .utils.locked import InstrumentedLock

        self._lock = InstrumentedLock("overload_governor")
        self._sources: dict[str, Callable[[], float]] = {}
        self._state = NORMAL
        self._entered_at = clock()
        self._last_eval = float("-inf")
        self._last_shed_at = float("-inf")  # last evaluation spent in SHED
        self.epoch = 0  # evaluation-window counter (per-client quotas key on it)
        self._admitted_in_epoch: dict[str, int] = {}
        self._reserve_in_epoch = 0  # admin-reserve CONNECTs this window
        # mesh-wide admission reserve: peer
        # workers gossip their own per-window reserve spend, and
        # admit_connect budgets LOCAL + peer spend against ONE
        # admission_reserve — the reserve is a mesh budget, not
        # per-worker x N. Entries age out after a quota window (the
        # clocks are per-process monotonic, so freshness — not epoch
        # numbers — is the cross-worker alignment; a spend may be
        # counted slightly past its window, which only errs on the
        # refusing side).
        self._peer_reserve: dict[int, tuple[int, float]] = {}
        # fired (off-lock) after each reserve admission so the cluster
        # can gossip the new spend immediately instead of at the next
        # ping tick (cluster wires it to _gossip_soon)
        self.on_reserve_admit: Optional[Callable[[], None]] = None
        # mesh-federation peer-pressure signal (None until a Cluster
        # enables federation via enable_federation)
        self.peer_signal: Optional[PeerPressureSignal] = None
        # counters (exported via gauges)
        self.transitions = 0
        self.sheds = 0
        self.evictions = 0
        self.throttled = 0
        self.admitted = 0
        self.connects_refused = 0
        self.reserve_admits = 0
        self.pressure = 0.0
        self.signal_pressures: dict[str, float] = {}
        self.peak_pressures: dict[str, float] = {}
        # optional transition observer: called as fn(old_state, new_state)
        # AFTER the lock is released (the telemetry plane's flight
        # recorder dumps on NORMAL/THROTTLE -> SHED; telemetry)
        self.on_transition: Optional[Callable[[str, str], None]] = None

    # -- wiring ------------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], float]) -> None:
        """Register (or replace) one named pressure signal."""
        with self._lock:
            self._sources[name] = fn

    def enable_federation(
        self, weight: float = 0.9, ttl_s: float = 15.0
    ) -> PeerPressureSignal:
        """Create (or return) the mesh peer-pressure signal and register
        it as the ``peers`` source: evaluate() then folds the decayed max
        over recent gossip into the posture, so a shedding peer raises
        this worker too (cluster feeds the observations)."""
        sig = self.peer_signal
        if sig is None:
            sig = PeerPressureSignal(weight=weight, ttl_s=ttl_s, clock=self.clock)
            self.peer_signal = sig
            self.add_source("peers", sig.value)
        return sig

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    # -- state machine -----------------------------------------------------

    def evaluate(self, force: bool = False) -> str:
        """Sample every pressure source and apply the hysteresis-banded
        transitions; returns the (possibly new) state. Rate-limited to
        ``eval_interval_s`` unless forced, so the data-plane verdict
        methods can call it on every packet for free."""
        now = self.clock()
        with self._lock:
            if not force and now - self._last_eval < self.config.eval_interval_s:
                return self._state
            self._last_eval = now
            # the quota window rolls on WALL CLOCK, not per evaluation:
            # sampling pressure more often must not refill budgets faster
            win = self.config.quota_window_s or self.config.eval_interval_s
            epoch = int(now / win) if win > 0 else self.epoch + 1
            if epoch != self.epoch:
                self.epoch = epoch
                self._admitted_in_epoch.clear()
                self._reserve_in_epoch = 0
            sources = list(self._sources.items())
        pressures: dict[str, float] = {}
        for name, fn in sources:
            try:
                pressures[name] = max(0.0, float(fn()))
            except Exception:  # pragma: no cover - a signal must not wedge us
                _log.exception("overload signal %r failed; treated as 0", name)
                pressures[name] = 0.0
        p = max(pressures.values(), default=0.0)
        cfg = self.config
        with self._lock:
            self.pressure = p
            self.signal_pressures = pressures
            for name, v in pressures.items():
                if v > self.peak_pressures.get(name, 0.0):
                    self.peak_pressures[name] = v
            state = self._state
            dwell_ok = now - self._entered_at >= cfg.min_dwell_s
            new = state
            if p >= cfg.shed_enter:
                new = SHED
            elif state == SHED:
                if p < cfg.shed_exit and dwell_ok:
                    new = THROTTLE if p >= cfg.throttle_exit else NORMAL
            elif p >= cfg.throttle_enter:
                new = THROTTLE
            elif state == THROTTLE:
                if p < cfg.throttle_exit and dwell_ok:
                    new = NORMAL
            if new != state:
                self._transition_locked(new, p)
            if self._state == SHED:
                self._last_shed_at = now
            result = self._state
        if new != state:
            cb = self.on_transition
            if cb is not None:
                try:
                    cb(state, new)
                except Exception:  # an observer must not wedge the governor
                    _log.exception("overload transition observer failed")
        return result

    def _transition_locked(self, new: str, pressure: float) -> None:
        old = self._state
        self._state = new
        self._entered_at = self.clock()
        self.transitions += 1
        level = (
            logging.WARNING
            if _STATE_CODES[new] > _STATE_CODES[old]
            else logging.INFO
        )
        _log.log(
            level,
            "overload governor %s -> %s (pressure=%.2f, signals=%s)",
            old,
            new,
            pressure,
            {k: round(v, 2) for k, v in self.signal_pressures.items()},
        )

    # -- data-plane verdicts -----------------------------------------------

    @staticmethod
    def _priority_weight(cl) -> float:
        """The client's shed-quota multiplier, cached on the client at
        CONNECT (server.attach_client maps username/client id -> class ->
        weight via ``priority_weights``). Unweighted clients read 1.0."""
        return getattr(cl, "priority_weight", 1.0)

    def read_delay(self, cl) -> float:
        """THROTTLE lever, consulted by the client read loop before each
        socket read: a client that published more than ``publish_quota``
        in the current window gets its next read delayed, so the kernel's
        TCP window backpressures the socket. 0.0 everywhere else.

        Same unlocked NORMAL fast-out as :meth:`admit` — this runs on
        every pass of every client's read loop."""
        if (
            self._state == NORMAL
            and self.clock() - self._last_eval < self.config.eval_interval_s
        ):
            return 0.0
        self.evaluate()
        with self._lock:
            if self._state == NORMAL:
                return 0.0
            if cl._pub_epoch != self.epoch:
                cl._pub_epoch = self.epoch
                cl._pub_count = 0
                return 0.0
            if cl._pub_count <= self.config.publish_quota * self._priority_weight(cl):
                return 0.0
            self.throttled += 1
            return self.config.throttle_delay_s

    def admit(self, cl) -> bool:
        """SHED lever, consulted once per inbound PUBLISH: each client
        gets ``shed_quota`` admissions per quota window while shedding;
        the excess returns False and the caller sheds it gracefully
        (QoS0 drop / QoS1-2 ack 0x97). Always True outside SHED.

        Hot-path note: in NORMAL between evaluations the verdict is
        constant, so the unlocked fast-out below keeps the QoS0
        passthrough free of lock round-trips (the racy attribute reads
        are benign — at worst one packet is judged by the previous
        evaluation, the same window any lazy sampling has). The
        ``admitted`` counter therefore counts admissions decided while
        the governor was actively throttling/shedding."""
        if (
            self._state == NORMAL
            and self.clock() - self._last_eval < self.config.eval_interval_s
        ):
            return True
        self.evaluate()
        with self._lock:
            if self._state != SHED:
                self.admitted += 1
                return True
            n = self._admitted_in_epoch.get(cl.id, 0)
            # priority-weighted budget: a high-priority class multiplies
            # its per-window quota, a zero-weight class sheds everything
            # — storming low-priority publishers shed first
            if n < int(self.config.shed_quota * self._priority_weight(cl)):
                self._admitted_in_epoch[cl.id] = n + 1
                self.admitted += 1
                return True
            self.sheds += 1
            return False

    def _reserve_window_s(self) -> float:
        return self.config.quota_window_s or self.config.eval_interval_s

    def note_peer_reserve(self, peer: int, spent: int) -> None:
        """Fold one peer's gossiped per-window reserve spend into the
        mesh budget (cluster feeds this from _T_GOSSIP)."""
        with self._lock:
            self._peer_reserve[peer] = (max(0, int(spent)), self.clock())

    def _peer_reserve_spent_locked(self) -> int:
        """Sum of fresh peer reserve spends (call under the lock);
        stale entries age out at one quota window."""
        now = self.clock()
        win = self._reserve_window_s()
        total = 0
        stale = []
        for peer, (spent, t) in self._peer_reserve.items():
            if now - t >= max(win, 1e-3):
                stale.append(peer)
                continue
            total += spent
        for peer in stale:
            del self._peer_reserve[peer]
        return total

    def reserve_advert(self) -> int:
        """This worker's reserve spend in the current window — the
        value its gossip advert carries."""
        with self._lock:
            return self._reserve_in_epoch

    def admit_connect(self, admin: "bool | Callable[[], bool]" = False) -> bool:
        """Per-listener CONNECT admission (mesh-federation tentpole):
        while THROTTLE/SHED a new CONNECT is refused — the caller sends
        CONNACK 0x97 Quota Exceeded — except a small always-admit
        reserve per quota window for ``admin`` callers ($SYS/admin-ACL
        clients: the operator must be able to connect and watch the
        storm). Always True in NORMAL.

        ``admin`` may be a zero-arg callable: it is consulted LAZILY,
        only when a refusal is actually on the table and reserve budget
        remains — the common NORMAL-state CONNECT never pays the ACL
        walk — and it runs outside the governor lock (it may be a hook
        chain)."""
        if (
            self._state == NORMAL
            and self.clock() - self._last_eval < self.config.eval_interval_s
        ):
            return True
        self.evaluate()
        with self._lock:
            if self._state == NORMAL:
                return True
            # the reserve is a MESH budget: local spend plus every
            # peer's freshly gossiped spend draw from one pool
            spent = self._reserve_in_epoch + self._peer_reserve_spent_locked()
            reserve_open = spent < self.config.admission_reserve
        if reserve_open and (admin() if callable(admin) else admin):
            granted = False
            with self._lock:
                spent = (
                    self._reserve_in_epoch + self._peer_reserve_spent_locked()
                )
                if spent < self.config.admission_reserve:
                    self._reserve_in_epoch += 1
                    self.reserve_admits += 1
                    granted = True
            if granted:
                cb = self.on_reserve_admit
                if cb is not None:
                    try:
                        # off-lock: the cluster gossips the new spend now
                        cb()
                    except Exception:
                        _log.exception("reserve-admit observer failed")
                return True
        with self._lock:
            self.connects_refused += 1
            return False

    def evict_due(self, full_since: Optional[float]) -> bool:
        """True when a slow consumer backlogged since ``full_since``
        should be evicted: past the grace window, while SHEDDING — or
        within one grace window of the last shed episode, so a posture
        that flaps around the exit band between sweeps still sheds the
        backlog it accumulated."""
        if full_since is None:
            return False
        with self._lock:
            now = self.clock()
            shedding = (
                self._state == SHED
                or now - self._last_shed_at < self.config.eviction_grace_s
            )
            if not shedding:
                return False
            return now - full_since >= self.config.eviction_grace_s

    def qos0_forward_fraction(self) -> float:
        """The cluster's QoS0 forward-shedding tier: the fraction of
        MAX_PEER_BUFFER at which QoS0 forwards drop. 1.0 in NORMAL (the
        plain cap); reduced while throttling/shedding so the expendable
        tier sheds first and QoS>0 forwards keep the full cap."""
        with self._lock:
            if self._state == SHED:
                return self.config.qos0_forward_shed_fraction
            if self._state == THROTTLE:
                return self.config.qos0_forward_throttle_fraction
            return 1.0

    def note_shed(self, n: int = 1) -> None:
        """Account sheds decided outside admit() (cluster QoS0 tier)."""
        with self._lock:
            self.sheds += n

    def note_connect_refused(self) -> None:
        """Account CONNECT refusals decided outside admit_connect()
        (the server's drain-time 0x89 path) — the connects_refused
        gauge must count every turned-away client, whatever the
        reason code."""
        with self._lock:
            self.connects_refused += 1

    def note_eviction(self) -> None:
        with self._lock:
            self.evictions += 1

    # -- observability -----------------------------------------------------

    def gauges(self) -> dict:
        """The $SYS gauge map (server.publish_sys_topics exports it under
        ``$SYS/broker/overload/``)."""
        with self._lock:
            d = {
                "state": self._state,
                "state_code": _STATE_CODES[self._state],
                "pressure": round(self.pressure, 4),
                "transitions": self.transitions,
                "sheds": self.sheds,
                "evictions": self.evictions,
                "throttled": self.throttled,
                "admitted": self.admitted,
                "connects_refused": self.connects_refused,
                "reserve_admits": self.reserve_admits,
                # mesh-wide reserve budget: local + fresh peer spend
                "reserve_spent_local": self._reserve_in_epoch,
                "reserve_spent_mesh": (
                    self._reserve_in_epoch
                    + self._peer_reserve_spent_locked()
                ),
            }
            for name, v in self.signal_pressures.items():
                d[f"signal/{name}"] = round(v, 4)
            for name, v in self.peak_pressures.items():
                d[f"peak/{name}"] = round(v, 4)
            sig = self.peer_signal
        if sig is not None:
            # the per-signal WHY behind the folded peers pressure
            # (computed off the governor lock: it takes the signal's own)
            for name, v in sig.signal_values().items():
                d[f"peers_signal/{name}"] = round(v, 4)
        return d
