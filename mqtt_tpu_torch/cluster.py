"""Multi-core broker data plane: SO_REUSEPORT worker processes with a
full-mesh forwarding fabric.

A copy of the JAX package's ``mqtt_tpu/cluster.py``. One departure: a
presence flush goes to each peer in one write (``_send_control_batch``;
the same frames, the control cap held before each), where the JAX cluster
writes each frame alone.

The reference gets every core for free — goroutine-per-connection over one
shared listener (listeners/tcp.go:84, clients.go:363) — while a CPython
worker owns exactly one core. Clustering proper is out of scope on both
sides (the reference lists it as roadmap, README.md:59-62); this module is
the listener-compatible scale-OUT of one broker onto N processes on ONE
machine:

- N worker processes bind the SAME TCP address with ``SO_REUSEPORT``; the
  kernel load-balances accepted connections across them. Each worker is a
  full ``Server`` (sessions, trie, QoS, hooks) for its own clients.
- Workers connect a full mesh of unix-domain sockets. Each worker
  broadcasts subscription PRESENCE — "I have at least one subscriber on
  filter F" — computed from its live trie (idempotent set/clear, so no
  refcount drift), and keeps a ``remote`` TopicsIndex of pseudo-subscribers
  per peer. A local publish therefore matches remote interest with the
  same trie walk used for local fan-out, and the frame is forwarded ONCE
  per interested peer, which re-matches and delivers to its own clients.
- The QoS0 v4 passthrough stays intact end to end: eligible frames are
  forwarded verbatim (type ``F``) and delivered at the peer through the
  same cached fan-out plans ``try_fast_publish`` uses; everything else
  (QoS>0, v5 properties, retain) forwards as a decoded packet re-encoded
  by the wire codec (type ``P``).
- Retained messages replicate to ALL workers (a future subscriber may land
  anywhere); $SYS topics never forward (every worker maintains its own).

Known limits (documented, not hidden): shared-subscription (``$SHARE``)
groups select one member PER WORKER holding members (the reference's
single process selects one total); session takeover only sees clients on
the same worker; storage hooks should be per-worker stores; and under
peer-link backpressure, forwards to a stalled peer DROP once its write
buffer exceeds ``MAX_PEER_BUFFER`` — **including QoS>0 packet forwards**,
so cross-worker QoS1/2 delivery is best-effort while a peer is wedged
(the peer's own clients still get full QoS semantics from their worker).
Each drop is counted (``dropped_forwards`` total, ``dropped_by_peer`` per
peer, ``dropped_qos_forwards`` for the QoS>0 subset) and surfaced as
``$SYS/broker/cluster/...`` gauges — never silent. These are the standard
SO_REUSEPORT-broker trade-offs — a deployment that needs exact
single-process semantics runs one worker.

Link-failure posture (mqtt_tpu_torch.resilience machinery): dropped peer links
re-dial with exponential backoff + jitter (a restarting peer is not
hammered in lockstep by every worker), and every reattach replays FULL
presence state (``_register``), so the peer's interest map converges even
though withdrawals generated during the outage were lost.

Mesh federation: the ping loop doubles as the PRESSURE GOSSIP
cadence (``_T_GOSSIP`` carries each worker's overload posture; received
adverts feed the governor's decayed ``peers`` signal AND tier forwards
per destination) and the PEER HEALTH clock — a peer missing pongs walks
UP -> SUSPECT (QoS>0 forwards held in a bounded park buffer, replayed
exactly once on heal) -> PARTITIONED (park flushed into the partition
drop counters, stale interest withdrawn, link aborted for a clean
re-dial). Every (re)connect opens a fresh presence GENERATION
(``_T_SYNC``), so presence frames from a raced stale link can never
resurrect withdrawn filters.

Spanning-tree mode (``cluster_topology: tree``): the all-pairs
fabric above grows O(N²) links and gossip, so tree mode routes over the
epoch-stamped loop-free tree mqtt_tpu_torch.mesh_topology elects instead —
per-worker links stay O(degree) at 32+ workers (MQTT-ST, arxiv
1911.07622). Publishes travel tree edges only, gated by per-edge
counted-bloom INTEREST SUMMARIES (``_T_SUMMARY``, TD-MQTT-style
transparent aggregation: the summary sent on edge E is local interest ∪
every OTHER edge's received summary) with conservative pass-through
while a summary is stale; receiving workers RE-FORWARD along their other
matching edges, but only under the frame's own epoch — an epoch mismatch
delivers locally and stops, so a mid-election frame can never loop.
Every routed frame carries (epoch, origin, boot, seq) and receivers keep
per-(origin, boot) windows: re-parenting replays are suppressed as
duplicates, never double-delivered. The per-peer health machine becomes
per-tree-EDGE: a severed edge parks QoS>0 exactly as before, and the
PARTITIONED verdict triggers a SCOPED RE-ELECTION (``_T_EPOCH`` floods
the strictly-greater epoch; mesh_topology's total order makes
concurrent proposals converge) after which the park re-routes through
the new tree under the new epoch — exactly once, by the suppression
window. Pressure gossip rides tree edges folded PER SUBTREE: the advert
sent on edge E is the elementwise max of this worker's signals and the
adverts from every other edge, so the ``peers`` signal reads "how hot is
everything behind that edge" in O(degree) gossip volume.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import logging
import math
import os
import random
import socket
import ssl
import struct
import time
from typing import Any, Callable, Iterable, Optional

from .mesh_topology import (
    ROUTE_DUP,
    ROUTE_NEW,
    ROUTE_REFORWARD,
    BloomBits,
    CountedBloom,
    DuplicateSuppressor,
    Topology,
    TreeEpoch,
    decode_members,
    encode_members,
)
from .packets import PUBLISH, FixedHeader, Packet
from .packets import Subscription
from .predicates import compile_suffix, eval_rule_host, predicate_digest
from .topics import (
    NS_CHAR,
    SHARE_PREFIX,
    InlineSubscription,
    TopicsIndex,
    ns_local,
    ns_scope_topic,
    ns_tenant,
    summary_base,
)
from .utils.loopwitness import DEFAULT_LOOP_PLANE as _LOOP_PLANE

_log = logging.getLogger("mqtt_tpu_torch.cluster")

# wire: 4-byte big-endian length | 1-byte type | payload
_T_HELLO = 0x48  # 'H' json {worker}
_T_PRESENCE = 0x53  # 'S' json {filter, populated, inline, gen}
_T_FRAME = 0x46  # 'F' u16 origin_len | origin | raw v4 qos0 PUBLISH frame
_T_PACKET = 0x50  # 'P' json header | 0x00 | encoded publish body
# link telemetry (mqtt_tpu_torch.telemetry): Q carries a sender timestamp, the
# peer echoes it back as R and the sender observes the round trip — the
# forward-latency proxy for every peer link. Unknown types are ignored
# by the read loop, so a mixed-version mesh keeps working.
_T_PING = 0x51  # 'Q' f64 sender perf_counter
_T_PONG = 0x52  # 'R' echoed ping payload
# mesh federation: G rides the ping loop and carries the
# sender's overload-governor posture + scalar pressure; Y opens a fresh
# presence generation on (re)connect so stale pre-heal presence frames
# from a raced old link can never re-apply (split-brain guard)
_T_GOSSIP = 0x47  # 'G' json {s: state_code, p: pressure}
_T_SYNC = 0x59  # 'Y' json {gen}
# trace plane (mqtt_tpu_torch.tracing): a TRACED v4 qos0 passthrough frame —
# _T_FRAME plus an embedded trace context so the peer's remote-fanout
# span joins the origin's trace. A NEW type rather than a _T_FRAME
# layout change: an older peer ignores it (losing only the 1-in-N
# sampled forwards in a mixed-version mesh) instead of misparsing
# every frame. Traced _T_PACKET forwards need no new type — the json
# head just grows a "trace" key older peers ignore.
_T_TFRAME = 0x54  # 'T' u16 origin_len | origin | u16 tlen | trace json | frame
# spanning-tree mode: E floods an epoch announcement (the
# member view; edges are NOT carried — every worker recomputes the same
# deterministic tree from the view), U carries one edge's aggregated
# interest summary, and X is the tree-routed QoS0 passthrough frame —
# _T_FRAME plus the (epoch, origin, boot, seq) route header receivers
# need for duplicate suppression and re-forwarding (trace context rides
# the same header). Tree-routed packet forwards stay _T_PACKET: their
# json head just grows an "rt" key.
_T_EPOCH = 0x45  # 'E' json {e: [num, boot, proposer], m: {worker: boot}}
_T_SUMMARY = 0x55  # 'U' json {e, g, all} | 0x00 | bloom bitset
_T_RFRAME = 0x58  # 'X' u16 origin_len | origin | u16 rlen | route json | frame
# metric federation: per-worker registry summaries ride the
# mesh at gossip cadence — {"w": {worker: {b: boot, q: seq, f: fams}}}.
# Tree mode folds per SUBTREE at each hop (a worker forwards its own
# summary plus everything learned on child edges up to its parent, so
# the root aggregates the whole mesh over O(depth) hops); all-pairs
# mode broadcasts each worker's own summary. Old peers ignore the type.
# Deliberately NOT a control type: summaries are orders of magnitude
# bigger than pings/gossip, and counting them into control_bytes would
# invalidate the drill's O(degree) control-plane-rate assertion.
_T_METRICS = 0x4D  # 'M' json {w: {worker: {b, q, f}}}

# control-plane frame types: byte volume is accounted (``control_bytes``,
# the drill's O(degree) gossip-volume assertion) and presence/sync keep
# their 8x never-shed headroom in _send_nowait
_CONTROL_TYPES = frozenset(
    {_T_HELLO, _T_PRESENCE, _T_PING, _T_PONG, _T_GOSSIP, _T_SYNC, _T_EPOCH, _T_SUMMARY}
)

# per-peer health states (the link-failure posture between "up" and the
# old binary link_down): SUSPECT holds QoS>0 forwards in a bounded park
# buffer awaiting a quick heal; PARTITIONED gives up (park flushed into
# the partition drop counters, link aborted so the dialer re-runs)
PEER_UP = "up"
PEER_SUSPECT = "suspect"
PEER_PARTITIONED = "partitioned"
_HEALTH_CODES = {PEER_UP: 0, PEER_SUSPECT: 1, PEER_PARTITIONED: 2}


class _EdgeSummary:
    """One tree edge's received interest summary: the all-interest bloom
    the topic gate probes, plus the predicate push-down planes
    — the PLAIN (un-predicated) interest bloom and the interned
    predicate digest list. ``plain``/``digests`` are None when the
    sender predates push-down (or overflowed its digest cap): the gate
    degrades to the topic-only behavior, conservative as ever."""

    __slots__ = ("bits", "gen", "ep_key", "plain", "digests")

    def __init__(
        self,
        bits: "BloomBits",
        gen: int,
        ep_key: tuple,
        plain: Optional["BloomBits"] = None,
        digests: Optional[tuple] = None,
    ) -> None:
        self.bits = bits
        self.gen = gen
        self.ep_key = ep_key
        self.plain = plain
        self.digests = digests  # ((digest, suffix), ...) or None


class _PeerHealth:
    """One peer's health record: the UP -> SUSPECT -> PARTITIONED state
    machine plus the bounded QoS>0 park buffer SUSPECT accumulates."""

    __slots__ = ("state", "outstanding", "park", "park_bytes")

    def __init__(self) -> None:
        self.state = PEER_UP
        self.outstanding = 0  # pings sent (or aged) without a pong
        self.park: collections.deque = collections.deque()
        self.park_bytes = 0


def _noop_inline(*_a) -> None:  # pragma: no cover - marker, never invoked
    pass


class Cluster:
    """The per-worker forwarding fabric. Attach to a built ``Server``
    before ``serve()``; peers are the other workers' unix socket paths."""

    def __init__(self, server, worker_id: int, n_workers: int, sock_dir: str) -> None:
        self.server = server
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.sock_dir = sock_dir
        # pseudo-subscribers: client f"\x00w{peer}" per (peer, filter) —
        # matching remote interest IS a trie walk on this index. Its
        # trie lock carries its own lock-plane name (mqtt_tpu_torch.utils.
        # locked) so forward-path contention never hides inside the
        # local trie's numbers.
        self.remote = TopicsIndex(lock_name="cluster_remote_trie")
        self._writers: dict[int, asyncio.StreamWriter] = {}
        self._unix_server: Optional[asyncio.base_events.Server] = None
        self._pending_presence: set[str] = set()
        self._presence_wake: Optional[asyncio.Event] = None
        self._tasks: list[asyncio.Task] = []
        self._plan_cache: dict[str, tuple[int, tuple[int, ...]]] = {}
        self._stopping = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.dropped_forwards = 0  # forwards dropped at the peer-buffer cap
        # backpressure accounting (module known-limits list): per-peer
        # drop counts plus the QoS>0 subset — a wedged peer weakens
        # cross-worker QoS1/2 to best-effort, and that MUST be visible
        self.dropped_by_peer: dict[int, int] = {}
        self.dropped_qos_forwards = 0
        # per-peer re-dial counts (the $SYS reconnects gauge)
        self.reconnects: dict[int, int] = {}
        # QoS0 forwards shed at the overload governor's REDUCED tier cap
        # (a strict subset of dropped_forwards): the expendable tier
        # sheds first, QoS>0 keeps the full buffer, control never sheds
        self.shed_qos0_forwards = 0
        # filters each peer has announced as populated: the link-drop
        # cleanup needs them to withdraw the peer's interest (withdrawals
        # generated during an outage are lost, so stale entries would
        # otherwise forward forever)
        self._peer_filters: dict[int, set[str]] = {}
        # drop-class split: partition-time drops
        # (link down / peer partitioned / park overflow) vs backlog
        # drops (peer-buffer cap, write faults on a live link).
        # dropped_forwards stays the total of both classes.
        self.dropped_partition = 0
        self.dropped_backlog = 0
        # partition-tolerance state: per-peer health records, the
        # presence generation counter, and the last (boot, generation)
        # each peer's sync opened (stale presence below it is
        # discarded). The boot id is a per-INCARNATION nonce: a
        # restarted peer's generation counter begins again at 1, and
        # without the nonce its fresh sync would compare below the old
        # incarnation's stored generation and be rejected forever.
        self._health: dict[int, _PeerHealth] = {}
        self.presence_generation = 0
        self.boot_id = random.getrandbits(48)
        self._peer_gen: dict[int, tuple[Optional[int], int]] = {}
        self.parked_forwards = 0  # currently parked QoS>0 frames
        self.replayed_forwards = 0  # parked frames replayed on heal
        # pressure gossip: each peer's last advertised (state_code,
        # pressure, monotonic) — forward tiering consults the
        # DESTINATION's posture, the governor's peers signal the max
        self._peer_adverts: dict[int, tuple[int, float, float]] = {}
        # live read loops per peer (reconnect-discipline observability:
        # a flapping link must never leave two loops draining one peer)
        self._live_read_loops: dict[int, int] = {}
        # fault-injection seam (the faults plane): when set, inbound
        # frames it returns False for are dropped before dispatch
        self._rx_filter: Optional[Callable[[int, int, bytes], bool]] = None
        # link-shaping seam (the faults plane's link shaper): an
        # ASYNC hook awaited on every inbound frame BEFORE the rx filter
        # — it models the wire itself (latency/jitter/loss/bandwidth),
        # so it runs where the bytes arrive; returning False drops the
        # frame (control loss — the protocol re-sends those anyway)
        self._rx_shaper: Optional[Any] = None
        opts = getattr(server, "options", None)
        # real transport: peers ride unix sockets on one box
        # (the default) or TCP across machines —
        # optionally TLS with CA-verified peer certs BOTH directions
        # (a worker cert is an authorization to join the mesh, so the
        # server side requires one too). Worker ``i`` listens on
        # ``cluster_base_port + i`` unless cluster_peer_addrs pins an
        # explicit host:port per worker (multi-machine deployments).
        self.transport = str(
            getattr(opts, "cluster_transport", "unix") or "unix"
        ).lower()
        self.host = str(getattr(opts, "cluster_host", "127.0.0.1") or "127.0.0.1")
        self.base_port = int(getattr(opts, "cluster_base_port", 0) or 0)
        self.peer_addrs: dict[int, tuple[str, int]] = {}
        for w, addr in dict(
            getattr(opts, "cluster_peer_addrs", None) or {}
        ).items():
            try:
                host, _, port = str(addr).rpartition(":")
                self.peer_addrs[int(w)] = (host or "127.0.0.1", int(port))
            except (ValueError, TypeError):
                pass  # a malformed entry falls back to base_port + worker
        self.tls_cert = str(getattr(opts, "cluster_tls_cert", "") or "")
        self.tls_key = str(getattr(opts, "cluster_tls_key", "") or "")
        self.tls_ca = str(getattr(opts, "cluster_tls_ca", "") or "")
        # WAN-tuned link timers: the connect timeout bounds a dial stuck
        # in a blackholed SYN (WAN RTTs make the OS default minutes);
        # keepalive_s > 0 arms SO_KEEPALIVE with that idle/interval so a
        # silently dead path is torn down between ping ticks
        self.connect_timeout_s = float(
            getattr(opts, "cluster_connect_timeout_s", 5.0) or 5.0
        )
        self.keepalive_s = float(getattr(opts, "cluster_keepalive_s", 0.0) or 0.0)
        self.suspect_pings = getattr(opts, "cluster_peer_health_suspect_pings", 2)
        self.partition_pings = getattr(
            opts, "cluster_peer_health_partition_pings", 5
        )
        # seconds-dialable SUSPECT window: when set,
        # the wall-clock grace wins over the missed-pong count — rounded
        # UP to whole ping intervals (the health clock only ticks there),
        # floor one interval. The PARTITIONED threshold keeps its strict
        # ordering so the park buffer always gets a heal window.
        window_s = float(getattr(opts, "cluster_suspect_window_s", 0.0) or 0.0)
        if window_s > 0:
            self.suspect_pings = max(
                1, math.ceil(window_s / self.PING_INTERVAL_S)
            )
            if self.partition_pings <= self.suspect_pings:
                self.partition_pings = self.suspect_pings + 3
        self.park_max_bytes = getattr(
            opts, "cluster_peer_park_max_bytes", 1 << 20
        )
        self.advert_ttl_s = getattr(opts, "overload_federation_ttl_ms", 15000.0) / 1e3
        # spanning-tree mode: the deterministic epoch-stamped
        # tree replaces the all-pairs fabric — O(degree) links, interest-
        # scoped routing, per-edge health. "mesh" keeps the all-pairs
        # behavior bit-for-bit (and stays the default for small meshes).
        self.topology_mode = str(
            getattr(opts, "cluster_topology", "mesh") or "mesh"
        ).lower()
        self.tree_degree = int(getattr(opts, "cluster_tree_degree", 4) or 4)
        summary_bits = int(getattr(opts, "cluster_summary_bits", 4096) or 4096)
        self.topo: Optional[Topology] = None
        self._local_interest = CountedBloom(summary_bits)
        self._summary_filters: set[str] = set()  # summary keys currently counted
        # predicate push-down: the all-interest bloom above
        # answers "could any filter match this topic"; these answer the
        # sharper "could any subscriber actually TAKE it". Plain (un-
        # predicated) interest keeps its own counted bloom, predicated
        # interest rides as interned suffix digests — a forwarder
        # evaluates each digest's compiled rule against the publish
        # payload (the same host interpreter the destination runs, so a
        # local FAIL is a guaranteed destination FAIL: false negatives
        # impossible, exactly the blooms' contract).
        self._local_plain = CountedBloom(summary_bits)
        self._local_digests: dict[str, int] = {}  # suffix -> live-filter refs
        # filter -> (has_plain, suffixes): the last probed push-down
        # split per live filter, so churn diffs instead of re-folding
        self._filter_pred: dict[str, tuple] = {}
        self._digest_gen = 0  # bumped when the digest SET changes
        # suffix -> compiled spec, or None = always-pass (aggregation
        # windows and anything that fails to compile stay conservative)
        self._digest_specs: dict[str, Optional[Any]] = {}
        self.summary_digest_cap = int(
            getattr(opts, "cluster_summary_digests", 64) or 0
        )
        self.summary_predicate_filtered_forwards = 0
        # root-failure fast path: the pre-agreed successor
        # (mesh_topology.compute_successor) promotes the moment the root
        # goes SUSPECT instead of waiting out the PARTITIONED threshold
        # — no full re-election blackout on the happy path
        self.root_failovers = 0
        self.root_failover_last_s = 0.0
        self._root_failover_hist: Optional[Any] = None
        # peer -> _EdgeSummary (received bits + push-down planes)
        self._edge_summaries: dict[int, _EdgeSummary] = {}
        # peer -> (gen, full epoch key) last successfully sent
        self._summary_sent: dict[
            int, tuple[int, tuple[int, int, int]]
        ] = {}
        self._dup = DuplicateSuppressor(
            window=int(getattr(opts, "cluster_dup_window", 8192) or 8192)
        )
        self._seq = itertools.count(1)  # origin seq stamp (GIL-atomic next())
        self._dial_tasks: dict[int, asyncio.Task] = {}
        self._peer_advert_sigs: dict[int, dict[str, float]] = {}
        # per-peer gossiped admission-reserve spend (the admin-ACL CONNECT reserve is a MESH budget — see
        # OverloadGovernor.note_peer_reserve); tree mode folds these by
        # SUM per subtree the way pressures fold by max
        self._peer_advert_reserve: dict[int, int] = {}
        self.duplicates_suppressed = 0  # (origin, boot, seq) window hits
        self.stale_epoch_frames = 0  # re-forwarded under the live tree, counted
        self.summary_filtered_forwards = 0  # edges skipped by a fresh summary
        self.summary_passthrough_forwards = 0  # conservative sends on stale/absent summaries
        self.control_bytes = 0  # wire bytes spent on control-plane frames
        # metric federation: the per-worker summary store fed
        # by _T_METRICS frames (telemetry.ClusterMetrics; attached below
        # when the telemetry plane is on), the outbound sequence stamp,
        # and the frame accounting
        self.metrics_fed: Optional[Any] = None
        self._metrics_seq = 0
        self.metrics_frames_tx = 0
        self.metrics_frames_rx = 0
        if self.topology_mode == "tree":
            self.topo = Topology(
                worker_id, range(n_workers), self.tree_degree, boot_id=self.boot_id
            )
        server._cluster = self
        server.topics.add_observer(self._on_mutation)
        governor = getattr(server, "overload", None)
        if governor is not None:
            # peer-buffer occupancy feeds the broker-wide overload
            # governor: a mesh backing up is the same 'work is not
            # draining' condition as a slow local subscriber
            governor.add_source("cluster", self._buffer_pressure)
            if getattr(opts, "overload_federation", True) and hasattr(
                governor, "enable_federation"
            ):
                # mesh federation: gossip observations feed the decayed
                # peers signal, and a transition gossips immediately so
                # a SHED propagates within one gossip interval
                governor.enable_federation(
                    weight=getattr(opts, "overload_federation_weight", 0.9),
                    ttl_s=self.advert_ttl_s,
                )
                prev_transition = governor.on_transition

                def _gossip_transition(old, new, _prev=prev_transition):
                    if _prev is not None:
                        _prev(old, new)
                    self._gossip_soon()

                governor.on_transition = _gossip_transition
                # a reserve admission gossips IMMEDIATELY so the spend
                # lands mesh-wide before the next ping tick — the
                # admin-ACL budget is shared, not per-worker x N
                governor.on_reserve_admit = self._gossip_soon
        tele = getattr(server, "telemetry", None)
        if tele is not None:
            tracer = getattr(tele, "tracer", None)
            if tracer is not None:
                # merged multi-worker trace exports keep one Chrome-trace
                # process group per worker
                tracer.pid = worker_id
            r = tele.registry
            r.counter(
                "mqtt_tpu_cluster_peer_drops_partition_total",
                "Forwards dropped because the peer link was down/partitioned "
                "(incl. park-buffer overflow)",
                fn=lambda: self.dropped_partition,
            )
            r.counter(
                "mqtt_tpu_cluster_peer_drops_backlog_total",
                "Overload-class drops on a LIVE link: the peer write-buffer "
                "cap, a destination-advertised shed (see "
                "shed_qos0_forwards), or a write fault",
                fn=lambda: self.dropped_backlog,
            )
            r.counter(
                "mqtt_tpu_cluster_peer_replays_total",
                "Parked QoS>0 forwards replayed after a peer-link heal",
                fn=lambda: self.replayed_forwards,
            )
            r.gauge(
                "mqtt_tpu_cluster_parked_bytes",
                "Bytes currently held in SUSPECT peers' park buffers",
                fn=lambda: sum(h.park_bytes for h in self._health.values()),
            )
            r.counter(
                "mqtt_tpu_cluster_control_bytes_total",
                "Wire bytes spent on mesh control traffic (hello/presence/"
                "ping/pong/gossip/sync/epoch/summary) — the drill's "
                "O(degree) gossip-volume number",
                fn=lambda: self.control_bytes,
            )
            if getattr(opts, "cluster_metrics", True):
                # metric federation: per-worker registry
                # summaries ride _T_METRICS at gossip cadence; the store
                # renders GET /metrics/cluster and /cluster/slo at any
                # worker that has aggregated them (the tree root sees
                # the whole mesh)
                from .telemetry import ClusterMetrics

                cm = getattr(tele, "cluster_metrics", None)
                if cm is None:
                    cm = ClusterMetrics(
                        max_age_s=float(
                            getattr(opts, "cluster_metrics_max_age_s", 120.0)
                            or 120.0
                        )
                    )
                    tele.attach_cluster_metrics(cm)
                self.metrics_fed = cm
                # the federation label every local sample renders under
                tele.local_worker = str(worker_id)
                for direction, fn in (
                    ("tx", lambda: self.metrics_frames_tx),
                    ("rx", lambda: self.metrics_frames_rx),
                ):
                    r.counter(
                        "mqtt_tpu_cluster_metrics_frames_total",
                        "Mesh metric-federation frames (_T_METRICS) sent "
                        "and accepted, by direction",
                        fn=fn,
                        direction=direction,
                    )
                r.gauge(
                    "mqtt_tpu_cluster_metrics_workers",
                    "Workers with a fresh federated metric summary in "
                    "this worker's store (the tree root's count covers "
                    "the mesh)",
                    fn=lambda: cm.worker_count,
                )
            if self.topo is not None:
                topo = self.topo
                r.gauge(
                    "mqtt_tpu_cluster_tree_epoch",
                    "Current spanning-tree epoch number (bumps on every "
                    "re-election/adoption)",
                    fn=topo.epoch_num,
                )
                r.gauge(
                    "mqtt_tpu_cluster_tree_links",
                    "Live links to current tree neighbors (the O(degree) "
                    "link-count bound)",
                    fn=lambda: sum(
                        1 for p in topo.neighbors() if p in self._writers
                    ),
                )
                r.counter(
                    "mqtt_tpu_cluster_tree_re_elections_total",
                    "Local re-election proposals (edge death, member "
                    "join/rejoin, self re-join)",
                    fn=lambda: topo.re_elections,
                )
                r.counter(
                    "mqtt_tpu_cluster_duplicates_suppressed_total",
                    "Routed frames dropped by the (origin, boot, seq) "
                    "window — re-parenting replays, never double-delivered",
                    fn=lambda: self.duplicates_suppressed,
                )
                r.counter(
                    "mqtt_tpu_cluster_stale_epoch_frames_total",
                    "Routed frames stamped with a non-current epoch: "
                    "delivered locally, never re-forwarded (loop guard)",
                    fn=lambda: self.stale_epoch_frames,
                )
                r.counter(
                    "mqtt_tpu_cluster_summary_filtered_total",
                    "Tree edges skipped because a FRESH interest summary "
                    "proved no subscriber behind them matches",
                    fn=lambda: self.summary_filtered_forwards,
                )
                r.counter(
                    "mqtt_tpu_cluster_summary_passthrough_total",
                    "Conservative forwards on edges whose summary was "
                    "stale or not yet received",
                    fn=lambda: self.summary_passthrough_forwards,
                )
                r.counter(
                    "mqtt_tpu_cluster_summary_predicate_filtered_total",
                    "Tree edges skipped by predicate push-down: every "
                    "remote subscriber behind them was predicated and "
                    "every digest's rule FAILED on this payload",
                    fn=lambda: self.summary_predicate_filtered_forwards,
                )
                r.counter(
                    "mqtt_tpu_cluster_root_failovers_total",
                    "Root-death fast-path promotions taken by THIS "
                    "worker as the pre-agreed successor",
                    fn=lambda: self.root_failovers,
                )
                self._root_failover_hist = r.histogram(
                    "mqtt_tpu_cluster_root_failover_seconds",
                    "Root-failure promotion window: suspect transition "
                    "on the dead root to the new epoch flooded (the "
                    "no-blackout bound the drill asserts)",
                )

    @property
    def peer_count(self) -> int:
        """Live peer links (the $SYS gauge's public accessor)."""
        return len(self._writers)

    @property
    def reconnects_total(self) -> int:
        """Total peer-link re-dials across all peers ($SYS gauge)."""
        return sum(self.reconnects.values())

    # -- lifecycle ---------------------------------------------------------

    def _sock_path(self, worker: int) -> str:
        return os.path.join(self.sock_dir, f"mqtt-tpu-w{worker}.sock")

    def _peer_addr(self, worker: int) -> tuple[str, int]:
        """TCP transport: where ``worker`` listens. Cross-machine
        deployments pin workers to hosts via ``cluster_peer_addrs``;
        unpinned workers default to ``cluster_host`` and a deterministic
        per-worker port (``cluster_base_port + worker``)."""
        pinned = self.peer_addrs.get(worker)
        if pinned is not None:
            return pinned
        return (self.host, self.base_port + worker)

    def _tls_context(self, server: bool) -> Optional[ssl.SSLContext]:
        """Mutual-TLS context for peer links, or None when TLS is off
        (no cert configured). Both directions verify: the accepting side
        demands a client cert and the dialing side verifies the server
        cert against ``cluster_tls_ca`` — a mesh peer is authenticated
        by its certificate, not its address. Hostname checking is off on
        purpose: peer identity is the CA-signed cert itself, and drill
        harnesses address every "machine" as 127.0.0.1."""
        if not self.tls_cert:
            return None
        ctx = ssl.SSLContext(
            ssl.PROTOCOL_TLS_SERVER if server else ssl.PROTOCOL_TLS_CLIENT
        )
        ctx.load_cert_chain(self.tls_cert, self.tls_key or None)
        if self.tls_ca:
            ctx.load_verify_locations(self.tls_ca)
            ctx.verify_mode = ssl.CERT_REQUIRED
        if not server:
            ctx.check_hostname = False
        return ctx

    def _tune_socket(self, writer: asyncio.StreamWriter) -> None:
        """WAN keepalive tuning on a peer link (both accept and dial
        sides): with ``cluster_keepalive_s`` set, the kernel probes an
        idle link so a silently-dead TCP path (machine vanished, NAT
        state expired) surfaces as a socket error instead of hanging
        until the application-level ping clock partitions it."""
        if self.keepalive_s <= 0:
            return
        sock = writer.get_extra_info("socket")
        if sock is None:
            return
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            idle = max(1, int(self.keepalive_s))
            if hasattr(socket, "TCP_KEEPIDLE"):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, idle)
            if hasattr(socket, "TCP_KEEPINTVL"):
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, idle
                )
            if hasattr(socket, "TCP_KEEPCNT"):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3)
        except OSError:
            pass  # tuning is advisory; an odd socket type keeps working

    async def _connect(self, peer: int):
        """One transport-aware connection attempt toward ``peer``. TCP
        dials honor ``cluster_connect_timeout_s`` — a WAN SYN that
        blackholes must fail onto the backoff ladder, not hang the dial
        task forever — and apply the keepalive tuning on success."""
        if self.transport == "tcp":
            host, port = self._peer_addr(peer)
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(
                    host, port, ssl=self._tls_context(server=False)
                ),
                timeout=self.connect_timeout_s,
            )
            self._tune_socket(writer)
            return reader, writer
        return await asyncio.open_unix_connection(self._sock_path(peer))

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._loop = loop  # _on_mutation may fire from embedder threads
        self._presence_wake = asyncio.Event()
        if self.transport == "tcp":
            host, port = self._peer_addr(self.worker_id)
            self._unix_server = await asyncio.start_server(
                self._on_peer_connect,
                host,
                port,
                ssl=self._tls_context(server=True),
            )
        else:
            path = self._sock_path(self.worker_id)
            try:
                # brokerlint: ok=R11 one-time stale-socket unlink before bind; start() runs before any frame flows on this loop
                os.unlink(path)
            except FileNotFoundError:
                pass
            self._unix_server = await asyncio.start_unix_server(
                self._on_peer_connect, path
            )
        # connect to lower-numbered peers (they accept from us); retries
        # cover start-order races. Tree mode dials only the current tree
        # NEIGHBORS (plus slow re-join probes toward excluded members) —
        # the O(degree) link bound — and _reconcile_links keeps the dial
        # set in step with epoch changes.
        self._sync_dial_tasks()
        self._tasks.append(
            loop.create_task(self._presence_loop(), name="cluster-presence")
        )
        # the ping loop is also the peer-health clock and the gossip
        # cadence, so it always runs (RTT recording alone needs telemetry)
        self._tasks.append(
            loop.create_task(self._ping_loop(), name="cluster-ping")
        )

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for t in self._dial_tasks.values():
            t.cancel()
        await asyncio.gather(
            *self._tasks, *self._dial_tasks.values(), return_exceptions=True
        )
        self._dial_tasks.clear()
        for w in self._writers.values():
            w.close()
        if self._unix_server is not None:
            self._unix_server.close()
        if self.transport != "tcp":
            try:
                # brokerlint: ok=R11 teardown-path unlink after the server is closed; nothing on this loop still serves
                os.unlink(self._sock_path(self.worker_id))
            except OSError:
                pass

    # re-dial backoff bounds: fast first retries for start-order races,
    # exponential growth (+jitter, mqtt_tpu_torch.resilience.Backoff) so N
    # workers don't hammer a restarting peer in lockstep
    DIAL_BACKOFF_S = 0.05
    DIAL_BACKOFF_MAX_S = 2.0
    # excluded-member re-join probe floor (tree mode): a member voted out
    # of the view is probed gently — contact, not traffic, is the goal
    PROBE_BACKOFF_S = 1.0

    def _dial_wanted(self, peer: int) -> bool:
        """Should this worker hold a dial task toward ``peer``? Mesh
        mode: every lower-numbered peer, forever. Tree mode: current
        tree neighbors (the link budget), plus members EXCLUDED from the
        view — the slow re-join probe that heals a true partition (the
        tree carries no path to them, so only a direct dial can ever
        learn they are back)."""
        if peer >= self.worker_id or self._stopping:
            return False
        if self.topo is None:
            return True
        return self.topo.is_neighbor(peer) or not self.topo.in_view(peer)

    def _sync_dial_tasks(self) -> None:
        """Reconcile the dial-task set with _dial_wanted (cluster loop
        only). Finished/cancelled tasks are pruned so a re-wanted peer
        gets a fresh dialer."""
        loop = self._loop
        if loop is None:
            return
        for peer, task in list(self._dial_tasks.items()):
            if task.done():
                del self._dial_tasks[peer]
            elif not self._dial_wanted(peer):
                task.cancel()
                del self._dial_tasks[peer]
        for peer in range(self.worker_id):
            if self._dial_wanted(peer) and peer not in self._dial_tasks:
                self._dial_tasks[peer] = loop.create_task(
                    self._dial(peer), name=f"cluster-dial-{peer}"
                )

    async def _dial(self, peer: int) -> None:
        """Connect (and RE-connect) to a lower-numbered peer: a dropped
        link — peer restart, wedged-link abort at the control cap — heals
        instead of staying dark until the whole mesh restarts. Retries
        use exponential backoff + jitter (reset once a link is up); on
        reconnect, _register replays full presence so the peer's interest
        map converges."""
        from .resilience import Backoff

        backoff = Backoff(
            initial=self.DIAL_BACKOFF_S,
            maximum=self.DIAL_BACKOFF_MAX_S,
            jitter=0.2,
            seed=self.worker_id * 131 + peer,  # deterministic, desynced
        )
        connected_before = False
        while self._dial_wanted(peer):
            probe = self.topo is not None and not self.topo.in_view(peer)
            try:
                reader, writer = await self._connect(peer)
            except (OSError, asyncio.TimeoutError, ssl.SSLError):
                # an excluded member gets the gentle probe cadence: the
                # fast first-retry ladder is for start-order races, not
                # for hammering a socket that has been dead for minutes
                await asyncio.sleep(
                    max(backoff.next(), self.PROBE_BACKOFF_S if probe else 0.0)
                )
                continue
            hello = json.dumps(
                {"worker": self.worker_id, "boot": self.boot_id}
            ).encode()
            try:
                await self._send(writer, _T_HELLO, hello)
            except (ConnectionError, OSError):
                writer.close()
                await asyncio.sleep(backoff.next())
                continue
            except asyncio.CancelledError:
                # _sync_dial_tasks cancelled us mid-HELLO (re-election
                # demoted the peer): the socket is open but unregistered
                # — nothing else will ever close it
                writer.close()
                raise
            self.control_bytes += len(hello) + 5
            if connected_before:  # start-order races aren't reconnects
                self.reconnects[peer] = self.reconnects.get(peer, 0) + 1
            connected_before = True
            backoff.reset()  # link is up: next outage starts fast again
            if probe:
                # the probe landed: the excluded member is alive again —
                # vote it back in and flood the new epoch
                self._member_contact(peer, 0)
                if not self._dial_wanted(peer):
                    # the re-add made this peer a non-neighbor under the
                    # new tree — and _sync_dial_tasks may have cancelled
                    # THIS task. _reconcile_links already ran (before the
                    # writer was registered), so registering now would
                    # leak an open, unread socket in _writers that nothing
                    # closes until the next epoch change
                    writer.close()
                    return
            self._register(peer, writer)
            try:
                await self._read_loop(peer, reader, writer)
            except asyncio.CancelledError:
                # cancelled mid-read (re-election demoted the peer, or
                # shutdown): the registration must not outlive the task —
                # deregister only if this link still owns the slot
                if self._writers.get(peer) is writer:
                    self._writers.pop(peer, None)
                writer.close()
                raise
            await asyncio.sleep(backoff.next())  # link dropped: re-dial

    async def _on_peer_connect(self, reader, writer) -> None:
        self._tune_socket(writer)  # no-op for unix links / keepalive off
        try:
            mtype, payload = await self._recv(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()
            return
        if mtype != _T_HELLO:
            writer.close()
            return
        hello = json.loads(payload)
        peer = hello["worker"]
        # tree mode: a HELLO is membership evidence — a brand-new or
        # voted-out member re-joins the view (epoch bump + flood), a
        # restarted incarnation's moved boot nonce forces the same (its
        # stale tree must never be resurrected), and a first-time boot
        # nonce is simply learned
        self._member_contact(peer, int(hello.get("boot", 0) or 0))
        self._register(peer, writer)
        await self._read_loop(peer, reader, writer)

    def _register(self, peer: int, writer: asyncio.StreamWriter) -> None:
        self._writers[peer] = writer
        # open a fresh presence generation on the new link: the peer
        # clears everything it knew about us and rebuilds from the full
        # re-advertisement below, so a stale presence frame still in
        # flight on a raced old link can never re-apply (split-brain
        # guard; the generation rides every presence message)
        self.presence_generation += 1
        try:
            self._send_nowait(
                peer,
                writer,
                _T_SYNC,
                json.dumps(
                    {"gen": self.presence_generation, "boot": self.boot_id}
                ).encode(),
            )
        except (ConnectionError, RuntimeError):
            pass  # the link died mid-register: the dial loop heals it
        if self.topo is not None:
            # tree mode: per-filter presence is replaced by the edge
            # summary — announce the current epoch (a stale joiner
            # catches up immediately), re-probe the live trie into the
            # local bloom (covers interest created before any link was
            # up), and push this edge's aggregate
            self._announce_epoch([peer])
            for f in self._populated_filters():
                self._pending_presence.add(f)
            if self._presence_wake is not None:
                self._presence_wake.set()
            self._send_summary(peer, writer, force=True)
        else:
            # announce every currently-populated filter to the new peer:
            # walk the live trie terminals (late joiners must converge)
            for f in self._populated_filters():
                self._pending_presence.add(f)
            if self._presence_wake is not None:
                self._presence_wake.set()
        self._heal_peer(peer, writer)

    # -- peer health (UP -> SUSPECT -> PARTITIONED -> resync) --------------

    def _health_for(self, peer: int) -> _PeerHealth:
        ph = self._health.get(peer)
        if ph is None:
            ph = self._health[peer] = _PeerHealth()
            tele = getattr(self.server, "telemetry", None)
            if tele is not None:
                tele.registry.gauge(
                    "mqtt_tpu_cluster_peer_health_code",
                    "Mesh peer-link health (0=up 1=suspect 2=partitioned)",
                    fn=lambda p=peer: _HEALTH_CODES[
                        self._health[p].state
                    ] if p in self._health else 0,
                    peer=str(peer),
                )
        return ph

    def _park(self, peer: int, mtype: int, payload: bytes) -> None:
        """Hold one QoS>0 forward for a SUSPECT peer in its bounded park
        buffer; the oldest frames spill into the partition drop counters
        once the byte budget is exceeded (bounded memory, never silent)."""
        self._park_entry(peer, ("M", mtype, payload), len(payload))

    def _park_packet(self, peer: int, topic: str, head: dict, body: bytes) -> None:
        """Tree-mode park entry: the decoded pieces, not the serialized
        payload — a replay under a NEW epoch must restamp the route
        header, and a re-election may re-route it through different
        edges entirely."""
        self._park_entry(peer, ("P", topic, dict(head), body), len(body))

    def _park_entry(self, peer: int, entry: tuple, nbytes: int) -> None:
        ph = self._health_for(peer)
        ph.park.append((entry, nbytes))
        ph.park_bytes += nbytes
        self.parked_forwards += 1
        while ph.park_bytes > self.park_max_bytes and len(ph.park) > 1:
            _e, old_n = ph.park.popleft()
            ph.park_bytes -= old_n
            self.parked_forwards -= 1
            self._count_drop(peer, partition=True)
            self.dropped_qos_forwards += 1

    def _drain_park(self, peer: int) -> list[tuple]:
        """Detach and return every parked entry for ``peer`` (counters
        adjusted); the caller decides replay vs re-route vs drop."""
        ph = self._health.get(peer)
        if ph is None:
            return []
        out = []
        while ph.park:
            entry, n = ph.park.popleft()
            ph.park_bytes -= n
            self.parked_forwards -= 1
            out.append(entry)
        return out

    def _heal_peer(self, peer: int, writer) -> None:
        """A (re)connected link: reset the health record to UP and replay
        everything parked while the peer was SUSPECT — exactly once; a
        replay that fails on the fresh link is a counted drop, never a
        duplicate. Tree-mode entries are restamped with the CURRENT
        epoch before the replay, so the receiving edge re-forwards them
        down its (possibly re-elected) subtree; the (origin, boot, seq)
        suppression window makes the whole heal exactly-once even when
        the original send had partially propagated."""
        ph = self._health.get(peer)
        if ph is None:
            return
        ph.state = PEER_UP
        ph.outstanding = 0
        for entry in self._drain_park(peer):
            payload = self._park_payload(entry)
            mtype = entry[1] if entry[0] == "M" else _T_PACKET
            try:
                sent = self._send_nowait(peer, writer, mtype, payload, qos=1)
            except (ConnectionError, RuntimeError):
                sent = False
            if sent:
                self.replayed_forwards += 1
            else:
                self._count_drop(peer, partition=False)
                self.dropped_qos_forwards += 1

    def _park_payload(self, entry: tuple) -> bytes:
        """Serialize one park entry for the wire, restamping tree route
        headers with the FULL current epoch identity (num, boot,
        proposer — receivers re-forward only on an exact triple match,
        so a partial restamp would make every replay read as stale and
        stop at the first hop instead of fanning down the healed
        subtree). The (origin, boot, seq) triple is never touched: it
        is what keeps the replay exactly-once."""
        if entry[0] == "M":
            return entry[2]
        _kind, _topic, head, body = entry
        rt = head.get("rt")
        if isinstance(rt, dict) and self.topo is not None:
            ep = self.topo.epoch
            rt["e"], rt["eb"], rt["ep"] = ep.num, ep.boot, ep.proposer
        return json.dumps(head).encode() + b"\x00" + body

    def _mark_partitioned(self, peer: int) -> None:
        """Give up on a peer: flush its park buffer, forget its pressure
        advert, and abort any live writer so the link-down cleanup +
        re-dial machinery runs. Mesh mode flushes the park into the
        partition drop counters; tree mode instead triggers the SCOPED
        RE-ELECTION (the member leaves the view, the strictly-greater
        epoch floods) and RE-ROUTES the park through the new tree under
        the new epoch — the orphaned subtree's traffic heals instead of
        dropping, and the suppression window keeps it exactly-once."""
        ph = self._health_for(peer)
        if ph.state == PEER_PARTITIONED:
            return
        ph.state = PEER_PARTITIONED
        parked = self._drain_park(peer)
        self._peer_adverts.pop(peer, None)
        self._peer_advert_sigs.pop(peer, None)
        governor = getattr(self.server, "overload", None)
        sig = getattr(governor, "peer_signal", None)
        if sig is not None:
            sig.forget(peer)
        # the SUSPECT grace is over: the peer's announced interest is
        # stale beyond repair — withdraw it (a heal re-advertises)
        self._withdraw_peer(peer)
        _log.warning(
            "peer %d marked PARTITIONED (%d parked forwards held)",
            peer,
            len(parked),
        )
        w = self._writers.get(peer)
        if w is not None:
            try:
                w.transport.abort()
            except Exception:  # brokerlint: ok=R4 transport already torn down; the dial loop re-runs either way
                pass
        if self.topo is not None:
            ep = self.topo.propose_remove(peer)
            self._edge_summaries.pop(peer, None)
            if ep is not None:
                self._reconcile_links()
                self._announce_epoch()
            self._reroute_parked(parked)
        else:
            for _entry in parked:
                self._count_drop(peer, partition=True)
                self.dropped_qos_forwards += 1

    def _reroute_parked(self, parked: list[tuple]) -> None:
        """Send park entries through the CURRENT tree (post re-election
        or re-parent): each re-routed copy counts as a replay; an entry
        no edge claims interest in simply stops here (the summary says
        nobody behind any live edge wants it — not a loss)."""
        for entry in parked:
            if entry[0] != "P":
                continue  # mesh entries never reach here
            _kind, topic, head, body = entry
            payload = self._park_payload(entry)
            for p in self._route_edges(topic, None, bool(head.get("retain"))):
                w = self._writers.get(p)
                ph = self._health.get(p)
                if (ph is not None and ph.state == PEER_SUSPECT) or w is None:
                    self._park_packet(p, topic, head, body)
                    continue
                try:
                    sent = self._send_nowait(p, w, _T_PACKET, payload, qos=1)
                except (ConnectionError, RuntimeError):
                    sent = False
                if sent:
                    self.replayed_forwards += 1
                else:
                    self._count_drop(p, partition=False)
                    self.dropped_qos_forwards += 1

    # -- spanning tree: epochs, summaries, link reconcile --------

    def _member_contact(self, peer: int, boot: int) -> None:
        """Membership evidence from a live connection (HELLO/SYNC): in
        tree mode a new/excluded member is voted back in and a moved
        boot nonce (restarted incarnation) forces a re-election; both
        flood the strictly-greater epoch."""
        if self.topo is None or peer == self.worker_id:
            return
        ep = self.topo.propose_add(peer, boot)
        if ep is not None:
            self._reconcile_links()
            self._announce_epoch()

    def _announce_epoch(
        self, only: Optional[Iterable[int]] = None, digest: bool = False
    ) -> None:
        """Flood the current epoch + member view to tree neighbors (or
        the given peers): receivers holding a smaller epoch adopt and
        re-flood; receivers holding a greater one answer with theirs.
        Edges are never carried — the tree is recomputed identically
        from the view at every hop (mesh_topology.compute_parents).

        ``digest`` sends the 3-int epoch identity WITHOUT the member
        map: the anti-entropy heartbeat. A neighbor whose epoch agrees
        ignores it; one that disagrees answers with its full
        announcement, so the O(N) member map only moves on actual
        divergence and the steady-state per-edge cost stays O(1)."""
        if self.topo is None:
            return
        ep = self.topo.epoch
        body: dict = {"e": [ep.num, ep.boot, ep.proposer]}
        if not digest:
            body["m"] = encode_members(self.topo.members())
            # the pre-agreed root successor is DERIVED (second-lowest live
            # id, mesh_topology.compute_successor) — carried only so
            # operators and the drill harness can observe the agreement;
            # receivers recompute it from the member view and ignore "sc"
            body["sc"] = self.topo.successor()
        payload = json.dumps(body).encode()
        targets = list(only) if only is not None else list(self.topo.neighbors())
        for p in targets:
            w = self._writers.get(p)
            if w is None:
                continue
            try:
                self._send_nowait(p, w, _T_EPOCH, payload)
            except (ConnectionError, RuntimeError):
                continue  # the dial machinery heals it; re-announce rides it

    def _on_epoch(self, peer: int, payload: bytes) -> None:
        try:
            d = json.loads(payload)
            e = d["e"]
            cand = TreeEpoch(int(e[0]), int(e[1]), int(e[2]))
            m = d.get("m")
            members = None if m is None else decode_members(m)
        except (ValueError, TypeError, KeyError, IndexError):
            return  # a malformed announcement must not kill the read loop
        if self.topo is None:
            return
        if members is None:
            # an anti-entropy digest: agreement costs nothing; any
            # divergence (ahead OR behind — adoption needs the member
            # map we don't have) is answered with our full announcement,
            # and the exchange converges in at most one more round trip
            # (the ahead side's answer-back below carries its map)
            if cand != self.topo.epoch:
                self._announce_epoch([peer])
            return
        if self.topo.adopt(cand, members):
            excluded_me = self.worker_id not in members
            if excluded_me:
                # the mesh thought we were dead: the only way back in is
                # an epoch strictly above the one that voted us out
                self.topo.propose_self()
            self._reconcile_links()
            self._announce_epoch(
                p for p in self.topo.neighbors() if excluded_me or p != peer
            )
        elif cand < self.topo.epoch:
            # the sender is behind: answer with the greater epoch so it
            # converges without waiting for the next membership event
            self._announce_epoch([peer])

    def _reconcile_links(self) -> None:
        """Bring links/dials/health in line with the current tree (runs
        on the cluster loop): non-neighbor links close (the O(degree)
        budget is the point of tree mode), ex-neighbors' parked frames
        re-route through the new tree, and the dial set re-syncs."""
        if self.topo is None:
            return
        neighbors = set(self.topo.neighbors())
        for peer, w in list(self._writers.items()):
            if peer in neighbors:
                continue
            self._writers.pop(peer, None)
            try:
                w.transport.abort()
            except Exception:  # brokerlint: ok=R4 racing teardown of a link being closed on purpose
                pass
        for peer in list(self._health):
            if peer in neighbors:
                continue
            parked = self._drain_park(peer)
            self._health.pop(peer, None)
            self._edge_summaries.pop(peer, None)
            self._summary_sent.pop(peer, None)
            self._peer_adverts.pop(peer, None)
            self._peer_advert_sigs.pop(peer, None)
            governor = getattr(self.server, "overload", None)
            sig = getattr(governor, "peer_signal", None)
            if sig is not None:
                sig.forget(peer)
            self._reroute_parked(parked)
        self._sync_dial_tasks()

    def _tree_update_interest(
        self,
        filter: str,
        populated: bool,
        has_plain: bool = True,
        suffixes: frozenset = frozenset(),
    ) -> None:
        """Fold one filter's populated state into the local counted
        bloom, idempotently: the ``_summary_filters`` set guarantees one
        add per live filter and one counted-bloom DELETE per withdrawal
        (the UNSUBSCRIBE path), whatever order probe results land in.
        $SHARE groups and predicate bases summarize as the BASE filter
        publishes actually match (topics.summary_base). The set keys on
        the ORIGINAL filter — `$SHARE/g/a/b` and `a/b` share a base, and
        the counted bloom (not the set) owns that refcount.

        ``has_plain``/``suffixes`` are the filter's push-down split from
        ``_probe_interest`` (the trie stores predicate suffixes on the
        Subscription records, not in the filter text): an unpredicated
        subscriber puts the base in the PLAIN bloom, every predicated
        one refcounts its suffix into the interned digest set. The
        defaults are the conservative topic-only posture — everything plain —
        so a caller without split knowledge can only cost forwards."""
        base = summary_base(filter)
        if populated:
            if filter not in self._summary_filters:
                self._summary_filters.add(filter)
                self._local_interest.add(base)
            else:
                prev = self._filter_pred.get(filter, (True, frozenset()))
                if prev == (has_plain, suffixes):
                    return
                pplain, psfx = prev
                if pplain:
                    self._local_plain.discard(base)
                for s in psfx:
                    self._digest_unref(s)
            if has_plain:
                self._local_plain.add(base)
            for s in suffixes:
                self._digest_ref(s)
            self._filter_pred[filter] = (has_plain, suffixes)
        elif filter in self._summary_filters:
            self._summary_filters.discard(filter)
            self._local_interest.discard(base)
            pplain, psfx = self._filter_pred.pop(filter, (True, frozenset()))
            if pplain:
                self._local_plain.discard(base)
            for s in psfx:
                self._digest_unref(s)

    def _digest_ref(self, sfx: str) -> None:
        refs = self._local_digests.get(sfx, 0)
        self._local_digests[sfx] = refs + 1
        if refs == 0:
            self._digest_gen += 1  # set membership changed: re-advertise

    def _digest_unref(self, sfx: str) -> None:
        refs = self._local_digests.get(sfx, 0)
        if refs <= 1:
            if self._local_digests.pop(sfx, None) is not None:
                self._digest_gen += 1
        else:
            self._local_digests[sfx] = refs - 1

    def _edge_summary_for(
        self, peer: int, local: Optional[BloomBits] = None
    ) -> BloomBits:
        """The aggregate summary advertised ON one edge: local interest
        ∪ every OTHER edge's received summary (TD-MQTT transparent
        aggregation) — the edge answers 'is anything on MY side of the
        tree interested'. ``local`` lets a sweep over every edge pay the
        O(n_bits) counted-bloom export once, not once per edge."""
        bits = self._local_interest.bits() if local is None else local
        for other, es in self._edge_summaries.items():
            if other != peer:
                bits = bits.union(es.bits)
        return bits

    def _edge_pushdown_for(
        self, peer: int, plain: Optional[BloomBits] = None
    ) -> tuple[BloomBits, Optional[tuple]]:
        """The push-down planes advertised ON one edge: the aggregate
        PLAIN bloom and the aggregate digest tuple (None = unknown,
        receiver must stay conservative). An other-edge summary without
        push-down info folds its WHOLE bloom into the plain plane — its
        subtree's predicated interest then reads as plain, which only
        costs forwards, never deliveries. The digest set is capped
        (summary_digest_cap): past it the list stops enumerating the
        predicates soundly, so it degrades to None."""
        pbits = self._local_plain.bits() if plain is None else plain
        digests: Optional[dict[int, str]] = {
            predicate_digest(sfx): sfx for sfx in self._local_digests
        }
        for other, es in self._edge_summaries.items():
            if other == peer:
                continue
            if es.plain is None:
                # pre-push-down sender: every subscriber behind the edge
                # counts as plain — the receiver forwards on any bloom
                # match, exactly the topic-only behavior for that subtree
                pbits = pbits.union(es.bits)
                continue
            pbits = pbits.union(es.plain)
            if es.digests is None:
                # the edge has a plain split but could not ENUMERATE its
                # predicates (downstream cap overflow): our list would
                # be incomplete, so the whole digest plane degrades to
                # unknown — plain still filters, predicates pass through
                digests = None
            elif digests is not None:
                for d, sfx in es.digests:
                    digests[int(d)] = str(sfx)
        if digests is not None and (
            self.summary_digest_cap <= 0
            or len(digests) > self.summary_digest_cap
        ):
            digests = None
        return pbits, (
            tuple(sorted(digests.items())) if digests is not None else None
        )

    def _send_summary(
        self,
        peer: int,
        writer,
        force: bool = False,
        local: Optional[BloomBits] = None,
        plain: Optional[BloomBits] = None,
    ) -> None:
        """Push this edge's aggregate when anything feeding it moved
        since the last send (local generation, epoch) — or always, on
        ``force`` (fresh link)."""
        if self.topo is None:
            return
        # the FULL epoch identity, not just the number: two concurrent
        # proposals can share a num (different boot/proposer tie-breaks),
        # and a summary computed under the losing tree must read stale
        # on the winner's — comparing numbers alone would let it filter
        # forwards toward a subtree whose membership changed
        ep = self.topo.epoch
        ep_key = (ep.num, ep.boot, ep.proposer)
        # remote summary changes bump no local counter, so fold the
        # received generations into the freshness key — EXCLUDING this
        # edge's own (its summary is not part of what we send it; folding
        # it in would make every receipt trigger a send back, and two
        # neighbors would ping-pong summaries forever). The plain bloom
        # and digest set ride the same summary, so their generations
        # fold in too.
        gen = (
            self._local_interest.generation
            + self._local_plain.generation
            + self._digest_gen
            + sum(
                es.gen
                for other, es in self._edge_summaries.items()
                if other != peer
            )
        )
        if not force and self._summary_sent.get(peer) == (gen, ep_key):
            return
        bits = self._edge_summary_for(peer, local)
        pbits, digests = self._edge_pushdown_for(peer, plain)
        head_d = {
            "e": ep.num,
            "eb": ep.boot,
            "ep": ep.proposer,
            "g": gen,
            "all": bits.match_all,
            # push-down planes: nb splits the body into the
            # all-interest and plain blooms; pd enumerates the interned
            # predicate digests (null = unknown, stay conservative).
            # Pre-push-down receivers ignore all three — their oversized
            # BloomBits degrades to match-all on union, conservative.
            "nb": len(bits.data),
            "pall": pbits.match_all,
            "pd": [[d, sfx] for d, sfx in digests]
            if digests is not None
            else None,
        }
        head = json.dumps(head_d).encode()
        try:
            if self._send_nowait(
                peer, writer, _T_SUMMARY, head + b"\x00" + bits.data + pbits.data
            ):
                self._summary_sent[peer] = (gen, ep_key)
        except (ConnectionError, RuntimeError):
            pass  # the link is dying; the heal re-sends with force=True

    def _send_summaries(self) -> None:
        """Refresh every live edge's summary (gossip cadence + after a
        batch of interest mutations)."""
        if self.topo is None:
            return
        local = self._local_interest.bits()  # one export for the sweep
        plain = self._local_plain.bits()
        for peer in self.topo.neighbors():
            w = self._writers.get(peer)
            if w is not None:
                self._send_summary(peer, w, local=local, plain=plain)

    def _on_summary(self, peer: int, payload: bytes) -> None:
        try:
            sep = payload.index(b"\x00")
            head = json.loads(payload[:sep])
            body = payload[sep + 1 :]
            nb = head.get("nb")
            plain: Optional[BloomBits] = None
            if nb is not None and 0 < int(nb) * 2 <= len(body):
                nb = int(nb)
                plain = BloomBits(
                    bytes(body[nb : 2 * nb]), bool(head.get("pall", False))
                )
                body = body[:nb]
            bits = BloomBits(bytes(body), bool(head.get("all", False)))
            pd = head.get("pd")
            digests: Optional[tuple] = None
            if isinstance(pd, list):
                digests = tuple(
                    (int(d), str(sfx)) for d, sfx in pd
                )
            gen = int(head.get("g", 0))
            # a head missing the boot/proposer fields stores a key no
            # live epoch can equal: conservative pass-through, not trust
            ep_key = (
                int(head.get("e", -1)),
                int(head.get("eb", -1)),
                int(head.get("ep", -1)),
            )
        except (ValueError, TypeError):
            return  # malformed summary: keep the stale one (conservative)
        first = peer not in self._edge_summaries
        self._edge_summaries[peer] = _EdgeSummary(
            bits, gen, ep_key, plain, digests
        )
        tele = getattr(self.server, "telemetry", None)
        if first and tele is not None:
            tele.registry.gauge(
                "mqtt_tpu_cluster_edge_summary_fill_ratio",
                "Fill ratio of the interest summary last received on a "
                "tree edge (1.0 ≈ saturated, everything forwards)",
                fn=lambda p=peer: (
                    self._edge_summaries[p].bits.fill_ratio()
                    if p in self._edge_summaries
                    else 0.0
                ),
                peer=str(peer),
            )
        # the subtree behind this edge changed: aggregates sent on OTHER
        # edges fold this summary in, so let the refresh re-derive them
        self._send_summaries()

    def _route_edges(
        self,
        topic: str,
        exclude: Optional[int],
        always: bool = False,
        payload: Optional[bytes] = None,
    ) -> list[int]:
        """The tree edges a publish on ``topic`` travels: every current
        neighbor except the arrival edge, gated by that edge's received
        interest summary. A missing summary, or one stamped under a
        different epoch (the subtree behind the edge may have changed
        shape), passes conservatively — correctness never hangs on
        summary freshness, only efficiency does. ``always`` bypasses the
        gate (retained replication reaches every worker).

        ``payload`` arms the predicate push-down: when the
        edge's bloom matches but only PREDICATED subscribers could be
        behind it (the plain bloom misses) and the summary enumerates
        their digests, each digest's rule is evaluated here with the
        same host interpreter the destination runs — every rule failing
        means the destination would deliver to no one, so the edge is
        skipped and counted. Any gap (no payload, no plain split, no
        digest list, an unparseable rule) forwards conservatively."""
        if self.topo is None:
            return []
        out = []
        ep = self.topo.epoch
        ep_key = (ep.num, ep.boot, ep.proposer)
        for p in self.topo.neighbors():
            if p == exclude:
                continue
            if always:
                out.append(p)
                continue
            stored = self._edge_summaries.get(p)
            if stored is None or stored.ep_key != ep_key:
                self.summary_passthrough_forwards += 1
                out.append(p)
            elif stored.bits.might_match(topic):
                if (
                    payload is None
                    or stored.plain is None
                    or stored.plain.might_match(topic)
                    or stored.digests is None
                    or self._digests_pass(stored.digests, payload)
                ):
                    out.append(p)
                else:
                    self.summary_predicate_filtered_forwards += 1
            else:
                self.summary_filtered_forwards += 1
        return out

    def _digests_pass(self, digests: tuple, payload: bytes) -> bool:
        """Could ANY of the edge's interned predicates PASS this
        payload? Mirrors the destination's own evaluation
        (predicates.eval_rule_host — float32-coerced, skip-to-pass), so
        False here guarantees the destination would deliver nothing:
        push-down never loses a delivery a direct forward would have
        made. Aggregation rules and anything uncompilable count as PASS
        (their verdict depends on destination state we cannot see)."""
        if not digests:
            return False
        doc: Any = None
        for _digest, sfx in digests:
            spec = self._digest_spec(sfx)
            if spec is None:
                return True  # unknowable: conservative
            try:
                if doc is None:
                    try:
                        doc = json.loads(payload)
                    except (ValueError, UnicodeDecodeError):
                        doc = False  # parsed, not JSON (non-None marker)
                if eval_rule_host(spec, payload, doc):
                    return True
            except Exception:
                return True  # evaluation trouble: conservative
        return False

    def _digest_spec(self, sfx: str):
        """The compiled spec for one received suffix, cached; None =
        always-pass (aggregation windows carry destination state, and a
        suffix that fails to compile proves nothing)."""
        try:
            return self._digest_specs[sfx]
        except KeyError:
            pass
        spec = None
        try:
            compiled = compile_suffix(sfx)
            if not compiled.window:  # aggregation rules stay conservative
                spec = compiled
        except (ValueError, TypeError):
            spec = None
        if len(self._digest_specs) > 4096:  # bounded memory beats perfection
            self._digest_specs.clear()
        self._digest_specs[sfx] = spec
        return spec

    @staticmethod
    def _frame_topic(frame: bytes) -> str:
        """The topic of a raw PUBLISH frame (intermediate tree hops gate
        re-forwarding on it); "" on any parse trouble — the caller must
        treat that as match-everything, never as match-nothing."""
        from .server import publish_frame_body_offset

        try:
            off = publish_frame_body_offset(frame)
            tl = (frame[off] << 8) | frame[off + 1]
            return frame[off + 2 : off + 2 + tl].decode("utf-8", "replace")
        except (IndexError, ValueError):
            return ""

    @staticmethod
    def _frame_payload(frame: bytes, v5: bool = False) -> Optional[bytes]:
        """The application payload of a raw PUBLISH frame — the predicate
        push-down gate's evaluation input. ``v5`` skips the properties
        block (tree _T_PACKET bodies are always encoded v5; the QoS0
        passthrough frames are v4). None on any parse trouble — the
        caller must treat that as forward-conservatively, never filter."""
        from .server import publish_frame_body_offset

        try:
            off = publish_frame_body_offset(frame)
            tl = (frame[off] << 8) | frame[off + 1]
            i = off + 2 + tl
            if (frame[0] >> 1) & 0x3:
                i += 2  # packet id rides QoS>0 frames only
            if v5:
                mult = 1
                plen = 0
                while True:  # properties length varint
                    b = frame[i]
                    i += 1
                    plen += (b & 0x7F) * mult
                    if not (b & 0x80):
                        break
                    mult *= 128
                i += plen
            if i > len(frame):
                return None
            return bytes(frame[i:])
        except (IndexError, ValueError):
            return None

    def _route_stamp(self) -> dict:
        """A fresh route header for an ORIGINATING publish: the full
        epoch identity (two concurrent proposals can share a number, so
        telling live from raced-by-a-re-election frames needs the exact
        triple) plus the (origin, boot, seq) key of the suppression
        window that makes any forwarding — matched epoch or not —
        loop-free and deliver-at-most-once per worker."""
        assert self.topo is not None
        ep = self.topo.epoch
        return {
            "e": ep.num,
            "eb": ep.boot,
            "ep": ep.proposer,
            "o": self.worker_id,
            "b": self.boot_id,
            "s": next(self._seq),
        }

    def _note_route(self, rt: Any) -> int:
        """Record a routed frame's (origin, boot, seq) in the window and
        return the routing verdict: ROUTE_NEW (deliver + re-forward),
        ROUTE_REFORWARD (a parked copy re-routed under a strictly NEWER
        epoch crossed a worker the original already visited — re-forward
        down the live tree so the subtree it now heads for still heals,
        but never re-deliver), or ROUTE_DUP (skip everything — counted,
        never silent).

        A frame whose origin is THIS incarnation is always a duplicate:
        the origin delivered locally at publish time and never records
        its own sends, so a replay echoing back through re-elected
        edges (mixed-epoch trees can route a frame back to its source)
        must stop here, not re-deliver to the origin's subscribers."""
        try:
            o = int(rt["o"])
            b = int(rt.get("b", 0))
            s = int(rt["s"])
        except (KeyError, ValueError, TypeError):
            return ROUTE_NEW  # unparseable header: deliver, don't suppress
        if o == self.worker_id and b == self.boot_id:
            self.duplicates_suppressed += 1
            return ROUTE_DUP
        try:
            ep_key: Optional[tuple[int, int, int]] = (
                int(rt["e"]), int(rt["eb"]), int(rt["ep"])
            )
        except (KeyError, ValueError, TypeError):
            ep_key = None
        verdict = self._dup.route(o, b, s, ep_key)
        if verdict != ROUTE_NEW:
            # delivery was suppressed either way; the REFORWARD copy
            # still travels (that is the exactly-once-HEAL half)
            self.duplicates_suppressed += 1
        return verdict

    def _epoch_current(self, rt: dict) -> bool:
        """Does the frame's route header name EXACTLY the tree this
        worker runs? Missing fields (older peers) default to matching —
        the suppression window still backstops them."""
        assert self.topo is not None
        ep = self.topo.epoch
        try:
            return (
                int(rt.get("e", -1)) == ep.num
                and int(rt.get("eb", ep.boot)) == ep.boot
                and int(rt.get("ep", ep.proposer)) == ep.proposer
            )
        except (ValueError, TypeError):
            return False

    def _route_frame_tree(
        self, topic: str, frame: bytes, origin: str, clock: Any = None
    ) -> None:
        """Origin-side tree routing of a QoS0 v4 passthrough frame: one
        _T_RFRAME per summary-matching edge, all carrying the same
        (origin, boot, seq) stamp — each receiver is a distinct worker
        and sees it once; re-forwarding fans it down the tree."""
        edges = self._route_edges(
            topic, None, payload=self._frame_payload(frame)
        )
        if not edges:
            return
        ob = origin.encode()
        prefix = struct.pack(">H", len(ob)) + ob
        tracer = self._tracer()
        traced = tracer is not None and getattr(clock, "trace_id", None) is not None
        route = self._route_stamp()
        if clock is not None:
            # the route json already rides every _T_RFRAME, so ANY
            # sampled clock (traced or not) contributes its origin
            # elapsed stamp to the remote-path delivery SLI
            route["el"] = round(time.perf_counter() - clock.t0, 6)
            tid = getattr(clock, "trace_id", None)
            if tid is not None:
                route["tid"] = tid
        payload = b""
        if not traced:
            rj = json.dumps(route).encode()
            payload = prefix + struct.pack(">H", len(rj)) + rj + frame
        for p in edges:
            fsid = ""
            t0 = 0.0
            if traced:
                # a fresh forward-span id per edge rides the route json:
                # the receiving hop's remote_fanout span parents on it
                fsid = tracer.new_span_id()
                route["tid"] = clock.trace_id
                route["sid"] = fsid
                rj = json.dumps(route).encode()
                payload = prefix + struct.pack(">H", len(rj)) + rj + frame
                t0 = time.perf_counter()
            sent = False
            w = self._writers.get(p)
            if w is None:  # edge briefly dark: QoS0 never parks
                self._count_drop(p, partition=True)
            else:
                try:
                    sent = self._send_nowait(p, w, _T_RFRAME, payload, qos=0)
                except (ConnectionError, RuntimeError):
                    self._count_drop(p)
            if traced:
                tracer.add_span(
                    "forward", "cluster", clock.trace_id, fsid,
                    clock.span_id, t0, time.perf_counter() - t0,
                    {"peer": p, "topic": topic, "sent": bool(sent)},
                )

    def _route_packet_tree(self, pk: Packet) -> None:
        """Origin-side tree routing of a decoded publish (QoS>0 / v5 /
        retained): the mesh _T_PACKET encoding plus the ``rt`` route
        header. Retained replication rides every edge unconditionally
        (all workers must converge on the retained store); QoS>0 to a
        SUSPECT edge parks exactly as in mesh mode — but the park holds
        the decoded pieces, so a heal or re-election can restamp and
        re-route it."""
        topic = pk.topic_name
        retain = bool(pk.fixed_header.retain)
        edges = self._route_edges(topic, None, retain, payload=pk.payload)
        if not edges:
            return
        c = pk.copy(False)
        c.protocol_version = 5
        c.fixed_header.qos = pk.fixed_header.qos
        c.packet_id = pk.packet_id or pk.fixed_header.qos  # encoder guard
        if topic[0] == NS_CHAR:
            # tenant-scoped keys never ride an MQTT frame (the wire
            # format forbids U+0000): the frame carries the LOCAL topic
            # and the head carries the namespace, re-scoped at delivery
            c.topic_name = ns_local(topic)
        body = bytearray()
        c.publish_encode(body)
        body_b = bytes(body)
        qos = pk.fixed_header.qos
        head = {
            "origin": pk.origin,
            "created": pk.created,
            "expiry": pk.expiry,
            "retain": retain,
            "qos": qos,
            "rt": self._route_stamp(),
        }
        if topic[0] == NS_CHAR:
            head["ns"] = ns_tenant(topic)
            u = self._origin_username(pk.origin)
            if u:
                head["u"] = u
        tracer = self._tracer()
        clock = getattr(pk, "_tclock", None)
        if clock is not None:
            # origin elapsed-at-forward duration for the remote-path
            # delivery SLI (see forward_packet)
            head["el"] = round(time.perf_counter() - clock.t0, 6)
        traced = tracer is not None and getattr(clock, "trace_id", None) is not None
        payload = b"" if traced else json.dumps(head).encode() + b"\x00" + body_b
        tier_qos = 1 if retain else qos
        for p in edges:
            fsid = ""
            t_f0 = 0.0
            if traced:
                fsid = tracer.new_span_id()
                head["trace"] = {"tid": clock.trace_id, "sid": fsid}
                payload = json.dumps(head).encode() + b"\x00" + body_b
                t_f0 = time.perf_counter()
            w = self._writers.get(p)
            ph = self._health.get(p)
            if tier_qos > 0 and (
                (ph is not None and ph.state == PEER_SUSPECT)
                or (w is None and (ph is None or ph.state != PEER_PARTITIONED))
            ):
                self._park_packet(p, topic, head, body_b)
                if traced:
                    tracer.add_span(
                        "forward", "cluster", clock.trace_id, fsid,
                        clock.span_id, t_f0, time.perf_counter() - t_f0,
                        {"peer": p, "topic": topic, "parked": True},
                    )
                continue
            if w is None:
                self._count_drop(p, partition=True)
                sent = False
            else:
                try:
                    sent = self._send_nowait(p, w, _T_PACKET, payload, qos=tier_qos)
                except (ConnectionError, RuntimeError):
                    self._count_drop(p)
                    sent = False
            if traced:
                tracer.add_span(
                    "forward", "cluster", clock.trace_id, fsid,
                    clock.span_id, t_f0, time.perf_counter() - t_f0,
                    {"peer": p, "topic": topic, "sent": bool(sent)},
                )
            if not sent and qos > 0:
                self.dropped_qos_forwards += 1

    def _reforward_packet(
        self, peer: int, head: dict, rt: dict, payload: bytes, frame: bytes
    ) -> None:
        """Intermediate-hop re-forward of a routed _T_PACKET down every
        OTHER matching edge of the LIVE tree, with the same park
        semantics per SUSPECT edge. A frame stamped under a different
        tree identity (a re-election raced it mid-flight) still
        re-forwards — dropping it would starve the whole downstream
        subtree — it is just counted: loop safety comes from the
        (origin, boot, seq) window, which lets each worker process a
        frame at most once, not from epoch agreement."""
        if not self._epoch_current(rt):
            self.stale_epoch_frames += 1
        topic = self._frame_topic(frame)
        ns = head.get("ns")
        if ns and topic:
            # tenant-scoped publish (mqtt_tpu_torch.tenancy): the frame rides
            # the mesh with its LOCAL topic, but edge interest summaries
            # hold namespace-SCOPED prefixes — route (and park) on the
            # re-scoped key or a fresh summary filters the publish out
            # at every intermediate hop
            topic = ns_scope_topic(str(ns), topic)
        retain = bool(head.get("retain"))
        qos = int(head.get("qos", 0) or 0)
        tier_qos = 1 if retain else qos
        for p in self._route_edges(
            topic,
            peer,
            retain or not topic,
            payload=self._frame_payload(frame, v5=True),
        ):
            w = self._writers.get(p)
            ph = self._health.get(p)
            if tier_qos > 0 and (
                (ph is not None and ph.state == PEER_SUSPECT)
                or (w is None and (ph is None or ph.state != PEER_PARTITIONED))
            ):
                self._park_packet(p, topic, head, frame)
                continue
            if w is None:
                self._count_drop(p, partition=True)
                if qos > 0:
                    self.dropped_qos_forwards += 1
                continue
            try:
                sent = self._send_nowait(p, w, _T_PACKET, payload, qos=tier_qos)
            except (ConnectionError, RuntimeError):
                self._count_drop(p)
                sent = False
            if not sent and qos > 0:
                self.dropped_qos_forwards += 1

    def _on_rframe(self, peer: int, payload: bytes) -> None:
        """A tree-routed QoS0 passthrough frame: suppress duplicates,
        re-forward VERBATIM down the live tree's other matching edges,
        then deliver locally (trace context, when present, rides the
        route json)."""
        (olen,) = struct.unpack(">H", payload[:2])
        origin = payload[2 : 2 + olen].decode()
        off = 2 + olen
        (rlen,) = struct.unpack(">H", payload[off : off + 2])
        rt = json.loads(payload[off + 2 : off + 2 + rlen])
        frame = payload[off + 2 + rlen :]
        if not isinstance(rt, dict) or self.topo is None:
            return
        verdict = self._note_route(rt)
        if verdict == ROUTE_DUP:
            return  # already traveled through this worker
        if not self._epoch_current(rt):
            # raced by a re-election: counted, then re-forwarded anyway
            # under the live tree — the suppression window (not epoch
            # agreement) is what makes forwarding loop-safe
            self.stale_epoch_frames += 1
        topic = self._frame_topic(frame)
        for p in self._route_edges(
            topic, peer, not topic, payload=self._frame_payload(frame)
        ):
            w = self._writers.get(p)
            if w is None:
                self._count_drop(p, partition=True)
                continue
            try:
                self._send_nowait(p, w, _T_RFRAME, payload, qos=0)
            except (ConnectionError, RuntimeError):
                self._count_drop(p)
        if verdict == ROUTE_REFORWARD:
            return  # already delivered here under an older tree
        t0 = time.perf_counter()
        self._deliver_frame(
            frame, origin, el=rt.get("el"), tid=rt.get("tid")
        )
        if rt.get("tid"):
            self._remote_span(
                "remote_fanout",
                {"tid": rt.get("tid"), "sid": rt.get("sid")},
                t0,
                {"from_peer": peer},
            )

    # -- wire helpers ------------------------------------------------------

    @staticmethod
    async def _send(writer, mtype: int, payload: bytes) -> None:
        writer.write(struct.pack(">IB", len(payload) + 1, mtype) + payload)
        await writer.drain()

    # per-peer write-buffer cap: a stalled peer must cost bounded memory.
    # Past it, forwards DROP (accounted) — the same posture as the bounded
    # per-client outbound queue (server.py drop accounting). Presence
    # messages get 8x headroom because peers' correctness depends on them;
    # a peer too wedged to drain even control traffic has its link CLOSED
    # (its interest map is stale beyond repair anyway).
    MAX_PEER_BUFFER = 8 * 1024 * 1024

    def _qos0_fraction_for(self, peer: int) -> float:
        """The effective QoS0 forward-tier fraction for one destination:
        the LOCAL governor's tier, further reduced by the destination
        peer's own advertised posture (pressure gossip) — a forward to a
        shedding peer would be shed on arrival, so don't spend buffer on
        it here. 0.0 means shed outright."""
        frac = 1.0
        governor = getattr(self.server, "overload", None)
        if governor is not None:
            frac = governor.qos0_forward_fraction()
        adv = self._peer_adverts.get(peer)
        if adv is not None:
            state_code, _p, t = adv
            if time.monotonic() - t < self.advert_ttl_s:
                if state_code >= 2:  # destination advertises SHED
                    return 0.0
                if state_code == 1 and governor is not None:
                    frac = min(
                        frac, governor.config.qos0_forward_throttle_fraction
                    )
                elif state_code == 1:
                    frac = min(frac, 0.5)
        return frac

    def _send_control_batch(self, writer, mtype: int, payloads: list) -> bool:
        """``_send_nowait`` for a run of control frames of one type to one
        peer, in as few writes as the control cap (8x ``MAX_PEER_BUFFER``)
        allows: the cap is held before each frame, as the JAX cluster's one
        write a frame holds it. Each write takes the frames that would find
        the link's buffer within the cap were every one of them to stay in
        it; the buffer is read again after it. A frame that finds the buffer
        past the cap is not written and the link is closed there.
        ``control_bytes`` counts every frame but that one, as the JAX
        cluster's does (its later frames go to the closed link)."""
        frames = [struct.pack(">IB", len(p) + 1, mtype) + p for p in payloads]
        self.control_bytes += sum(map(len, frames))
        cap = 8 * self.MAX_PEER_BUFFER
        i = 0
        while i < len(frames):
            buffered = writer.transport.get_write_buffer_size()
            if buffered > cap:
                _log.warning("peer link wedged past the control cap; closing")
                writer.transport.abort()
                self.control_bytes -= len(frames[i])
                return False
            k = i
            while k < len(frames) and buffered <= cap:
                buffered += len(frames[k])
                k += 1
            writer.write(b"".join(frames[i:k]))
            i = k
        return True

    def _send_nowait(
        self, peer: int, writer, mtype: int, payload: bytes, qos: int = 1
    ) -> bool:
        """Best-effort peer write; returns False when the forward was
        dropped at the buffer cap (counted globally and per peer — the
        caller decides whether the drop also weakens QoS>0 delivery and
        counts that class separately).

        Shedding is TIERED under the overload governor (mqtt_tpu_torch.
        overload): QoS0 forwards shed first at a reduced fraction of the
        cap while the broker throttles/sheds — or outright when the
        DESTINATION peer's gossip advertises SHED — QoS>0 forwards keep
        the full buffer, and control traffic (presence/sync) never
        sheds: it gets 8x headroom and a wedged-link close instead."""
        buffered = writer.transport.get_write_buffer_size()
        if mtype in (_T_PRESENCE, _T_SYNC, _T_EPOCH, _T_SUMMARY):
            if buffered > 8 * self.MAX_PEER_BUFFER:
                _log.warning("peer link wedged past the control cap; closing")
                writer.transport.abort()
                return False
        else:
            cap = self.MAX_PEER_BUFFER
            if qos == 0:
                frac = self._qos0_fraction_for(peer)
                if frac <= 0.0:
                    # destination-advertised SHED: an expendable forward
                    # its governor would drop on arrival sheds HERE
                    self._count_drop(peer, partition=False)
                    self.shed_qos0_forwards += 1
                    governor = getattr(self.server, "overload", None)
                    if governor is not None:
                        governor.note_shed()
                    return False
                if frac < 1.0:
                    cap = int(cap * frac)
            if buffered > cap:
                self._count_drop(peer, partition=False)
                if (
                    qos == 0
                    and cap < self.MAX_PEER_BUFFER
                    and buffered <= self.MAX_PEER_BUFFER
                ):
                    # a governor SHED only when the REDUCED tier cap was
                    # the deciding limit — past the full cap this drop
                    # would have happened anyway and must not inflate
                    # the shed gauges
                    self.shed_qos0_forwards += 1
                    governor = getattr(self.server, "overload", None)
                    if governor is not None:
                        governor.note_shed()
                return False
        writer.write(struct.pack(">IB", len(payload) + 1, mtype) + payload)
        if mtype in _CONTROL_TYPES:
            self.control_bytes += len(payload) + 5
        return True

    def _buffer_pressure(self) -> float:
        """Worst peer write-buffer occupancy against MAX_PEER_BUFFER —
        the governor's cluster pressure signal."""
        worst = 0
        for w in list(self._writers.values()):
            try:
                worst = max(worst, w.transport.get_write_buffer_size())
            except Exception:  # brokerlint: ok=R4 racing teardown: a closed transport is empty, pressure 0 is correct
                continue
        return worst / self.MAX_PEER_BUFFER

    @staticmethod
    async def _recv(reader):
        head = await reader.readexactly(5)
        (n, mtype) = struct.unpack(">IB", head)
        payload = await reader.readexactly(n - 1)
        return mtype, payload

    # -- link telemetry ----------------------------------------------------

    PING_INTERVAL_S = 5.0

    def _rtt_hist(self, peer: int):
        """The per-peer forward-latency histogram on the server's
        telemetry registry ($SYS + /metrics surface it)."""
        return self.server.telemetry.registry.histogram(
            "mqtt_tpu_cluster_peer_rtt_seconds",
            "Mesh peer-link round-trip time (ping/pong over the forward "
            "socket — the peer-forward latency proxy)",
            peer=str(peer),
        )

    async def _ping_loop(self) -> None:
        """Periodically time a round trip on every live peer link. The
        ping rides the same socket as forwards, so a link backed up with
        forward traffic shows its queueing delay here — the closest
        observable to one-way forward latency without synced clocks.

        This loop is also (1) the GOSSIP cadence: every tick each peer
        receives this worker's governor posture + pressure, and (2) the
        peer-HEALTH clock: a peer that misses ``suspect_pings``
        consecutive pongs goes SUSPECT (QoS>0 forwards park), and at
        ``partition_pings`` it is PARTITIONED (park flushed, link
        aborted so the dial machinery re-runs) — asymmetric partitions,
        where writes still succeed but nothing comes back, are caught
        here rather than waiting for a socket error that never comes."""
        metrics_tick = 0
        # metric federation rides the gossip cadence, FLOOR-BOUNDED to
        # ~1 frame/s per edge: a registry summary is orders of magnitude
        # bigger than a ping, and the drill-grade fast clocks (0.1s
        # pings, 32 workers on 2 cores) must not spend their CPU
        # re-encoding an unchanged registry 10x a second
        metrics_every = max(1, math.ceil(1.0 / self.PING_INTERVAL_S))
        while not self._stopping:
            await asyncio.sleep(self.PING_INTERVAL_S)
            self._gossip_now()
            self._send_summaries()  # tree mode: the summary refresh cadence
            metrics_tick += 1
            if metrics_tick >= metrics_every:
                metrics_tick = 0
                self._metrics_gossip_now()  # metric federation
            if self.topo is not None:
                # anti-entropy: a proposal flood can be LOST mid-storm
                # (the link it rode was being severed), leaving two live
                # fragments on different epochs forever. A 3-int DIGEST
                # per edge per tick guarantees neighbors reconcile — the
                # O(N) member map only moves when a digest disagrees, so
                # the steady-state control rate stays O(degree), not
                # O(degree * N)
                self._announce_epoch(digest=True)
            peers = set(self._writers) | set(self._health)
            if self.topo is not None:
                # tree mode: only tree EDGES carry a health clock (the
                # reconcile pass retires ex-neighbor records; a stray
                # non-neighbor link is closing, not aging)
                peers &= set(self.topo.neighbors())
            for peer in peers:
                w = self._writers.get(peer)
                ph = self._health_for(peer)
                if w is not None:
                    try:
                        w.write(
                            struct.pack(">IB", 9, _T_PING)
                            + struct.pack(">d", time.perf_counter())
                        )
                        self.control_bytes += 13
                    except (ConnectionError, RuntimeError):
                        pass  # link teardown races: aged below anyway
                elif ph.state == PEER_UP and not ph.park:
                    continue  # no link, nothing held: nothing to age
                ph.outstanding += 1
                if ph.outstanding >= self.partition_pings:
                    self._mark_partitioned(peer)
                elif (
                    ph.outstanding >= self.suspect_pings
                    and ph.state == PEER_UP
                ):
                    ph.state = PEER_SUSPECT
                    _log.warning(
                        "peer %d marked SUSPECT (%d unanswered pings)",
                        peer,
                        ph.outstanding,
                    )
                    self._maybe_promote_root(peer)

    def _maybe_promote_root(self, peer: int) -> None:
        """Root-failure fast path: when the peer that just
        went SUSPECT is the tree ROOT and *this* worker is the
        pre-agreed successor (second-lowest live id — which is always
        the root's direct heap child, so it observes the death
        first-hand on its own ping clock), promote IMMEDIATELY: drop
        the root from the view and flood the new epoch. Every other
        worker adopts the strictly-greater epoch on arrival — no
        ``partition_pings`` wait, no full scoped re-election blackout.

        False suspicion converges safely: a live root that receives an
        epoch excluding itself re-proposes (``propose_self`` in
        ``_on_epoch``) and rejoins under a strictly-greater epoch — at
        no point are there two roots within one adopted epoch, because
        the root is DERIVED from the member view (lowest id)."""
        topo = self.topo
        if topo is None or self._stopping:
            return
        if peer != topo.root() or self.worker_id != topo.successor():
            return
        t0 = time.perf_counter()
        if topo.propose_remove(peer) is None:
            return  # lost a race with another membership event: give up
        self.root_failovers += 1
        self._reconcile_links()
        self._announce_epoch()
        dt = time.perf_counter() - t0
        self.root_failover_last_s = dt
        if self._root_failover_hist is not None:
            self._root_failover_hist.observe(dt)
        _log.warning(
            "root %d suspected dead: successor %d promoted, epoch %s "
            "flooded in %.6fs",
            peer,
            self.worker_id,
            topo.epoch,
            dt,
        )

    def _on_pong(self, peer: int, payload: bytes) -> None:
        ph = self._health_for(peer)
        ph.outstanding = 0
        if ph.state == PEER_SUSPECT:
            # the link answered after all: heal in place, replay the park
            w = self._writers.get(peer)
            if w is not None:
                self._heal_peer(peer, w)
            else:
                ph.state = PEER_UP
        if getattr(self.server, "telemetry", None) is None:
            return
        if len(payload) != 8:
            return
        (t0,) = struct.unpack(">d", payload)
        rtt = time.perf_counter() - t0
        if 0 <= rtt < 60:  # a clock anomaly must not pollute the histogram
            self._rtt_hist(peer).observe(rtt)

    # -- pressure gossip ---------------------------------------------------

    def _local_advert(self) -> Optional[tuple[int, float, dict[str, float]]]:
        """This worker's own advert triple: governor state code, scalar
        pressure, and the PER-SIGNAL breakdown (
        operators need to see WHY a subtree is hot, not just how hot).
        The ``peers`` signal is excluded from the breakdown: it is
        derived FROM adverts, and re-advertising it would compound."""
        governor = getattr(self.server, "overload", None)
        if governor is None:
            return None
        from .overload import _STATE_CODES

        sigs = {
            k: round(v, 4)
            for k, v in governor.signal_pressures.items()
            if k != "peers"
        }
        return (
            _STATE_CODES.get(governor.state, 0),
            round(governor.pressure, 4),
            sigs,
        )

    def _advert_payload(self, exclude: Optional[int] = None) -> Optional[bytes]:
        """One gossip payload. Mesh mode: the local advert, broadcast
        identically to every peer. Tree mode: the PER-SUBTREE fold — the
        advert sent on edge E is the elementwise max of this worker's
        posture and the live adverts received on every OTHER edge, so
        one frame per edge per tick (O(degree) gossip volume) still
        tells each neighbor how hot everything behind this worker is."""
        local = self._local_advert()
        if local is None:
            return None
        s, p, sigs = local
        governor = getattr(self.server, "overload", None)
        reserve = (
            governor.reserve_advert()
            if governor is not None and hasattr(governor, "reserve_advert")
            else 0
        )
        if self.topo is not None:
            now = time.monotonic()
            for peer, (ps, pp, t) in list(self._peer_adverts.items()):
                if peer == exclude or now - t >= self.advert_ttl_s:
                    continue
                s = max(s, ps)
                p = max(p, pp)
                # reserve spend folds by SUM: tree edges partition the
                # mesh, so each neighbor's subtree total plus the local
                # spend reconstructs the mesh-wide budget draw
                reserve += self._peer_advert_reserve.get(peer, 0)
                for k, v in self._peer_advert_sigs.get(peer, {}).items():
                    if v > sigs.get(k, 0.0):
                        sigs[k] = v
        body = {"s": s, "p": p, "sig": sigs}
        if reserve:
            body["r"] = reserve
        return json.dumps(body).encode()

    def _gossip_now(self) -> None:
        """Advertise this worker's governor posture to every live peer
        (must run on the cluster's loop — writers are loop-affine)."""
        if self.topo is None:
            payload = self._advert_payload()
            if payload is None:
                return
            for _peer, w in list(self._writers.items()):
                try:
                    w.write(
                        struct.pack(">IB", len(payload) + 1, _T_GOSSIP) + payload
                    )
                    self.control_bytes += len(payload) + 5
                except (ConnectionError, RuntimeError):
                    continue  # link teardown races: the dial loop heals it
            return
        for peer in self.topo.neighbors():
            w = self._writers.get(peer)
            if w is None:
                continue
            payload = self._advert_payload(exclude=peer)
            if payload is None:
                return
            try:
                w.write(struct.pack(">IB", len(payload) + 1, _T_GOSSIP) + payload)
                self.control_bytes += len(payload) + 5
            except (ConnectionError, RuntimeError):
                continue  # link teardown races: the dial loop heals it

    # -- metric federation --------------------------------------

    def _metrics_gossip_now(self) -> None:
        """Ship this worker's registry summary at gossip cadence. Tree
        mode sends the per-SUBTREE fold — this worker's own summary plus
        every entry learned on child edges — up to its parent only, so
        the root aggregates the whole mesh over O(depth) hops while each
        edge carries each worker's summary exactly once per tick.
        All-pairs mode broadcasts the own summary to every peer (each
        worker then holds the full mesh view). Frames ride the QoS>0
        buffer tier (a storm is exactly when operators need the metrics
        plane to keep federating) but are data-tier, never control."""
        cm = self.metrics_fed
        tele = getattr(self.server, "telemetry", None)
        if cm is None or tele is None:
            return
        # resolve targets BEFORE building the summary: the tree root
        # (and a worker with every target link dark) must not pay a
        # full registry walk per tick just to throw it away
        if self.topo is not None:
            parent = self.topo.parent_of(self.worker_id)
            if parent is None:
                cm.entries()  # still age out dead children's summaries
                return  # the root only aggregates; nothing flows upward
            targets = [parent]
        else:
            targets = list(self._writers)
        if not any(p in self._writers for p in targets):
            return
        self._metrics_seq += 1
        workers: dict = {
            str(self.worker_id): {
                "b": self.boot_id,
                "q": self._metrics_seq,
                "f": tele.registry.summary(),
            }
        }
        if self.topo is not None:
            for wid, ent in cm.entries().items():
                workers.setdefault(
                    str(wid), {"b": ent["b"], "q": ent["q"], "f": ent["f"]}
                )
        payload = json.dumps({"w": workers}).encode()
        for p in targets:
            w = self._writers.get(p)
            if w is None:
                continue
            try:
                if self._send_nowait(p, w, _T_METRICS, payload, qos=1):
                    self.metrics_frames_tx += 1
            except (ConnectionError, RuntimeError):
                continue  # link teardown races: the dial loop heals it

    def _on_metrics(self, peer: int, payload: bytes) -> None:
        """Ingest a peer's federated summaries; (boot, seq) keying makes
        a re-delivered or reordered frame a no-op (counter folding stays
        idempotent)."""
        cm = self.metrics_fed
        if cm is None:
            return
        try:
            d = json.loads(payload)
            workers = d.get("w")
        except (ValueError, TypeError):
            return  # a malformed frame must not kill the read loop
        if not isinstance(workers, dict):
            return
        self.metrics_frames_rx += 1
        for wid, ent in workers.items():
            if str(wid) == str(self.worker_id) or not isinstance(ent, dict):
                continue  # this worker's own summary never loops back in
            fams = ent.get("f")
            if not isinstance(fams, dict):
                continue
            try:
                cm.ingest(
                    str(wid), int(ent.get("b", 0)), int(ent.get("q", 0)), fams
                )
            except (ValueError, TypeError):
                continue  # one bad entry must not drop its siblings

    def _dispatch_on_loop(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the cluster's loop from ANY thread: inline when
        already there (or before start, when nothing loop-affine exists
        yet), else through ``call_soon_threadsafe`` — a cross-thread
        callback touching writers/events directly can be lost or corrupt
        loop state (the brokerlint R2 contract). The presence wake and
        the transition gossip both route through here."""
        loop = self._loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        local = loop is None or running is loop
        if _LOOP_PLANE.active:
            w = _LOOP_PLANE.witness
            if w is not None:
                w.note(
                    "cluster_writer",
                    "dispatch_local" if local else "dispatch_cross",
                )
        if local:
            fn()
        else:
            try:
                loop.call_soon_threadsafe(fn)
            except RuntimeError:
                pass  # loop already closed: shutdown race, nothing to run

    def _gossip_soon(self) -> None:
        """Schedule an immediate gossip round from any thread: governor
        transitions fire wherever evaluate() ran, and writers may only
        be touched on the cluster's loop."""
        if self._loop is None:
            return  # not started: no writers to gossip to
        self._dispatch_on_loop(self._gossip_now)

    def _on_gossip(self, peer: int, payload: bytes) -> None:
        try:
            d = json.loads(payload)
            state_code = int(d.get("s", 0))
            pressure = float(d.get("p", 0.0))
            reserve = int(d.get("r", 0))
            raw_sigs = d.get("sig")
            sigs = (
                {str(k): float(v) for k, v in raw_sigs.items()}
                if isinstance(raw_sigs, dict)
                else {}
            )
        except (ValueError, TypeError):
            return  # a malformed advert must not kill the read loop
        self._peer_adverts[peer] = (state_code, pressure, time.monotonic())
        if sigs:
            self._peer_advert_sigs[peer] = sigs
        if reserve:
            self._peer_advert_reserve[peer] = reserve
        else:
            self._peer_advert_reserve.pop(peer, None)
        governor = getattr(self.server, "overload", None)
        if governor is not None and hasattr(governor, "note_peer_reserve"):
            # mesh-wide admission reserve: this edge's (subtree) spend
            # draws from the local governor's budget too
            governor.note_peer_reserve(peer, reserve)
        sig = getattr(governor, "peer_signal", None)
        if sig is not None:
            known = sig.signal_names()
            sig.observe(peer, state_code, pressure, signals=sigs or None)
            tele = getattr(self.server, "telemetry", None)
            if tele is not None:
                # lazily register one gauge per NEW per-signal breakdown
                # name (the _rtt_hist idiom): operators read why a
                # subtree is hot straight off /metrics
                for name in sig.signal_names() - known:
                    tele.registry.gauge(
                        "mqtt_tpu_cluster_peer_signal_pressure",
                        "Decayed max of one overload signal across peer "
                        "gossip adverts (the per-signal WHY behind the "
                        "folded peers pressure)",
                        fn=lambda n=name, s=sig: s.signal_value(n),
                        signal=name,
                    )

    # -- presence sync -----------------------------------------------------

    def _on_mutation(self, m) -> None:
        """Trie observer (called under the trie lock): queue the filter;
        the presence loop computes its populated state off-lock and
        broadcasts idempotently.

        Mutations can originate OFF the event loop (inline_subscribe from
        an embedder thread, the delta matcher's rebuild thread), and
        ``asyncio.Event.set`` is not thread-safe — a cross-thread set can
        be lost, leaving peers with stale interest forever. The wake is
        therefore routed through ``call_soon_threadsafe`` whenever the
        caller is not the cluster's own loop."""
        if not m.filter:
            return
        self._pending_presence.add(m.filter)
        wake = self._presence_wake
        if wake is None:
            return
        self._dispatch_on_loop(wake.set)

    def _populated_filters(self) -> list[str]:
        """Every filter with at least one subscriber, from the live trie
        (lock-free walk, tears retried by the caller's cadence)."""
        from .ops.flat import _walk_terminals

        out = []
        try:
            for path, node in _walk_terminals(self.server.topics):
                base = "/".join(path)
                for group in list(node.shared.internal):
                    out.append(f"{SHARE_PREFIX}/{group}/{base}")
                if node.subscriptions.internal or node.inline_subscriptions.internal:
                    out.append(base)
        except (RuntimeError, KeyError):
            pass  # racing mutations re-enter via the observer anyway
        return out

    def _probe_populated(self, f: str) -> tuple[bool, bool]:
        """(has_subscribers, inline_only) for one filter on the live trie."""
        share_rooted = f.split("/", 1)[0].upper() == SHARE_PREFIX
        for _ in range(8):
            try:
                node = self.server.topics._seek(f, 2 if share_rooted else 0)
                if node is None:
                    return False, False
                has_cli = bool(node.subscriptions.internal) or bool(
                    node.shared.internal
                )
                has_inl = bool(node.inline_subscriptions.internal)
                return has_cli or has_inl, has_inl and not has_cli
            except (RuntimeError, KeyError):
                continue
        return True, False  # persistent tear: err on the forwarding side

    def _probe_interest(self, f: str) -> tuple[bool, bool, frozenset]:
        """(has_subscribers, has_plain, predicate_suffixes) for one
        filter on the live trie — the push-down split. The
        filter TEXT is always the base (the trie splits MQTT+ suffixes
        off at SUBSCRIBE time); the suffixes live on the Subscription
        records at the node, so only a node walk can recover them. A
        subscriber without predicates makes the base PLAIN (always
        forward on bloom match); every predicated one contributes its
        suffix to the interned digest set. A persistent lock tear reads
        as plain — forwards, never a miss."""
        share_rooted = f.split("/", 1)[0].upper() == SHARE_PREFIX
        for _ in range(8):
            try:
                node = self.server.topics._seek(f, 2 if share_rooted else 0)
                if node is None:
                    return False, False, frozenset()
                plain = False
                sfx = set()
                subs: list = list(node.subscriptions.internal.values())
                subs.extend(node.inline_subscriptions.internal.values())
                for group in node.shared.internal.values():
                    subs.extend(group.values())
                for sub in subs:
                    preds = getattr(sub, "predicates", ()) or ()
                    if preds:
                        sfx.update(preds)
                    else:
                        plain = True
                return bool(subs), plain, frozenset(sfx)
            except (RuntimeError, KeyError):
                continue
        return True, True, frozenset()  # persistent tear: read as plain

    async def _presence_loop(self) -> None:
        while True:
            await self._presence_wake.wait()
            self._presence_wake.clear()
            pending, self._pending_presence = self._pending_presence, set()
            if self.topo is not None:
                # tree mode: the same mutation stream feeds the LOCAL
                # interest bloom instead of per-filter presence frames —
                # a populated filter counts in once, an emptied one is a
                # counted-bloom DELETE — and changed edge aggregates push
                # right away (tests and subscribers shouldn't wait a
                # whole gossip tick for routability)
                for f in pending:
                    populated, has_plain, suffixes = self._probe_interest(f)
                    self._tree_update_interest(
                        f, populated, has_plain, suffixes
                    )
                self._send_summaries()
                await asyncio.sleep(0)
                continue
            msgs = []
            for f in pending:
                populated, inline_only = self._probe_populated(f)
                msgs.append(json.dumps(
                    {
                        "filter": f,
                        "populated": populated,
                        "inline": inline_only,
                        # the split-brain guard: presence below the last
                        # sync's generation (same incarnation) is stale
                        # and discarded
                        "gen": self.presence_generation,
                        "boot": self.boot_id,
                    }
                ).encode())
            # one write a peer for the whole flush: the frames are the
            # same bytes, but a transport's buffer is a list of the writes
            # it could not send yet, and each write sums it, so a storm of
            # per-frame writes to a backed-up link costs its square
            for peer, w in list(self._writers.items()):
                try:
                    self._send_control_batch(w, _T_PRESENCE, msgs)
                except (ConnectionError, RuntimeError):
                    pass
            # yield so bursts coalesce instead of one message per mutation
            await asyncio.sleep(0)

    def _apply_sync(self, peer: int, gen: int, boot: Optional[int] = None) -> None:
        """A peer opened a fresh presence generation (it (re)connected):
        clear everything it previously announced — the full
        re-advertisement that follows rebuilds it — and refuse any
        later-arriving presence stamped below this generation (a raced
        stale link's frames must not resurrect withdrawn filters).

        Generations compare only within one peer INCARNATION (the boot
        nonce): a restarted peer's counter begins again at 1, and its
        sync must win, not be rejected against the dead incarnation's
        high-water mark."""
        stored = self._peer_gen.get(peer)
        if stored is not None and boot == stored[0] and gen <= stored[1]:
            return  # an older link's sync arriving late: ignore
        self._peer_gen[peer] = (boot, gen)
        self._withdraw_peer(peer)

    def _presence_stale(self, peer: int, d: dict) -> bool:
        """True when a presence frame predates the peer's last sync:
        same incarnation with a lower generation (a raced stale link's
        leftovers), or a DIFFERENT incarnation than the one the last
        sync opened (frames from a dead process). A frame without a
        boot id (older peer version) only checks the generation."""
        stored = self._peer_gen.get(peer)
        if stored is None:
            return False
        boot = d.get("boot")
        if boot is not None and stored[0] is not None and boot != stored[0]:
            return True  # a dead incarnation's leftovers
        return d.get("gen", 0) < stored[1]

    def _apply_presence(self, peer: int, filter: str, populated: bool, inline: bool) -> None:
        announced = self._peer_filters.setdefault(peer, set())
        if populated:
            announced.add(filter)
        else:
            announced.discard(filter)
        pseudo = f"\x00w{peer}"
        if populated:
            # inline-only filters follow inline gather rules on $-topics
            # [MQTT-4.7.1-1/2]: mirror kind so forwarding decisions match
            if inline:
                self.remote.inline_subscribe(
                    InlineSubscription(
                        filter=filter, identifier=peer + 1, handler=_noop_inline
                    )
                )
                self.remote.unsubscribe(filter, pseudo)
            else:
                self.remote.subscribe(pseudo, Subscription(filter=filter))
        else:
            self.remote.unsubscribe(filter, pseudo)
            self.remote.inline_unsubscribe(peer + 1, filter)

    # -- forwarding (origin side) ------------------------------------------

    def _interested_peers(self, topic: str) -> tuple[int, ...]:
        """Peers with at least one matching subscriber, via the remote
        pseudo-trie; cached per (topic, remote version)."""
        version = self.remote.version
        cached = self._plan_cache.get(topic)
        if cached is not None and cached[0] == version:
            return cached[1]
        subs = self.remote.subscribers(topic)
        peers = set()
        for pseudo in subs.subscriptions:
            peers.add(int(pseudo[2:]))
        for group in subs.shared.values():
            for pseudo in group:
                peers.add(int(pseudo[2:]))
        for ident in subs.inline_subscriptions:
            peers.add(ident - 1)
        plan = tuple(sorted(peers))
        if len(self._plan_cache) >= 4096:
            self._plan_cache.clear()
        self._plan_cache[topic] = (version, plan)
        return plan

    def _count_drop(self, peer: int, partition: bool = False) -> None:
        """One forward lost to ``peer``, classed: ``partition`` drops
        (link down / peer partitioned / park overflow) vs backlog drops
        (buffer cap, write faults on a live link) count separately so
        the park buffer's effect is observable — but both still feed the
        ``dropped_forwards`` total and the per-peer counter. Same 'never
        silent' posture as ever."""
        self.dropped_forwards += 1
        self.dropped_by_peer[peer] = self.dropped_by_peer.get(peer, 0) + 1
        if partition:
            self.dropped_partition += 1
        else:
            self.dropped_backlog += 1

    def _tracer(self):
        """The server's trace plane (mqtt_tpu_torch.tracing.Tracer) or None."""
        tele = getattr(self.server, "telemetry", None)
        return getattr(tele, "tracer", None) if tele is not None else None

    def _remote_span(self, name: str, tr, t0: float, args: dict) -> None:
        """Record the receiving-side span of a forwarded traced publish:
        the trace context parsed off the wire parents it on the origin
        worker's forward span, so merged exports read as one trace."""
        tracer = self._tracer()
        if tracer is None or not isinstance(tr, dict):
            return
        tid = tr.get("tid")
        if not isinstance(tid, str) or not tid:
            return
        tracer.add_span(
            name,
            "cluster",
            tid,
            tracer.new_span_id(),
            tr.get("sid"),
            t0,
            time.perf_counter() - t0,
            args,
        )

    def forward_frame(
        self, topic: str, frame: bytes, origin: str, clock=None
    ) -> None:
        """Forward a QoS0 v4 passthrough frame to interested peers
        verbatim (the fast path's cluster leg). A traced publish's clock
        (mqtt_tpu_torch.tracing.PublishTrace) switches the wire type to
        _T_TFRAME so the trace context rides along, and records one
        ``forward`` span per peer. Tree mode routes along summary-gated
        tree edges instead (_T_RFRAME, re-forwarded at every hop)."""
        if self.topo is not None:
            self._route_frame_tree(topic, frame, origin, clock)
            return
        peers = self._interested_peers(topic)
        if not peers:
            return
        ob = origin.encode()
        tracer = self._tracer()
        if tracer is None or getattr(clock, "trace_id", None) is None:
            if clock is not None:
                # sampled-but-untraced publish: the origin's elapsed
                # stamp still rides a _T_TFRAME json head (tid-less —
                # the receiver's _remote_span no-ops, only the
                # remote-path delivery SLI records), so the DEFAULT
                # all-pairs topology federates remote QoS0 latency even
                # with tracing off (tree mode's route json always did)
                tj = json.dumps(
                    {"el": round(time.perf_counter() - clock.t0, 6)}
                ).encode()
                payload = (
                    struct.pack(">H", len(ob)) + ob
                    + struct.pack(">H", len(tj)) + tj + frame
                )
                mtype = _T_TFRAME
            else:
                payload = struct.pack(">H", len(ob)) + ob + frame
                mtype = _T_FRAME
            for p in peers:
                w = self._writers.get(p)
                if w is None:  # link down but interest not yet withdrawn
                    self._count_drop(p, partition=True)
                    continue
                try:
                    self._send_nowait(p, w, mtype, payload, qos=0)
                except (ConnectionError, RuntimeError):
                    self._count_drop(p)
            return
        prefix = struct.pack(">H", len(ob)) + ob
        for p in peers:
            # a fresh forward-span id per peer rides the wire: the
            # peer's remote_fanout span parents on exactly this one
            fsid = tracer.new_span_id()
            tj = json.dumps(
                {
                    "tid": clock.trace_id,
                    "sid": fsid,
                    # origin elapsed-at-forward for the remote-path SLI
                    "el": round(time.perf_counter() - clock.t0, 6),
                }
            ).encode()
            payload = prefix + struct.pack(">H", len(tj)) + tj + frame
            t0 = time.perf_counter()
            sent = False
            w = self._writers.get(p)
            if w is None:
                self._count_drop(p, partition=True)
            else:
                try:
                    sent = self._send_nowait(p, w, _T_TFRAME, payload, qos=0)
                except (ConnectionError, RuntimeError):
                    self._count_drop(p)
            tracer.add_span(
                "forward",
                "cluster",
                clock.trace_id,
                fsid,
                clock.span_id,
                t0,
                time.perf_counter() - t0,
                {"peer": p, "topic": topic, "sent": bool(sent)},
            )

    def _origin_username(self, origin: str) -> str:
        """The origin client's username (tenant key identity) — carried
        on encrypted-namespace forwards so a username-keyed publisher
        still resolves on workers where its session does not exist."""
        clients = getattr(self.server, "clients", None)
        cl = clients.get(origin) if clients is not None else None
        if cl is None:
            return ""
        u = cl.properties.username
        return (
            u.decode("utf-8", "replace")
            if isinstance(u, (bytes, bytearray))
            else (u or "")
        )

    def forward_packet(self, pk: Packet) -> None:
        """Forward a decoded publish (QoS>0 / v5 / retained) to interested
        peers; retained messages go to ALL peers so every worker converges
        on the retained store."""
        topic = pk.topic_name
        if not topic or topic.startswith("$"):
            return  # $SYS is per-worker; never forwarded
        if topic[0] == NS_CHAR and ns_local(topic).startswith("$"):
            # per-tenant $SYS ticks (mqtt_tpu_torch.tenancy) are per-worker
            # too: the scoped key hides the local "$" from the gate above
            return
        if self.topo is not None:
            self._route_packet_tree(pk)
            return
        if pk.fixed_header.retain:
            peers = tuple(p for p in self._writers)
        else:
            peers = self._interested_peers(topic)
        if not peers:
            return
        # re-encode canonically as v5 on a copy (copy drops the per-
        # connection topic alias [MQTT-3.3.2-7] and the DUP flag)
        c = pk.copy(False)
        c.protocol_version = 5
        c.fixed_header.qos = pk.fixed_header.qos
        c.packet_id = pk.packet_id or pk.fixed_header.qos  # encoder guard
        if topic[0] == NS_CHAR:
            # tenant-scoped keys never ride an MQTT frame (the wire
            # format forbids U+0000): the frame carries the LOCAL topic
            # and the head carries the namespace, re-scoped at delivery
            c.topic_name = ns_local(topic)
        body = bytearray()
        c.publish_encode(body)
        head = {
            "origin": pk.origin,
            "created": pk.created,
            "expiry": pk.expiry,
            "retain": bool(pk.fixed_header.retain),
            "qos": pk.fixed_header.qos,
        }
        if topic[0] == NS_CHAR:
            head["ns"] = ns_tenant(topic)
            u = self._origin_username(pk.origin)
            if u:
                head["u"] = u
        body_b = bytes(body)
        # trace plane: a traced publish's context rides the json head
        # ("trace" key — older peers ignore it) with a DISTINCT forward
        # span id per peer; untraced publishes encode the payload once
        tracer = self._tracer()
        clock = getattr(pk, "_tclock", None)
        if clock is not None:
            # delivery-latency SLI: the origin's elapsed
            # DURATION at forward time rides the head — monotonic clocks
            # do not align cross-process, so only the duration travels;
            # the receiver adds its own delivery segment (path=remote)
            head["el"] = round(time.perf_counter() - clock.t0, 6)
        traced = tracer is not None and getattr(clock, "trace_id", None) is not None
        payload = b"" if traced else json.dumps(head).encode() + b"\x00" + body_b
        qos = pk.fixed_header.qos
        # retained forwards are replicated STATE (every worker's retained
        # store must converge), not expendable fan-out: keep them out of
        # the governor's QoS0 shed tier even at QoS0
        tier_qos = 1 if pk.fixed_header.retain else qos
        for p in peers:
            fsid = ""
            t_f0 = 0.0
            if traced:
                fsid = tracer.new_span_id()
                head["trace"] = {"tid": clock.trace_id, "sid": fsid}
                payload = json.dumps(head).encode() + b"\x00" + body_b
                t_f0 = time.perf_counter()
            w = self._writers.get(p)
            ph = self._health.get(p)
            if tier_qos > 0 and (
                (ph is not None and ph.state == PEER_SUSPECT)
                or (w is None and (ph is None or ph.state != PEER_PARTITIONED))
            ):
                # partition tolerance: a SUSPECT peer (missed pongs, or a
                # just-dropped link inside the heal window) holds QoS>0
                # forwards in the bounded park buffer instead of dropping
                # them — the heal replays them exactly once
                self._park(p, _T_PACKET, payload)
                if traced:
                    tracer.add_span(
                        "forward", "cluster", clock.trace_id, fsid,
                        clock.span_id, t_f0, time.perf_counter() - t_f0,
                        {"peer": p, "topic": topic, "parked": True},
                    )
                continue
            if w is None:  # down past the heal window / partitioned
                self._count_drop(p, partition=True)
                sent = False
            else:
                try:
                    sent = self._send_nowait(p, w, _T_PACKET, payload, qos=tier_qos)
                except (ConnectionError, RuntimeError):
                    self._count_drop(p)
                    sent = False
            if traced:
                tracer.add_span(
                    "forward", "cluster", clock.trace_id, fsid,
                    clock.span_id, t_f0, time.perf_counter() - t_f0,
                    {"peer": p, "topic": topic, "sent": bool(sent)},
                )
            if not sent and qos > 0:
                # the known-limits drop class: cross-worker QoS1/2
                # degrades to best-effort at the buffer cap or across a
                # dropping link — counted, never silent
                # ($SYS dropped_qos_forwards)
                self.dropped_qos_forwards += 1

    # -- delivery (receiving side) -----------------------------------------

    def _withdraw_peer(self, peer: int) -> None:
        """Withdraw every filter the peer announced: withdrawals
        generated during an outage are lost, so stale entries would
        otherwise forward forever. Runs when the peer is declared
        PARTITIONED — and on heal via the generation sync, where the
        full re-advertisement rebuilds the map from scratch."""
        pseudo = f"\x00w{peer}"
        for f in self._peer_filters.pop(peer, ()):
            self.remote.unsubscribe(f, pseudo)
            self.remote.inline_unsubscribe(peer + 1, f)

    def _on_link_down(self, peer: int, writer) -> None:
        """One peer link dropped: deregister the writer (only if this
        link still owns the slot — a reconnect may have raced the stale
        link's teardown) and mark the peer SUSPECT, NOT gone: its
        announced interest stays live and QoS>0 forwards for it park
        (bounded) awaiting a quick heal. Only the ping loop's partition
        threshold withdraws the interest and flushes the park into the
        drop counters — replacing the old binary link_down handling
        that silently dropped everything the moment the socket died."""
        if self._writers.get(peer) is writer:
            self._writers.pop(peer, None)
        if self.topo is not None and not self.topo.is_neighbor(peer):
            # tree mode: a closing NON-edge link (reconcile closed it, or
            # a stale joiner moved on) is not an edge failure — retire
            # the record instead of starting a health clock that would
            # end in a bogus re-election against a live member
            parked = self._drain_park(peer)
            self._health.pop(peer, None)
            self._reroute_parked(parked)
            return
        ph = self._health_for(peer)
        if ph.state == PEER_UP:
            ph.state = PEER_SUSPECT
            # a dead ROOT socket is the fast-failover trigger too: the
            # successor must not wait for the ping clock to re-notice
            self._maybe_promote_root(peer)

    async def _read_loop(self, peer: int, reader, writer) -> None:
        self._live_read_loops[peer] = self._live_read_loops.get(peer, 0) + 1
        try:
            await self._read_loop_inner(peer, reader, writer)
        finally:
            self._live_read_loops[peer] -= 1

    async def _read_loop_inner(self, peer: int, reader, writer) -> None:
        while True:
            try:
                mtype, payload = await self._recv(reader)
            except (asyncio.IncompleteReadError, ConnectionError):
                self._on_link_down(peer, writer)
                return
            shaper = self._rx_shaper
            if shaper is not None and not await shaper(peer, mtype, payload):
                # link shaping (the faults plane): the frame was lost, or
                # the shaper took ownership and will dispatch it LATE —
                # either way the read loop moves on immediately, so a
                # shaped propagation delay is latency, never occupancy
                continue
            rx_filter = self._rx_filter
            if rx_filter is not None and not rx_filter(peer, mtype, payload):
                continue  # fault injection (the faults plane): frame lost
            self._rx_dispatch(peer, mtype, payload, writer)

    def _rx_dispatch(
        self, peer: int, mtype: int, payload: bytes, writer=None
    ) -> None:
        """Apply one inbound peer frame (the read loop's dispatch table,
        also the re-entry point for shaper-delayed frames — which pass
        no writer: a pong for a late ping rides the canonical link, or
        is skipped when the link died; pings are re-sent every tick)."""
        if writer is None:
            writer = self._writers.get(peer)
        try:
            if mtype == _T_PRESENCE:
                d = json.loads(payload)
                if self._presence_stale(peer, d):
                    return  # pre-sync / dead-incarnation: discard
                self._apply_presence(
                    peer, d["filter"], d["populated"], d.get("inline", False)
                )
            elif mtype == _T_FRAME:
                (olen,) = struct.unpack(">H", payload[:2])
                origin = payload[2 : 2 + olen].decode()
                self._deliver_frame(payload[2 + olen :], origin)
            elif mtype == _T_TFRAME:
                # a traced passthrough frame: same delivery as
                # _T_FRAME plus the remote-fanout span joining the
                # origin's trace (mqtt_tpu_torch.tracing)
                (olen,) = struct.unpack(">H", payload[:2])
                origin = payload[2 : 2 + olen].decode()
                off = 2 + olen
                (tlen,) = struct.unpack(">H", payload[off : off + 2])
                tr = json.loads(payload[off + 2 : off + 2 + tlen])
                t0 = time.perf_counter()
                self._deliver_frame(
                    payload[off + 2 + tlen :],
                    origin,
                    el=tr.get("el") if isinstance(tr, dict) else None,
                    tid=tr.get("tid") if isinstance(tr, dict) else None,
                )
                self._remote_span(
                    "remote_fanout", tr, t0, {"from_peer": peer}
                )
            elif mtype == _T_PACKET:
                sep = payload.index(b"\x00")
                head = json.loads(payload[:sep])
                frame = payload[sep + 1 :]
                rt = head.get("rt")
                if self.topo is not None and isinstance(rt, dict):
                    # tree-routed: route the suppression verdict —
                    # a DUP skips everything, a re-routed park copy
                    # under a newer epoch re-forwards but must not
                    # deliver twice, a new frame does both
                    verdict = self._note_route(rt)
                    if verdict == ROUTE_DUP:
                        return
                    self._reforward_packet(peer, head, rt, payload, frame)
                    if verdict == ROUTE_REFORWARD:
                        return
                t0 = time.perf_counter()
                self._deliver_packet(head, frame)
                tr = head.get("trace")
                if tr:
                    self._remote_span(
                        "remote_fanout", tr, t0, {"from_peer": peer}
                    )
            elif mtype == _T_RFRAME:
                self._on_rframe(peer, payload)
            elif mtype == _T_EPOCH:
                self._on_epoch(peer, payload)
            elif mtype == _T_SUMMARY:
                self._on_summary(peer, payload)
            elif mtype == _T_PING:
                # echo verbatim; the sender computes the RTT. The raw
                # write bypasses _send_nowait, so count the pong's
                # control bytes here (the catalog row and the drill's
                # O(degree) rate are defined over ping AND pong)
                if writer is not None:
                    writer.write(
                        struct.pack(">IB", len(payload) + 1, _T_PONG) + payload
                    )
                    self.control_bytes += len(payload) + 5
            elif mtype == _T_PONG:
                self._on_pong(peer, payload)
            elif mtype == _T_GOSSIP:
                self._on_gossip(peer, payload)
            elif mtype == _T_METRICS:
                self._on_metrics(peer, payload)
            elif mtype == _T_SYNC:
                d = json.loads(payload)
                self._apply_sync(peer, int(d["gen"]), d.get("boot"))
                # tree mode: the sync's boot nonce is membership
                # evidence too — a moved nonce is a restarted
                # incarnation and forces a re-election (its stale
                # tree must never be resurrected)
                self._member_contact(peer, int(d.get("boot") or 0))
        except Exception:
            _log.exception("cluster delivery failed (peer %d)", peer)

    def _deliver_frame(
        self,
        frame: bytes,
        origin: str,
        el: Any = None,
        tid: Any = None,
    ) -> None:
        """Deliver a forwarded v4 QoS0 frame to local subscribers through
        the server's fast-path plans; write ACL was enforced at the origin
        worker, so only per-target read ACL applies here.

        ``el`` is the origin worker's elapsed-at-forward stamp when the
        frame rode a sampled publish: the whole local
        delivery is timed around it and lands in the remote-path
        delivery-latency SLI (frames are v4 QoS0 and never
        tenant-scoped, so the label cell is the global namespace)."""
        from .server import publish_frame_body_offset

        s = self.server
        tele = getattr(s, "telemetry", None)
        timed = (
            el is not None
            and tele is not None
            and getattr(tele, "delivery_sli", False)
        )
        t0 = time.perf_counter() if timed else 0.0
        if not s.fast_deliver_frame(frame, origin):
            # a local shared/inline/v5 case: decode and take the full path
            pk = Packet(
                fixed_header=FixedHeader(type=PUBLISH), protocol_version=4
            )
            pk.publish_decode(frame[publish_frame_body_offset(frame):])
            pk.origin = origin
            s._stamp_publish_expiry(pk)
            self._deliver_local(pk)
        if timed:
            try:
                base = float(el)
            except (TypeError, ValueError):
                return
            tele.observe_delivery(
                base + time.perf_counter() - t0,
                "",
                0,
                "remote",
                trace_id=tid if isinstance(tid, str) else None,
            )

    def _deliver_packet(self, head: dict, frame: bytes) -> None:
        from .server import publish_frame_body_offset
        from .telemetry import RemoteStageClock

        srv_tele = getattr(self.server, "telemetry", None)
        clock = None
        el = head.get("el")
        if (
            el is not None
            and srv_tele is not None
            and getattr(srv_tele, "delivery_sli", False)
        ):
            # receiving-side delivery clock: starts before
            # the decode below so the remote-path SLI covers this
            # worker's whole delivery segment; the origin's trace id
            # (when present) joins the sample's exemplar to the
            # cross-worker trace
            tr = head.get("trace")
            try:
                clock = RemoteStageClock(
                    float(el),
                    tr.get("tid") if isinstance(tr, dict) else None,
                )
            except (TypeError, ValueError):
                clock = None
        # publish_encode produced a full frame; decode wants only the body
        pk = Packet(
            fixed_header=FixedHeader(
                type=PUBLISH, qos=head.get("qos", 0), retain=head.get("retain", False)
            ),
            protocol_version=5,
        )
        pk.publish_decode(frame[publish_frame_body_offset(frame):])
        pk.origin = head.get("origin", "")
        pk.created = head.get("created", 0)
        pk.expiry = head.get("expiry", 0)
        if clock is not None:
            clock.stamp("decode")
            setattr(pk, "_tclock", clock)
        ns = head.get("ns")
        if ns:
            # tenant-scoped publish (mqtt_tpu_torch.tenancy): the frame rode
            # the mesh with the LOCAL topic (MQTT frames forbid U+0000);
            # restore the namespace before matching/retaining
            pk.topic_name = ns_scope_topic(str(ns), pk.topic_name)
            if head.get("u"):
                # the origin's username rides the head: a username-keyed
                # publisher's key still resolves on THIS worker, where
                # the publishing session does not exist
                setattr(pk, "_origin_user", str(head["u"]))
        if head.get("retain"):
            self.server.retain_message(self._system_client(), pk)
        self._deliver_local(pk)

    def _system_client(self):
        """A local client identity for hook callbacks on forwarded
        messages (the inline client when enabled, else a detached one)."""
        s = self.server
        if s.inline_client is not None:
            return s.inline_client
        cl = getattr(self, "_pseudo_client", None)
        if cl is None:
            from .server import LOCAL_LISTENER

            cl = self._pseudo_client = s.new_client(
                None, None, LOCAL_LISTENER, f"\x00cluster-w{self.worker_id}", True
            )
        return cl

    def _deliver_local(self, pk: Packet) -> None:
        """Local-only fan-out of a forwarded publish (never re-forwarded:
        forwarding happens only at the origin worker)."""
        s = self.server
        pk.packet_id = 0  # QoS state is owned per-worker per-subscriber
        s._fan_out(pk, s.topics.subscribers(pk.topic_name))
        # remote-path delivery SLI: close the receiving-side clock a
        # sampled forward attached in _deliver_packet (no-op without one)
        s._finish_remote_clock(pk)


def worker_env(
    worker_id: int,
    n_workers: int,
    sock_dir: str,
    topology: str = "",
    degree: int = 0,
    transport: str = "",
    base_port: int = 0,
    host: str = "",
) -> dict:
    """Environment for a spawned worker process (read by __main__).
    ``topology``/``degree`` select the spanning-tree fabric mesh-wide —
    every worker must agree, so the launcher owns the choice. The same
    goes for ``transport``/``base_port``/``host``: a TCP mesh
    only forms when every worker derives the same peer address map."""
    env = {
        "MQTT_TPU_WORKER": str(worker_id),
        "MQTT_TPU_WORKERS": str(n_workers),
        "MQTT_TPU_CLUSTER_DIR": sock_dir,
    }
    if topology:
        env["MQTT_TPU_CLUSTER_TOPOLOGY"] = topology
    if degree:
        env["MQTT_TPU_CLUSTER_DEGREE"] = str(degree)
    if transport:
        env["MQTT_TPU_CLUSTER_TRANSPORT"] = transport
    if base_port:
        env["MQTT_TPU_CLUSTER_BASE_PORT"] = str(base_port)
    if host:
        env["MQTT_TPU_CLUSTER_HOST"] = host
    return env


def maybe_attach_from_env(server) -> Optional[Cluster]:
    """Attach a Cluster to ``server`` when worker env vars are present
    (set by the multi-process launcher). Returns the cluster or None.

    ``MQTT_TPU_CLUSTER_DIR`` is REQUIRED alongside ``MQTT_TPU_WORKER``:
    the mesh protocol is unauthenticated, so the socket directory's
    permissions ARE the access control — a predictable world-writable
    default like /tmp would let any local user inject publishes or forge
    presence. The launchers always create a private mkdtemp dir."""
    wid = os.environ.get("MQTT_TPU_WORKER")
    if wid is None:
        return None
    opts = getattr(server, "options", None)
    topo = os.environ.get("MQTT_TPU_CLUSTER_TOPOLOGY")
    if topo and opts is not None:
        opts.cluster_topology = topo
        degree = os.environ.get("MQTT_TPU_CLUSTER_DEGREE")
        if degree:
            opts.cluster_tree_degree = int(degree)
    if opts is not None:
        # transport selection rides env for spawned workers,
        # same contract as topology: every worker must agree
        for env_key, opt_key, conv in (
            ("MQTT_TPU_CLUSTER_TRANSPORT", "cluster_transport", str),
            ("MQTT_TPU_CLUSTER_HOST", "cluster_host", str),
            ("MQTT_TPU_CLUSTER_BASE_PORT", "cluster_base_port", int),
            ("MQTT_TPU_CLUSTER_TLS_CERT", "cluster_tls_cert", str),
            ("MQTT_TPU_CLUSTER_TLS_KEY", "cluster_tls_key", str),
            ("MQTT_TPU_CLUSTER_TLS_CA", "cluster_tls_ca", str),
            (
                "MQTT_TPU_CLUSTER_CONNECT_TIMEOUT_S",
                "cluster_connect_timeout_s",
                float,
            ),
            ("MQTT_TPU_CLUSTER_KEEPALIVE_S", "cluster_keepalive_s", float),
        ):
            raw = os.environ.get(env_key)
            if raw:
                try:
                    setattr(opts, opt_key, conv(raw))
                except ValueError:
                    pass  # a malformed override keeps the default
    sock_dir = os.environ.get("MQTT_TPU_CLUSTER_DIR")
    if not sock_dir:
        raise RuntimeError(
            "MQTT_TPU_WORKER is set but MQTT_TPU_CLUSTER_DIR is not; the "
            "cluster socket dir must be a private directory (the mesh "
            "trusts every connection on it)"
        )
    c = Cluster(
        server,
        int(wid),
        int(os.environ.get("MQTT_TPU_WORKERS", "1")),
        sock_dir,
    )
    ping_s = os.environ.get("MQTT_TPU_CLUSTER_PING_S")
    if ping_s:
        # drill workers run the ping/gossip/health clock fast so a
        # partition storm resolves in seconds, not minutes (instance
        # attribute: shadows the class constant for this worker only)
        c.PING_INTERVAL_S = float(ping_s)
    suspect = os.environ.get("MQTT_TPU_CLUSTER_SUSPECT_PINGS")
    if suspect:
        # a fast ping clock needs a deeper missed-pong window on a
        # CPU-oversubscribed drill box: N workers sharing a couple of
        # cores stall past one ping interval routinely, and a SUSPECT
        # threshold tuned for real links turns scheduler jitter into a
        # perpetual re-election storm. Real cuts still sever the socket
        # (link drop -> SUSPECT immediately), so only stall
        # misclassification is being widened here. A link-flap drill
        # derives its held-cut duration from partition_pings, so held
        # cuts keep crossing the PARTITIONED threshold.
        c.suspect_pings = max(1, int(suspect))
        if c.partition_pings <= c.suspect_pings:
            c.partition_pings = c.suspect_pings + 3
    return c
