"""The broker-facing device matcher.

``TorchMatcher`` compiles the host trie into a :mod:`flat-hash index
<mqtt_tpu_torch.ops.flat>`, matches PUBLISH-topic batches in one device
dispatch, and merges results host-side — bit-identical to
``TopicsIndex.subscribers`` (reference walk: topics.go:583-628) because
every case the device cannot prove is re-walked on the host trie.

The counterpart of the JAX package's ``TpuMatcher``, with the same
policies: the compact-vs-packed encoding pick, the per-batch re-run of a
compact batch whose hits outgrew the pair buffer, the exact-map fast path
for wildcard-free filter sets, and copy-on-write folds of the host index.
The device table departs from the JAX package's functional update: it is
held in two buffers and a fold writes its rows in place into the one no
batch holds (``TorchMatcher.fold``). Results are
materialized by the port's C materializer (``native/accelmod.c``), with
the tenant namespace guards: lazy ``SubscribersView`` results by default
(``lazy=True``, as the JAX package's ``TpuMatcher``), eager ``Subscribers``
with ``lazy=False``. A view reads like a ``Subscribers`` (any of its three
maps materializes it once); ``targets()`` gives the fan-out plan without
building the maps. ``expand_sids``, ``resolve_compact_py``,
``resolve_ranges_py`` and ``expand_snap_py`` are the plain Python versions
the tests hold the C against; no path of the matchers calls them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import native
from ..topics import NS_CHAR, Subscribers, TopicsIndex, ns_guard_mode
from .flat import (
    KIND_CLIENT,
    KIND_SHARED,
    FlatIndex,
    _bucket,
    build_flat_index,
    device_i32,
    device_index_from_numpy,
    flat_match_compact,
    flat_match_packed,
    flat_match_ranges,
    pack_tokens,
    resolve_device,
    scatter_rows,
)
from .hashing import tokenize_topics

# sid slots a topic of the padded slot buffer (the JAX matcher's default
# ``out_slots``): the dense geometry the profiler's transfer ledger
# compares each batch's bytes with
DENSE_SLOTS = 64

# the C materializer, resolved once (native.accel() is itself memoized;
# this skips the call in the per-batch path)
_ACCEL = None


def _accel():
    """The C materializer module (``native/accelmod.c``), built on first
    use; a failed build raises ``native.NativeError``."""
    global _ACCEL
    if _ACCEL is None:
        _ACCEL = native.accel()
    return _ACCEL


def ns_modes(topics: list[str]) -> Optional[np.ndarray]:
    """Each topic's ``ns_guard_mode`` as int8 ``[len(topics)]`` for the C
    materializer, or None when no topic is scoped into a namespace (the
    common case costs one join and one scan)."""
    if NS_CHAR not in "".join(topics):
        return None
    return np.fromiter((ns_guard_mode(t) for t in topics), dtype=np.int8, count=len(topics))


def expand_sids(
    table: list, sids, subs: Subscribers, seen: Optional[set] = None, mode: int = 0
) -> Subscribers:
    """Merge device sub ids (local to ``table``) into a Subscribers result,
    preserving host gather semantics: per-client merge, shared keyed on the
    group filter, inline keyed on identifier. A client's first sighting
    takes ``Subscription.self_merged_copy`` — value-identical to
    ``merge(self, self)`` including the shared-and-extended identifiers
    map — and later sightings call the real ``merge``.

    ``mode`` is the topic's ``ns_guard_mode``: for a scoped topic (mode >
    0) the entries whose guard class the trie excludes
    (``TopicsIndex._ns_excluded``) are dropped before any merge. The
    kernels match filters without the guard, as the JAX package does."""
    if seen is None:
        seen = set()
    if not isinstance(sids, list):
        sids = sids.tolist() if hasattr(sids, "tolist") else list(sids)
    n = len(table)
    if mode:
        sids = [sid for sid in sids if not (0 <= sid < n and 0 < table[sid].guard <= mode)]
    seen_add = seen.add
    subscriptions = subs.subscriptions
    shared = subs.shared
    inline = subs.inline_subscriptions
    memo_get = getattr(table, "memo", {}).get
    for sid in sids:
        if sid < 0 or sid >= n or sid in seen:
            continue
        seen_add(sid)
        entry = memo_get(sid)
        if entry is None:
            entry = table[sid]
        kind = entry.kind
        if kind == KIND_CLIENT:
            client = entry.client
            sub = entry.subscription
            prev = subscriptions.get(client)
            if prev is None:
                subscriptions[client] = sub.self_merged_copy()
            else:
                subscriptions[client] = prev.merge(sub)
        elif kind == KIND_SHARED:
            group = shared.get(entry.group_filter)
            if group is None:
                group = shared[entry.group_filter] = {}
            group[entry.client] = entry.subscription
        else:
            inline[entry.subscription.identifier] = entry.subscription
    return subs


def subscribers_equal(a: Subscribers, b: Subscribers) -> bool:
    """Value equality of two match results: the three gather maps
    (``Subscription`` is a dataclass, so entries compare by value);
    the shared-group selection belongs to fan-out and is not compared."""
    return (
        a.subscriptions == b.subscriptions
        and a.shared == b.shared
        and a.inline_subscriptions == b.inline_subscriptions
    )


def pick_compact_capacity(
    pinned: int,
    hits_ewma: float,
    b_padded: int,
    max_hits: int,
    held_caps: dict,
) -> int:
    """The pair-buffer capacity policy. A pinned capacity is honored at its
    bucket; the adaptive pick sizes EWMA x 1.5 headroom, pow2-bucketed,
    capped at the theoretical hit bound, and STICKY per batch bucket: grow
    the moment the need does (overflows are the expensive path) but
    shrink only once the need sits 4x below the held capacity.
    ``held_caps`` (batch bucket -> capacity) is the caller-owned sticky
    state."""
    if pinned > 0:
        return _bucket(max(1, min(pinned, max_hits)), minimum=8)
    need = _bucket(
        max(1, min(int(b_padded * hits_ewma * 1.5) + 64, max_hits)),
        minimum=256,
    )
    held = held_caps.get(b_padded, 0)
    if need > held or need * 4 <= held:
        held_caps[b_padded] = held = need
    return held


def fold_hits_ewma(ewma: float, n_hits: int, b: int) -> float:
    """One batch's true hit count folded into the capacity EWMA."""
    if b <= 0:
        return ewma
    return 0.7 * ewma + 0.3 * (n_hits / b)


def resolve_compact_py(
    pair_sid: np.ndarray,
    totals: np.ndarray,
    host_route: np.ndarray,
    topics: list[str],
    subs_table: Any,
    n_hits: Optional[int] = None,
    pair_shard: Optional[np.ndarray] = None,
    tables: Optional[list] = None,
) -> tuple[list, list[int]]:
    """Expand a compacted pair stream. The stream is topic-major;
    ``totals`` drives the cursor, so each pair's topic index is implicit.
    Host-routed rows skip their pairs and land in the overflow index list
    (the caller re-walks them). In the sharded form ``pair_shard`` names
    each pair's shard and ``tables`` holds the per-shard sub tables (sid
    spaces are shard-local); ``subs_table`` is then unused.

    ``n_hits`` (when given) enforces the geometry invariant: the totals
    must account for exactly the pair stream — a mismatch means the caller
    mixed buffers from different batches and raises, never a silent
    mis-expansion."""
    if n_hits is not None:
        claimed = int(totals.sum())
        if claimed != n_hits or n_hits > len(pair_sid):
            raise ValueError(
                "compact pair stream and totals disagree "
                f"(totals claim {claimed}, n_hits {n_hits}, "
                f"stream {len(pair_sid)})"
            )
    sids = pair_sid.tolist()
    shards = pair_shard.tolist() if pair_shard is not None else None
    tot = totals.tolist()
    route = host_route.tolist()
    results: list = []
    ovf_idx: list[int] = []
    cursor = 0
    n = len(topics)
    for i, t in enumerate(tot):
        if i >= n:
            break  # bucket-padding rows: nothing to materialize
        if route[i]:
            ovf_idx.append(i)
            results.append(None)
            cursor += t
            continue
        subs = Subscribers()
        mode = ns_guard_mode(topics[i])
        if shards is None:
            expand_sids(subs_table, sids[cursor : cursor + t], subs, mode=mode)
        else:
            # a topic's pairs come shard by shard (segments are topic-major,
            # shard-minor): expand each shard's run against its own table
            j = cursor
            end = cursor + t
            while j < end:
                s = shards[j]
                k = j
                while k < end and shards[k] == s:
                    k += 1
                expand_sids(tables[s], sids[j:k], subs, seen=set(), mode=mode)
                j = k
        results.append(subs)
        cursor += t
    return results, ovf_idx


def _fill_host_rows(stats, host_walk, results, ovf_idx, topics, true_overflow) -> list:
    """Re-walk the host-routed rows of a resolved batch on the live trie
    (counting each as a fallback, and as an overflow when the device
    routed it), and give every empty topic an empty result."""
    n_host = n_ovf = 0
    for i in ovf_idx:
        topic = topics[i]
        if topic:
            n_host += 1
            # routed-only rows are fallbacks but not device overflows
            n_ovf += int(bool(true_overflow[i]))
            results[i] = host_walk(topic)
        else:
            results[i] = Subscribers()
    if n_host:
        stats.add(host_fallbacks=n_host, overflows=n_ovf)
    if "" in topics:  # empty topic never matches (host-walk parity)
        for i, topic in enumerate(topics):
            if not topic:
                results[i] = Subscribers()
    return results


def materialize_compact_pairs(
    stats: "MatcherStats",
    host_walk: Callable[[str], Subscribers],
    pair_sid: np.ndarray,
    totals: np.ndarray,
    host_route: np.ndarray,
    n_hits: int,
    topics: list[str],
    subs_table: Any,
    true_overflow: np.ndarray,
    pair_shard: Optional[np.ndarray] = None,
    tables: Optional[list] = None,
    lazy: bool = False,
) -> list[Subscribers]:
    """Expand one device-compacted batch into Subscribers results through
    the C materializer (``resolve_compact_py`` is its plain version).
    ``totals`` drives a cursor over the topic-major pair stream (padded
    rows included); host-routed topics skip their pairs and re-walk the
    live trie. ``pair_shard``/``tables`` serve the sharded form: each
    pair expands against its shard's table.

    ``lazy=True`` returns ``SubscribersView`` results over the pair
    stream: per-hit objects are built only when a consumer asks. A view
    keeps its stream alive, so it gets its own pageable copy (4 B a hit,
    8 sharded), never the pinned D2H buffer or a kernel's output tensor.
    Host-routed rows carry real Subscribers from the trie walk. A
    mismatch of stream and totals raises ``ValueError`` on either path."""
    acc = _accel()
    if tables is None:
        snaps, window = subs_table.snaps, subs_table.window
    else:
        snaps, window = [t.snaps for t in tables], tables[0].window
    resolve = acc.resolve_compact_views if lazy else acc.resolve_compact
    results, ovf_idx = resolve(
        np.array(pair_sid, dtype=np.int32) if lazy else np.ascontiguousarray(pair_sid, dtype=np.int32),
        None if pair_shard is None else np.array(pair_shard, dtype=np.int32),
        np.ascontiguousarray(totals, dtype=np.int32),
        np.ascontiguousarray(host_route, dtype=np.int32),
        int(n_hits),
        len(topics),
        snaps,
        window,
        Subscribers,
        ns_modes(topics),
    )
    return _fill_host_rows(stats, host_walk, results, ovf_idx, topics, true_overflow)


def expand_snap_py(snap) -> Subscribers:
    """Materialize one node snapshot tuple ``(clients, shared, inline)``
    into a Subscribers result: the single-node case of the host gather
    (topics.go:631-678) and the plain version of the C ``expand_snap``.
    The namespace guard needs no check here: it only drops filters with a
    ``+`` or ``#`` first level, and the exact-map path serves
    wildcard-free filter sets."""
    subs = Subscribers()
    cli, shr, inl = snap
    subscriptions = subs.subscriptions
    for client, sub in cli:
        subscriptions[client] = sub.self_merged_copy()
    if shr:
        shared = subs.shared
        for client, sub in shr:
            group = shared.get(sub.filter)
            if group is None:
                group = shared[sub.filter] = {}
            group[client] = sub
    if inl:
        inline = subs.inline_subscriptions
        for isub in inl:
            inline[isub.identifier] = isub
    return subs


def _ranges_routes(packed, topics, P, len_overflow, pred, batch_pred):
    """The host-route classes of a packed-ranges batch: ``(true_overflow,
    routed)`` — device overflow (sat/spill) or over-deep topics, and the
    delta-routed topic indices."""
    true_overflow = (packed[:, 2 * P + 1] != 0) | len_overflow
    if batch_pred is not None:
        routed = list(batch_pred(topics))
    elif pred is not None:
        routed = [i for i, t in enumerate(topics) if t and pred(t)]
    else:
        routed = []
    return true_overflow, routed


def resolve_ranges_py(
    stats: "MatcherStats", host_walk: Callable[[str], Subscribers], packed, topics, flat,
    P, len_overflow, pred, batch_pred,
) -> list[Subscribers]:
    """The plain version of ``resolve_ranges_native``: the Python loop over
    the packed ranges rows."""
    true_overflow, routed = _ranges_routes(packed, topics, P, len_overflow, pred, batch_pred)
    overflow = true_overflow.tolist()
    routed = frozenset(routed)
    # one bulk conversion: per-row numpy slicing costs ~10us of fixed
    # overhead per topic, plain list walks are ~10x cheaper
    out_rows = packed[:, : 2 * P].tolist()
    results = []
    results_append = results.append
    table = flat.subs
    n_host = n_ovf = 0
    for i, topic in enumerate(topics):
        if not topic:
            results_append(Subscribers())  # empty topic never matches
        elif overflow[i] or i in routed:
            n_host += 1
            n_ovf += int(overflow[i])
            results_append(host_walk(topic))  # host fallback
        else:
            row = out_rows[i]
            sids = []
            for p in range(P):
                c = row[P + p]
                if c:
                    s0 = row[p]
                    sids.extend(range(s0, s0 + c))
            results_append(expand_sids(table, sids, Subscribers(), mode=ns_guard_mode(topic)))
    stats.add(host_fallbacks=n_host, overflows=n_ovf)
    return results


def resolve_ranges_native(
    stats: "MatcherStats", host_walk: Callable[[str], Subscribers], packed, topics, flat,
    P, len_overflow, pred, batch_pred, lazy: bool,
) -> list[Subscribers]:
    """Materialize one already-synced packed-ranges batch through the C
    materializer (JAX ``TpuMatcher._resolve_native``). Every host-route
    class (device overflow, over-deep topics, delta-routed topics) is
    merged into the overflow column before the C call, so routed rows are
    never materialized only to be replaced. ``lazy`` returns views over a
    pageable copy of the rows (never the pinned D2H buffer or a kernel's
    output tensor, which a view would otherwise keep alive)."""
    col = 2 * P + 1
    true_overflow, routed = _ranges_routes(packed, topics, P, len_overflow, pred, batch_pred)
    if lazy or len_overflow.any() or routed:
        packed = np.array(packed, dtype=np.int32)
        packed[:, col] |= len_overflow
        if routed:
            packed[np.asarray(routed, dtype=np.int64), col] = 1
    acc = _accel()
    resolve = acc.resolve_batch_views if lazy else acc.resolve_batch
    results, ovf_idx = resolve(
        np.ascontiguousarray(packed, dtype=np.int32), len(topics), P, flat.subs.snaps,
        flat.window, Subscribers, ns_modes(topics),
    )
    return _fill_host_rows(stats, host_walk, results, ovf_idx, topics, true_overflow)


@dataclass
class MatcherStats:
    """Observability counters for a device matcher.

    ``host_fallbacks`` counts topics re-walked on the host for any reason;
    ``overflows`` counts the subset caused by device-side routing (spilled
    entries, saturated buckets, over-deep topics) rather than delta-overlay
    routes.
    """

    batches: int = 0
    topics: int = 0
    host_fallbacks: int = 0
    overflows: int = 0
    rebuilds: int = 0
    rebuild_seconds: float = 0.0
    folds: int = 0  # incremental folds that avoided a full rebuild
    # topics served by the exact-map host fast path (wildcard-free filter
    # sets answer from one dict probe; no device round trip)
    host_fast: int = 0
    # device-resident hit compaction: batches whose results transferred as
    # a compacted sid stream, batches whose hit count overflowed the
    # compaction capacity (served by the packed path for that batch only),
    # and the actual D2H result bytes moved
    compact_batches: int = 0
    compact_overflows: int = 0
    d2h_bytes: int = 0
    # the port's own, outside as_dict (which keeps the JAX package's keys):
    # the folds that found the standby buffer held by a batch in flight
    # and wrote a fresh copy of the live table instead (TorchMatcher.fold)
    fold_copies: int = 0
    # serializes add(): batches resolve on several threads at once (the
    # stage's resolvers, the breaker's guard threads)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)
    # optional per-rebuild duration observer (the telemetry plane's
    # rebuild histogram); set by the server
    rebuild_observer: Optional[Callable[[float], None]] = field(default=None, repr=False, compare=False)

    def note_rebuild(self, dt: float) -> None:
        """Account one rebuild/fold wall time (and feed the observer)."""
        with self._lock:
            self.rebuild_seconds += dt
        cb = self.rebuild_observer
        if cb is not None:
            try:
                cb(dt)
            except Exception:  # pragma: no cover  # brokerlint: ok=R4 a telemetry observer must not wedge the rebuild path
                pass

    def add(self, **deltas) -> None:
        """Add each of ``deltas`` to its counter, as one update."""
        with self._lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict:
        out = {
            "batches": self.batches,
            "topics": self.topics,
            "host_fallbacks": self.host_fallbacks,
            "overflows": self.overflows,
            "rebuilds": self.rebuilds,
            "rebuild_seconds": round(self.rebuild_seconds, 3),
            "folds": self.folds,
            "host_fast": self.host_fast,
            "compact_batches": self.compact_batches,
            "compact_overflows": self.compact_overflows,
            "d2h_bytes": self.d2h_bytes,
        }
        out["fallback_ratio"] = (
            round(self.host_fallbacks / self.topics, 6) if self.topics else 0.0
        )
        return out


def _stamp_bytes(
    rec, d2h_bytes: int, bytes_ranges: int, bytes_dense: int,
    compact: bool, overflow: bool = False,
) -> None:
    """Stamp one batch's transfer accounting onto its BatchProfile
    (``tracing``): the bytes moved beside the pre-compaction geometries,
    and whether the result came back compacted."""
    rec.d2h_bytes = d2h_bytes
    rec.d2h_bytes_ranges = bytes_ranges
    rec.d2h_bytes_dense = bytes_dense
    rec.compact = compact
    rec.compact_overflow = overflow


def _to_host_async(out_dev: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start the D2H copy of a result into a fresh pinned buffer and
    record an event after it; a CPU result is already on the host. Each
    batch gets its own pinned buffer (PyTorch's caching host allocator
    does not hand a block out again while a copy recorded on it is still
    in flight), so pipelined batches never share one."""
    if out_dev.device.type == "cpu":
        return out_dev, None
    host = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
    host.copy_(out_dev, non_blocking=True)
    event = torch.cuda.Event()
    # the copy ran on the result's card's stream: the event names both, so
    # a thread whose current card is another one (a shard loop's) records
    # it in the right place
    event.record(torch.cuda.current_stream(out_dev.device))
    return host, event


class _TableBuffer:
    """One device buffer of the bucket table, and its pins: the batches
    that captured it and have not yet made their last launch on it. A fold
    writes a buffer only while it holds no pin."""

    __slots__ = ("table", "pins")

    def __init__(self, table: torch.Tensor) -> None:
        self.table = table
        self.pins = 0


class TorchMatcher:
    """Broker-facing device matcher over the flat-hash index.

    ``device`` is where the index lives and the kernels run: ``"cuda"`` by
    default (raises when there is no card), ``"cpu"`` for the plain
    PyTorch versions. ``window`` caps ids per filter path. ``lazy``
    (default True) returns ``SubscribersView`` results; False returns
    eager ``Subscribers``.
    """

    def __init__(
        self,
        topics: TopicsIndex,
        max_levels: int = 8,
        window: int = 16,
        cooperative: bool = False,
        compact: bool = True,
        compact_capacity: int = 0,
        hits_estimate: float = 2.0,
        device="cuda",
        lazy: bool = True,
    ) -> None:
        self.device = resolve_device(device)
        self.topics = topics
        self.max_levels = max_levels
        self.window = window
        # cooperative rebuilds yield the GIL periodically — set by owners
        # that rebuild on a background thread while another thread serves
        self.cooperative = cooperative
        # device-resident hit compaction: results come back as a
        # topic-major sid stream sized for the hits that exist.
        # compact_capacity pins the pair buffer (0 = adaptive from the
        # observed hits-per-topic EWMA, seeded by hits_estimate)
        self.compact = compact
        self.compact_capacity = max(0, compact_capacity)
        self._hits_ewma = max(1.0, float(hits_estimate))
        # sticky per-batch-bucket capacities (pick_compact_capacity)
        self._caps: dict[int, int] = {}
        # lazy SubscribersView results over the D2H'd stream (ranges rows
        # or pairs); any consumer that reads a map materializes it
        self.lazy = lazy
        self.stats = MatcherStats()
        # device pipeline profiler (tracing.DeviceProfiler) or None:
        # match_topics_async feeds it the issue leg, the resolver the D2H
        # wait — duty cycle / overlap / idle-gap accounting lives there
        self.profiler: Optional[Any] = None
        # one (flat_index, device_arrays, built_version) tuple, swapped
        # atomically by rebuild()/fold() so a concurrent match never mixes
        # arrays and salt from different generations
        self._state: Optional[tuple] = None
        # the bucket table's two buffers, [live, standby]: live is
        # _state's table, the standby one fold behind it, lacking the rows
        # of the last fold (_behind: its host idx and rows, None after a
        # rebuild). _tables_lock guards the pair, _behind, the pins, and
        # their swap with _state, so a batch pins the buffer of the state
        # it captures
        self._tables: Optional[list] = None
        self._behind: Optional[tuple] = None
        self._tables_lock = threading.Lock()
        # True while the np table may diverge from the device table (an
        # aborted fold); only a full rebuild clears it
        self._fold_poisoned = False

    # -- index lifecycle ---------------------------------------------------

    def rebuild(self) -> None:
        """Recompile the host trie and upload the index to the device."""
        t0 = time.perf_counter()
        version = self.topics.version
        flat = build_flat_index(
            self.topics,
            max_levels=self.max_levels,
            window=self.window,
            cooperative=self.cooperative,
        )
        device_arrays = device_index_from_numpy(
            flat.table, flat.pat_kind, flat.pat_depth, flat.pat_mask, self.device
        )
        # the standby starts equal to the live table: one device copy
        tables = [_TableBuffer(device_arrays[0]), _TableBuffer(device_arrays[0].clone())]
        with self._tables_lock:
            self._tables = tables
            self._behind = None
            self._state = (flat, device_arrays, version)
        self._fold_poisoned = False
        self.stats.rebuilds += 1
        self.stats.note_rebuild(time.perf_counter() - t0)

    def fold(self, filters) -> bool:
        """Incrementally fold mutations for ``filters`` into the compiled
        index: copy-on-write host edits plus a bucket-row scatter on the
        device (``scatter_rows``, ~KB uploaded) instead of a full rebuild
        and table upload. Returns False when a full rebuild is required
        (FlatIndex.fold documents the cases, and a walk torn by a
        concurrent mutation). A failed ``scatter_rows`` raises.

        The device update departs from the JAX package's, which is
        functional (a NEW table per fold, so batches in flight keep the
        old one; at 1M subscriptions that is a 64 MB copy each way for a
        few KB of rows). Here the table lives in two buffers, live and a
        standby one fold behind. A fold writes the previous fold's rows
        and its own into the standby IN PLACE, one ``scatter_rows``
        launch, and publishes it as live; the old live buffer becomes the
        standby. A batch pins the live buffer from the moment it captures
        the state until its last launch on it, so the standby being
        written holds no pin, unless a batch captured it two folds ago
        and has not launched yet (or, on the compact path, not resolved:
        its resolver may re-run the batch). Then this fold copies the live
        table into a fresh standby (one device copy, counted in
        ``stats.fold_copies``) and writes that. The port launches on one
        stream, so every kernel issued before the scatter has run before
        it. A resolver decodes against its own sub table snapshot, as
        before. The np bucket table is shared and edited in place
        (resolvers never read it); an aborted fold leaves it diverged from
        the device table, so folding poisons itself until the full rebuild
        that MUST follow a False return (which also uploads both buffers
        anew)."""
        st = self._state
        if st is None or self._fold_poisoned:
            return False
        flat, arrays, _ = st
        t0 = time.perf_counter()
        version = self.topics.version
        flat = flat.clone_for_fold()
        self._fold_poisoned = True  # cleared on success or by rebuild()
        try:
            res = flat.fold(self.topics, filters)
        except (RuntimeError, KeyError):
            # a structural mutation tore the walk of the live trie: the
            # full rebuild that follows a False return retries it
            return False
        if res is None:
            return False
        updates, pats_changed = res
        new_pats = (
            tuple(
                device_i32(a, self.device)
                for a in (flat.pat_kind, flat.pat_depth, flat.pat_mask)
            )
            if pats_changed
            else arrays[1:]
        )
        with self._tables_lock:
            table = self._write_standby(updates) if updates else self._tables[0].table
            self._state = (flat, (table, *new_pats), version)
        self._fold_poisoned = False
        self.stats.folds += 1
        self.stats.note_rebuild(time.perf_counter() - t0)
        return True

    def _write_standby(self, updates) -> torch.Tensor:
        """Write a fold's ``(slot, row)`` updates, with the rows the
        standby lacks from the previous fold, into the standby buffer (or,
        where a batch still pins it, into a fresh copy of the live one),
        and swap the pair; returns the new live table. Runs under
        ``_tables_lock``."""
        idx = np.fromiter((s for s, _ in updates), dtype=np.int32, count=len(updates))
        rows = np.stack([r for _, r in updates])
        live, standby = self._tables
        w_idx, w_rows = idx, rows
        if standby.pins:
            standby = _TableBuffer(live.table.clone())
            self.stats.fold_copies += 1
        elif self._behind is not None:
            # this fold's rows win over the previous fold's on a shared slot
            b_idx, b_rows = self._behind
            keep = ~np.isin(b_idx, idx)
            w_idx = np.concatenate([b_idx[keep], idx])
            w_rows = np.concatenate([b_rows[keep], rows])
        scatter_rows(standby.table, device_i32(w_idx, self.device), device_i32(w_rows, self.device))
        self._tables = [standby, live]
        self._behind = (idx, rows)
        return standby.table

    def _capture(self) -> tuple:
        """The state a batch is issued against and its live buffer,
        pinned: the caller drops the pin (``_unpin``) after its last
        launch on the table."""
        with self._tables_lock:
            st = self._state
            held = self._tables[0]
            held.pins += 1
        return st, held

    def _unpin(self, held: _TableBuffer) -> None:
        with self._tables_lock:
            held.pins -= 1

    @property
    def index(self) -> Optional[FlatIndex]:
        """The compiled index."""
        st = self._state
        return st[0] if st is not None else None

    @property
    def stale(self) -> bool:
        st = self._state
        return st is None or st[2] != self.topics.version

    @property
    def device_arrays(self) -> tuple:
        """The flat index as device tensors (built on demand). The table is
        the live buffer, which the second fold from now writes in place:
        clone it to keep it."""
        st = self._state
        if st is None or self.stale:
            self.rebuild()
            st = self._state
        assert st is not None  # rebuild() always swaps in a state
        return st[1]

    def match_tokens(self, tok1, tok2, lengths, is_dollar):
        """Raw device match over pre-tokenized topics (tensors on the
        matcher's device); returns ``(starts[B,P], cnts[B,P], totals[B],
        overflow[B])`` — the ranges kernel."""
        if self._state is None or self.stale:
            self.rebuild()
        (flat, arrays, _), held = self._capture()
        try:
            return flat_match_ranges(
                *arrays, tok1, tok2, lengths, is_dollar, max_levels=flat.max_levels
            )
        finally:
            self._unpin(held)

    # -- matching ----------------------------------------------------------

    def match_topics_async(self, topics: list[str], route_to_host=None, profile=None):
        """Issue one device match batch and return a zero-arg resolver.

        Issue: host tokenize, ONE packed H2D copy from a pinned buffer, ONE
        kernel dispatch, and the start of ONE D2H copy into pinned memory,
        all asynchronous, with an event recorded after the copy. The
        resolver waits on that event, then materializes ``list[Subscribers]``
        on the host. Keeping a second batch in flight while the first
        resolves hides the round trip — the staging loop relies on it.

        ``route_to_host`` forces extra topics onto the host walk. It is
        either a plain ``topic -> bool`` predicate or an object exposing
        ``affected(topic)`` plus ``affected_batch(topics) -> indices`` (the
        delta overlay, ops/delta._Gen).

        ``profile`` is an optional per-batch ``tracing.BatchProfile`` the
        caller (the stage) holds; with a profiler attached this method
        stamps its issue leg (from before tokenizing to after the launch
        and the D2H copy are queued) and the resolver its D2H window,
        which closes when the wait on the copy returns. With a profiler
        attached and no record passed, a private one is opened.

        The batch pins the live table buffer it captures until its launch
        (on the compact path until its resolver has passed the point where
        it may re-run the batch), so no fold writes that buffer under it.
        """
        if self._state is None or self.stale:
            self.rebuild()
        st, held = self._capture()
        flat, arrays, _ = st
        if flat.exact_map is not None:
            # wildcard-free filter set: one host dict probe per topic beats
            # any device round trip
            self._unpin(held)
            return self._match_exact_fast(topics, flat, route_to_host)
        prof = self.profiler
        rec = None
        hold = False
        try:
            if prof is not None:
                rec = profile if profile is not None else prof.open_batch()
                t_issue0 = time.perf_counter()
            # pad ragged batches to a power-of-two bucket; padded rows are
            # ignored at resolve time
            b = len(topics)
            padded = topics + [""] * (_bucket(max(1, b), minimum=16) - b)
            tok1, tok2, lengths, is_dollar, len_overflow = tokenize_topics(
                padded, flat.max_levels, flat.salt
            )
            host_tokens = torch.from_numpy(pack_tokens(tok1, tok2, lengths, is_dollar))
            if self.device.type == "cuda":
                pinned = torch.empty(host_tokens.shape, dtype=torch.int32, pin_memory=True)
                pinned.copy_(host_tokens)
                dev_tokens = pinned.to(self.device, non_blocking=True)
            else:
                dev_tokens = host_tokens
            P = flat.pat_depth.shape[0]
            use_compact = self.compact and P > 0 and self._compact_pays(P)
            capacity = 0
            if use_compact:
                capacity = self._compact_capacity_for(len(padded), flat)
                out_dev = flat_match_compact(
                    *arrays, dev_tokens, max_levels=flat.max_levels, capacity=capacity
                )
            else:
                out_dev = flat_match_packed(*arrays, dev_tokens, max_levels=flat.max_levels)
            out_host, event = _to_host_async(out_dev)
            # the compact resolver may re-run the batch on this table
            hold = use_compact
        finally:
            if not hold:
                self._unpin(held)
        if prof is not None:
            # the issue leg (tokenize + H2D + launch + D2H queued) ends
            # here and the device window opens; the batch ran on the
            # output's card (the host counts as device 0)
            rec.devices = (out_dev.device.index or 0,)
            prof.note_dispatch(rec, t_issue0, time.perf_counter())
        if route_to_host is None:
            pred = batch_pred = None
        elif hasattr(route_to_host, "affected_batch"):
            pred = route_to_host.affected
            batch_pred = route_to_host.affected_batch
        else:
            pred = route_to_host
            batch_pred = None
        # the pre-compaction transfer geometries, stamped per batch: ranges
        # = the packed [B, 2P+2] rows, dense = the padded slot buffer
        # [B, DENSE_SLOTS] the JAX matcher's slot path copies by default
        bytes_ranges = len(padded) * (2 * P + 2) * 4
        bytes_dense = len(padded) * DENSE_SLOTS * 4

        if not use_compact:

            def resolve() -> list[Subscribers]:
                t_sync0 = time.perf_counter() if prof is not None else 0.0
                if event is not None:
                    event.synchronize()
                packed = out_host.numpy()
                if prof is not None:
                    # the D2H wait just returned: close the device window
                    # (kernel + transfer) on this batch's record
                    _stamp_bytes(rec, packed.nbytes, bytes_ranges, bytes_dense, False)
                    prof.note_resolve(rec, t_sync0, time.perf_counter())
                self.stats.add(batches=1, topics=len(topics), d2h_bytes=int(packed.nbytes))
                # the ranges row carries per-topic totals: feed the same
                # hits EWMA the compact path uses, so the encoding pick
                # keeps adapting from EITHER path
                self._observe_hits(int(packed[: len(topics), 2 * P].sum()), len(topics))
                return resolve_ranges_native(
                    self.stats, self.topics.subscribers, packed[: len(topics)], topics, flat, P,
                    len_overflow[: len(topics)], pred, batch_pred, self.lazy,
                )

            return resolve

        pinned_until_resolve = [True]

        def resolve_compact() -> list[Subscribers]:
            try:
                t_sync0 = time.perf_counter() if prof is not None else 0.0
                if event is not None:
                    event.synchronize()
                out = out_host.numpy()
                n_hits = int(out[0])
                batch_ovf = bool(out[1])
                if batch_ovf:
                    # hits outgrew the pair buffer: THIS batch re-runs on
                    # the packed-ranges path against the arrays it was
                    # issued with (one extra dispatch + sync, still
                    # bit-identical)
                    packed = flat_match_packed(
                        *arrays, dev_tokens, max_levels=flat.max_levels
                    ).cpu().numpy()
            finally:
                if pinned_until_resolve[0]:
                    pinned_until_resolve[0] = False
                    self._unpin(held)
            bp = len(padded)
            stats = self.stats
            self._observe_hits(n_hits, b)
            if batch_ovf:
                # the EWMA above already absorbed the true hit count, so
                # the next capacity pick fits
                self._hits_ewma = max(self._hits_ewma, n_hits / max(1, b))
                d2h_bytes = int(out.nbytes + packed.nbytes)
                stats.add(batches=1, topics=len(topics), compact_overflows=1, d2h_bytes=d2h_bytes)
                if prof is not None:
                    _stamp_bytes(rec, d2h_bytes, bytes_ranges, bytes_dense, True, overflow=True)
                    prof.note_resolve(rec, t_sync0, time.perf_counter())
                return resolve_ranges_native(
                    self.stats, self.topics.subscribers, packed[: len(topics)], topics, flat, P,
                    len_overflow[: len(topics)], pred, batch_pred, self.lazy,
                )
            if prof is not None:
                _stamp_bytes(rec, int(out.nbytes), bytes_ranges, bytes_dense, True)
                prof.note_resolve(rec, t_sync0, time.perf_counter())
            stats.add(batches=1, topics=len(topics), compact_batches=1, d2h_bytes=int(out.nbytes))
            totals = out[2 : 2 + bp]
            true_overflow = out[2 + bp : 2 + 2 * bp].astype(bool) | len_overflow
            pair_sid = out[2 + 2 * bp : 2 + 2 * bp + capacity]
            if batch_pred is not None:
                routed = batch_pred(topics)
            elif pred is not None:
                routed = [i for i, t in enumerate(topics) if t and pred(t)]
            else:
                routed = ()
            host_route = true_overflow.copy()
            if len(routed):
                host_route[np.asarray(routed, dtype=np.int64)] = True
            return materialize_compact_pairs(
                self.stats, self.topics.subscribers, pair_sid, totals, host_route,
                n_hits, topics, flat.subs, true_overflow, lazy=self.lazy,
            )

        return resolve_compact

    def _compact_pays(self, P: int) -> bool:
        """The transfer-optimal encoding pick. The padded-ranges row
        costs ``2P+2`` ints/topic regardless of hits; the compacted
        stream costs ~``hits x 1.5`` (headroom) + 2 ints/topic. Dense
        workloads (hits/topic high against the probe count) are already
        optimally encoded by the contiguous synthetic-sid ranges; sparse
        workloads win with the compacted stream. Both paths stay
        bit-identical and both feed the same hits EWMA, so the pick adapts
        with the workload. A pinned ``compact_capacity`` forces the compact
        path."""
        if self.compact_capacity > 0:
            return True
        return self._hits_ewma * 1.5 + 2.0 < 2.0 * P + 2.0

    def _compact_capacity_for(self, b_padded: int, flat) -> int:
        """The pair-buffer capacity for one batch, capped at the
        theoretical hit bound (P probes x window ids per topic)."""
        max_hits = b_padded * int(flat.pat_depth.shape[0]) * flat.window
        return pick_compact_capacity(
            self.compact_capacity, self._hits_ewma, b_padded, max_hits, self._caps
        )

    def _observe_hits(self, n_hits: int, b: int) -> None:
        """Feed one batch's true hit count into the capacity EWMA."""
        self._hits_ewma = fold_hits_ewma(self._hits_ewma, n_hits, b)

    def _match_exact_fast(self, topics: list[str], flat, route_to_host):
        """Serve a batch from the exact-map (wildcard-free filter sets):
        every topic is one dict probe + one snapshot expansion, covering
        spilled and over-deep entries too — no fallback classes, no device
        dispatch. The work happens when the RESOLVER runs, not at issue
        time (the staging loop resolves off the event loop). The namespace
        guard needs no check here: it only drops filters with a ``+`` or
        ``#`` level, and a wildcard-free set holds none."""

        def resolve() -> list[Subscribers]:
            stats = self.stats
            if route_to_host is None:
                routed = ()
            elif hasattr(route_to_host, "affected_batch"):
                routed = frozenset(route_to_host.affected_batch(topics))
            else:
                routed = frozenset(
                    i for i, t in enumerate(topics) if t and route_to_host(t)
                )
            get = flat.exact_map.get
            subscribers = self.topics.subscribers
            expand_c = _accel().expand_snap
            modes = ns_modes(topics)
            results = []
            results_append = results.append
            n_fast = 0
            n_host = 0
            for i, topic in enumerate(topics):
                if not topic:
                    results_append(Subscribers())
                elif i in routed:
                    n_host += 1
                    results_append(subscribers(topic))
                else:
                    n_fast += 1
                    snap = get(topic)
                    results_append(
                        Subscribers() if snap is None
                        else expand_c(snap, Subscribers, 0 if modes is None else int(modes[i]))
                    )
            stats.add(batches=1, topics=len(topics), host_fallbacks=n_host, host_fast=n_fast)
            return results

        return resolve

    def match_topics(self, topics: list[str], route_to_host=None) -> list[Subscribers]:
        """Match a batch of topics; every result is bit-identical to the
        host trie (overflowing and routed topics are re-walked on host)."""
        return self.match_topics_async(topics, route_to_host)()

    def subscribers(self, topic: str) -> Subscribers:
        """Drop-in for ``TopicsIndex.subscribers`` (batch of one)."""
        return self.match_topics([topic])[0]
