"""Interest-scoped spanning-tree mesh topology.

A copy of the JAX package's ``mqtt_tpu/mesh_topology.py``.

The all-pairs federation (``cluster_topology: mesh``): every worker dials every peer and
forwards each publish to every interested link — O(N²) links and gossip,
and one flapping peer destabilizes the whole mesh. This module holds the
PURE state the tree-mode cluster (mqtt_tpu_torch.cluster) routes over, in the
shape the MQTT-ST spanning-tree broker protocol (PAPERS.md, arxiv
1911.07622) and TD-MQTT's transparent subscription summaries (arxiv
2406.02731) describe:

- :func:`compute_parents` — a DETERMINISTIC loop-free tree over any
  membership view: sort the live worker ids, root at the lowest
  (deterministic root election), and lay the rest out as a balanced
  d-ary heap. Every worker that holds the same member list computes the
  IDENTICAL tree, so an epoch announcement only needs to carry the
  member list, never the edges — and acyclicity/spanning hold by
  construction (heap indexing cannot express a cycle).
- :class:`TreeEpoch` — the tree's version stamp: a monotonic counter
  tie-broken by the proposer's per-incarnation boot nonce and worker id
  (a strict total order, so two concurrent re-elections converge on one
  winner), carried on every routed frame so a receiver can refuse to
  re-forward under a tree it no longer runs. The boot nonce is the all-pairs
  split-brain guard generalized to topology: a restarted incarnation's
  counter restarts, and without the nonce its stale announcements could
  resurrect a dead tree.
- :class:`Topology` — one worker's live view: the member map
  (worker -> boot nonce), the current epoch + parent map, and the
  adopt/propose protocol (strictly-greater epochs win; proposals bump
  the counter past everything seen). Thread-safe: the forward path reads
  neighbors while the cluster loop adopts.
- :class:`CountedBloom` / :class:`BloomBits` — the per-edge interest
  summary. Local interest is a COUNTED bloom (UNSUBSCRIBE decrements, so
  deletes are real, not rebuild-the-world); the wire form is the plain
  bitset peers probe. Keys are filter PREFIXES truncated at the first
  wildcard (:func:`summary_key`), probed with every prefix of the
  published topic (:func:`topic_keys`) — sound by construction: any
  filter matching topic T has its pre-wildcard prefix equal to a prefix
  of T, so false negatives are impossible and false positives only cost
  a conservative forward.
- :class:`DuplicateSuppressor` — the (origin, boot, seq) window that
  makes re-parenting safe: a park replayed under a new epoch while the
  old tree had partially propagated can reach a worker twice, and the
  window turns the second arrival into a counted no-op instead of a
  duplicate delivery or a loop.

Nothing here touches sockets or the event loop; mqtt_tpu_torch.cluster owns
the wire protocol and tests/test_torch_mesh_topology.py holds it against the JAX package's
suite (randomized views -> acyclic + spanning, bloom soundness, window
exactness).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .utils.locked import InstrumentedLock

#: default branching factor: per-worker link count stays <= degree + 1
#: (children + parent), the O(degree) bound the 32-worker drill asserts
DEFAULT_DEGREE = 4


# -- deterministic tree election ---------------------------------------------


def compute_parents(
    members: Iterable[int], degree: int = DEFAULT_DEGREE
) -> Dict[int, Optional[int]]:
    """The spanning tree over ``members`` as a parent map (root -> None).

    Root election is deterministic — the lowest live id — and the rest of
    the sorted members fill a balanced ``degree``-ary heap, so the tree
    is a pure function of (member set, degree): every worker computing it
    from the same view agrees edge-for-edge without exchanging edges.
    Heap indexing (parent of slot i is slot (i-1)//degree) cannot express
    a cycle and reaches every slot, so the result is acyclic and spanning
    by construction.
    """
    if degree < 1:
        raise ValueError("tree degree must be >= 1")
    order = sorted(set(members))
    parents: Dict[int, Optional[int]] = {}
    for i, w in enumerate(order):
        parents[w] = None if i == 0 else order[(i - 1) // degree]
    return parents


def compute_successor(members: Iterable[int]) -> Optional[int]:
    """The pre-agreed root successor for ``members``: the second-lowest
    live id (the lowest IS the root), or None when the view is too small
    to need one. Deterministic from the same sorted view as
    :func:`compute_parents`, so every worker that holds the member list
    already agrees on the successor without any extra exchange — the
    epoch announcement carries it only so operators (and older peers)
    can see the agreement, never to establish it. The successor is
    always the root's direct child (heap slot 1 parents on slot 0), so
    its own ping loop detects the root's death first-hand and can
    promote without waiting out a full scoped re-election."""
    order = sorted(set(members))
    return order[1] if len(order) >= 2 else None


def tree_children(parents: Dict[int, Optional[int]], worker: int) -> Tuple[int, ...]:
    return tuple(sorted(w for w, p in parents.items() if p == worker and w != worker))


def tree_neighbors(parents: Dict[int, Optional[int]], worker: int) -> Tuple[int, ...]:
    """The worker's tree edges: its parent (when not root) plus children."""
    out = list(tree_children(parents, worker))
    p = parents.get(worker)
    if p is not None:
        out.append(p)
    return tuple(sorted(out))


def is_spanning_tree(parents: Dict[int, Optional[int]], members: Iterable[int]) -> bool:
    """Validation helper (property tests + the race sweep): exactly the
    member set, exactly one root, every node reaches the root without
    revisiting anything — i.e. acyclic AND spanning."""
    mset = set(members)
    if set(parents) != mset or not mset:
        return False
    roots = [w for w, p in parents.items() if p is None]
    if len(roots) != 1:
        return False
    for w in parents:
        seen = set()
        node: Optional[int] = w
        while node is not None:
            if node in seen or node not in mset:
                return False
            seen.add(node)
            node = parents[node]
        if roots[0] not in seen:
            return False
    return True


@dataclass(frozen=True, order=True)
class TreeEpoch:
    """The tree's version stamp, a strict total order: the monotonic
    counter decides, the proposer's boot nonce and worker id tie-break
    concurrent proposals (two workers re-electing in the same instant
    converge on one winner deterministically). Routed frames carry
    ``num`` so a receiver can refuse to re-forward under a tree it no
    longer runs; announcements carry the full triple."""

    num: int = 0
    boot: int = 0
    proposer: int = 0


class Topology:
    """One worker's live tree state: membership view, current epoch, and
    the deterministic tree over them.

    Thread-safe: the forward path (which may run on embedder threads via
    inline publishes) reads ``neighbors()``/``epoch_num()`` while the
    cluster loop adopts announcements and proposes re-elections. All
    mutation is adopt/propose — the tree itself is always recomputed from
    the view, never edited edge-by-edge.
    """

    def __init__(
        self,
        worker_id: int,
        members: Iterable[int],
        degree: int = DEFAULT_DEGREE,
        boot_id: int = 0,
    ) -> None:
        self.worker_id = worker_id
        self.degree = max(1, int(degree))
        self.boot_id = boot_id
        self._lock = InstrumentedLock("mesh_topology")
        # worker -> boot nonce (0 = not yet learned); every worker boots
        # with the same static view, so epoch 0's tree needs no exchange
        self._view: Dict[int, int] = {int(w): 0 for w in members}
        self._view.setdefault(worker_id, 0)
        self._view[worker_id] = boot_id
        self._epoch = TreeEpoch(0, 0, min(self._view))
        self._parents = compute_parents(self._view, self.degree)
        self._neighbors = tree_neighbors(self._parents, worker_id)
        self.re_elections = 0  # local proposals (not adoptions)
        self.adoptions = 0  # strictly-greater announcements applied

    # -- reads (any thread) ------------------------------------------------

    @property
    def epoch(self) -> TreeEpoch:
        with self._lock:
            return self._epoch

    def epoch_num(self) -> int:
        with self._lock:
            return self._epoch.num

    def neighbors(self) -> Tuple[int, ...]:
        with self._lock:
            return self._neighbors

    def is_neighbor(self, worker: int) -> bool:
        with self._lock:
            return worker in self._neighbors

    def in_view(self, worker: int) -> bool:
        with self._lock:
            return worker in self._view

    def members(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._view)

    def parents(self) -> Dict[int, Optional[int]]:
        with self._lock:
            return dict(self._parents)

    def parent_of(self, worker: int) -> Optional[int]:
        """The worker's tree parent under the CURRENT epoch (None for
        the root, or for a worker outside the adopted view) — the uphill
        edge metric federation rides (cluster._metrics_gossip_now)."""
        with self._lock:
            return self._parents.get(worker)

    def is_root(self) -> bool:
        """Whether THIS worker is the current tree's aggregation root
        (the scrape target for GET /metrics/cluster in tree mode)."""
        return self.root() == self.worker_id

    def root(self) -> int:
        with self._lock:
            return min(self._view)

    def successor(self) -> Optional[int]:
        """The pre-agreed root successor under the CURRENT view (see
        :func:`compute_successor`) — the worker that promotes on the
        root-failure fast path instead of waiting out a full scoped
        re-election."""
        with self._lock:
            return compute_successor(self._view)

    # -- protocol (cluster loop) -------------------------------------------

    def _recompute_locked(self) -> None:
        if self.worker_id not in self._view:
            # an announcement excluding US: stay routable on a self-only
            # tree; the cluster layer re-joins by proposing ourselves back
            self._view[self.worker_id] = self.boot_id
        self._parents = compute_parents(self._view, self.degree)
        self._neighbors = tree_neighbors(self._parents, self.worker_id)

    def adopt(self, epoch: TreeEpoch, members: Dict[int, int]) -> bool:
        """Apply a peer's announcement when it is STRICTLY greater than
        the current epoch (the total order makes concurrent proposals
        converge); returns whether it was applied."""
        if not members:
            return False
        with self._lock:
            if epoch <= self._epoch:
                return False
            self._epoch = epoch
            view = {int(w): int(b) for w, b in members.items()}
            # never unlearn a boot nonce we already hold (announcements
            # from workers that haven't met a peer yet carry boot 0)
            for w, b in self._view.items():
                if w in view and view[w] == 0 and b != 0:
                    view[w] = b
            self._view = view
            self._recompute_locked()
            self.adoptions += 1
            return True

    def _propose_locked(self) -> TreeEpoch:
        self._epoch = TreeEpoch(
            self._epoch.num + 1, self.boot_id, self.worker_id
        )
        self._recompute_locked()
        self.re_elections += 1
        return self._epoch

    def propose_remove(self, worker: int) -> Optional[TreeEpoch]:
        """A scoped re-election with ``worker`` excluded (its edge is
        dead past the heal window): bump the epoch, recompute, and return
        the new epoch for flooding — or None when the view is unchanged
        (already excluded: a raced double-detection must not churn)."""
        if worker == self.worker_id:
            return None
        with self._lock:
            if worker not in self._view:
                return None
            del self._view[worker]
            return self._propose_locked()

    def propose_add(self, worker: int, boot: int = 0) -> Optional[TreeEpoch]:
        """Re-admit ``worker`` (a joining/rejoining/restarted peer made
        contact): bump the epoch when the view actually changes — a new
        member, or a known member whose boot nonce MOVED (a restarted
        incarnation: the epoch must advance so its old tree can never be
        resurrected). First-time boot learning is not a topology change
        and never churns the epoch."""
        with self._lock:
            known = self._view.get(worker)
            if known is None or (boot and known and known != boot):
                self._view[worker] = boot
                return self._propose_locked()
            if boot and not known:
                self._view[worker] = boot  # learned; tree unchanged
            return None

    def propose_self(self) -> TreeEpoch:
        """Force a re-join proposal: an announcement excluding THIS
        worker was adopted (the mesh thought we were dead), so the only
        way back in is an epoch strictly above it with ourselves in the
        view."""
        with self._lock:
            self._view[self.worker_id] = self.boot_id
            return self._propose_locked()

    def learn_boot(self, worker: int, boot: int) -> None:
        """Record a peer's boot nonce without re-electing (first contact
        with an incarnation we already count as a member)."""
        if not boot:
            return
        with self._lock:
            if worker in self._view and self._view[worker] == 0:
                self._view[worker] = boot


# -- interest summaries (counted bloom over filter prefixes) ------------------


def summary_key(filter: str) -> Optional[str]:
    """The bloom key for one subscription filter: its literal topic-level
    prefix truncated at the first wildcard level. ``None`` means the
    filter can match any topic (it starts with a wildcard) and must set
    the summary's match-all flag instead of a bloom entry.

    Soundness: a filter F matching topic T agrees with T on every level
    before F's first wildcard, so ``summary_key(F)`` is one of
    ``topic_keys(T)`` — membership probes can false-positive (cost: one
    conservative forward) but never false-negative (cost: a lost
    delivery, which is why exactness lives on this side).
    """
    levels = filter.split("/")
    prefix: List[str] = []
    for level in levels:
        if level in ("+", "#") :
            break
        prefix.append(level)
    if not prefix:
        return None
    return "/".join(prefix)


def topic_keys(topic: str) -> List[str]:
    """Every level-prefix of a published topic (the probe set for
    :func:`summary_key` entries)."""
    levels = topic.split("/")
    return ["/".join(levels[: i + 1]) for i in range(len(levels))]


def _bloom_hashes(key: str, n_bits: int, k: int) -> List[int]:
    """k bit positions via double hashing over two salted CRCs —
    deterministic across processes (the wire form must probe the same
    slots the origin set)."""
    data = key.encode("utf-8", "surrogatepass")
    h1 = zlib.crc32(data)
    h2 = zlib.crc32(data, 0x9E3779B9) | 1  # odd: cycles all slots
    return [(h1 + i * h2) % n_bits for i in range(k)]


class CountedBloom:
    """The LOCAL interest summary: per-slot counters so an UNSUBSCRIBE
    really deletes (a plain bloom only ever fills). ``bits()`` exports
    the membership bitset peers probe. Counters saturate at 0xFFFF
    rather than wrap (a saturated slot stays conservative forever — a
    documented trade for 2 bytes/slot)."""

    def __init__(self, n_bits: int = 4096, k: int = 4) -> None:
        if n_bits % 8:
            raise ValueError("bloom size must be a whole number of bytes")
        self.n_bits = n_bits
        self.k = k
        self._counts = bytearray(2 * n_bits)  # u16 little-endian per slot
        self.match_all = 0  # wildcard-rooted filters (no usable prefix)
        self.generation = 0  # bumped on every mutation (refresh trigger)
        self._lock = InstrumentedLock("interest_bloom")

    def _bump(self, slot: int, delta: int) -> None:
        off = 2 * slot
        v = self._counts[off] | (self._counts[off + 1] << 8)
        if delta > 0:
            v = min(0xFFFF, v + delta)
        elif v != 0xFFFF:  # saturated slots never decrement (conservative)
            v = max(0, v + delta)
        self._counts[off] = v & 0xFF
        self._counts[off + 1] = (v >> 8) & 0xFF

    def add(self, filter: str) -> None:
        key = summary_key(filter)
        with self._lock:
            if key is None:
                self.match_all += 1
            else:
                for slot in _bloom_hashes(key, self.n_bits, self.k):
                    self._bump(slot, 1)
            self.generation += 1

    def discard(self, filter: str) -> None:
        key = summary_key(filter)
        with self._lock:
            if key is None:
                self.match_all = max(0, self.match_all - 1)
            else:
                for slot in _bloom_hashes(key, self.n_bits, self.k):
                    self._bump(slot, -1)
            self.generation += 1

    def bits(self) -> "BloomBits":
        with self._lock:
            out = bytearray(self.n_bits // 8)
            for slot in range(self.n_bits):
                off = 2 * slot
                if self._counts[off] or self._counts[off + 1]:
                    out[slot >> 3] |= 1 << (slot & 7)
            return BloomBits(bytes(out), self.match_all > 0, self.k)


class BloomBits:
    """An immutable membership bitset — the wire form of a summary and
    the per-edge aggregate (local ∪ every OTHER edge's received bits:
    the TD-MQTT transparent-summary shape)."""

    __slots__ = ("data", "match_all", "k", "n_bits")

    def __init__(self, data: bytes, match_all: bool, k: int = 4) -> None:
        self.data = data
        self.match_all = bool(match_all)
        self.k = k
        self.n_bits = 8 * len(data)

    @classmethod
    def empty(cls, n_bits: int = 4096, k: int = 4) -> "BloomBits":
        return cls(bytes(n_bits // 8), False, k)

    def union(self, other: "BloomBits") -> "BloomBits":
        if other.n_bits != self.n_bits:
            # mixed-size summaries cannot be merged soundly: degrade to
            # match-all (conservative pass-through, never a lost route)
            return BloomBits(self.data, True, self.k)
        return BloomBits(
            bytes(a | b for a, b in zip(self.data, other.data)),
            self.match_all or other.match_all,
            self.k,
        )

    def _contains(self, key: str) -> bool:
        for slot in _bloom_hashes(key, self.n_bits, self.k):
            if not (self.data[slot >> 3] >> (slot & 7)) & 1:
                return False
        return True

    def might_match(self, topic: str) -> bool:
        """Could ANY summarized filter match this topic? False positives
        allowed (conservative forward), false negatives impossible."""
        if self.match_all:
            return True
        return any(self._contains(key) for key in topic_keys(topic))

    def fill_ratio(self) -> float:
        ones = sum(bin(b).count("1") for b in self.data)
        return ones / max(1, self.n_bits)


# -- duplicate suppression ----------------------------------------------------


# DuplicateSuppressor.route verdicts: process fully / forward but do not
# re-deliver / suppress entirely
ROUTE_NEW = 0
ROUTE_REFORWARD = 1
ROUTE_DUP = 2


class DuplicateSuppressor:
    """Per-(origin worker, boot nonce) seq windows: ``route`` records a
    routed frame and answers whether it already passed through this
    worker. Re-parenting mid-flight is exactly the race this absorbs — an
    epoch change replays parked frames through new edges while the old
    tree may have partially propagated the originals.

    Each seq remembers the EPOCH identity it last traveled under: a
    repeat stamped with a strictly newer epoch is a parked copy re-routed
    by a re-election whose new path crosses a worker the original
    already visited — it must be RE-FORWARDED (the subtree it now heads
    for never got it) but never re-DELIVERED (``ROUTE_REFORWARD``).
    Within one epoch identity each worker forwards a seq at most once,
    so forwarding stays loop-free; across epochs the re-forward count is
    bounded by the number of elections.

    A seq more than ``window`` behind the highest seen is treated as
    already-seen (suppression errs toward no-duplicate; tree edges are
    FIFO TCP streams, so a legitimately-late frame lags only by park
    depth, far under the default window). A new boot nonce opens a fresh
    window — a restarted origin's seq restart can never be mistaken for
    replay."""

    def __init__(self, window: int = 8192, max_origins: int = 4096) -> None:
        self.window = max(1, window)
        self.max_origins = max_origins
        # (origin, boot) -> [highest seq, {seq: last epoch key or None}]
        self._origins: Dict[Tuple[int, int], List] = {}
        self._lock = InstrumentedLock("dup_suppressor")

    def seen(self, origin: int, boot: int, seq: int) -> bool:
        """Record (origin, boot, seq); True when it was already seen
        (the epoch-blind view: any repeat is a duplicate)."""
        return self.route(origin, boot, seq, None) == ROUTE_DUP

    def route(
        self,
        origin: int,
        boot: int,
        seq: int,
        epoch: Optional[Tuple[int, int, int]],
    ) -> int:
        """Record one routed frame; the verdict decides delivery AND
        forwarding. ``epoch`` is the frame's stamped (num, boot,
        proposer) identity — None (header missing it) compares older
        than any real epoch, so a repeat is a plain duplicate."""
        key = (origin, boot)
        with self._lock:
            rec = self._origins.get(key)
            if rec is None:
                if len(self._origins) >= self.max_origins:
                    self._origins.clear()  # bounded memory beats perfection
                self._origins[key] = [seq, {seq: epoch}]
                return ROUTE_NEW
            hi, recent = rec
            if seq > hi:
                rec[0] = seq
                recent[seq] = epoch
                floor = seq - self.window
                if len(recent) > self.window:
                    rec[1] = {
                        s: e for s, e in recent.items() if s > floor
                    }
                return ROUTE_NEW
            if seq <= hi - self.window:
                return ROUTE_DUP  # out the back of the window: call it seen
            if seq in recent:
                prev = recent[seq]
                if epoch is not None and (prev is None or epoch > prev):
                    recent[seq] = epoch
                    return ROUTE_REFORWARD
                return ROUTE_DUP
            recent[seq] = epoch
            return ROUTE_NEW

    def origins(self) -> int:
        with self._lock:
            return len(self._origins)


# -- wire helpers -------------------------------------------------------------


def encode_members(view: Dict[int, int]) -> Dict[str, int]:
    """JSON-safe member map (json objects key on strings)."""
    return {str(w): b for w, b in view.items()}


def decode_members(obj: Dict) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for w, b in obj.items():
        out[int(w)] = int(b)
    return out
