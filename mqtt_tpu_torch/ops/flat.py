"""The flat-hash device matcher index: wildcard matching as a multi-probe
hash join instead of a trie walk.

The host half (the build, the fold, the lazy sid table) is a copy of the
JAX package's ``ops/flat.py``: both packages must build bit-identical
tables from the same trie. The device half holds the PyTorch entry points
with the JAX output layouts — ``flat_match_packed``, ``flat_match_ranges``,
``flat_match_compact``, ``scatter_rows`` and ``flat_match_core`` — each with
its plain PyTorch version beside it. A wrapper runs the plain version only
for tensors that lie on the CPU; for CUDA tensors it launches the
hand-written kernel of ``csrc/flat_match.cu`` or ``csrc/sharded.cu``
(``ops/kernels.py``) or raises.

Encoding (reference semantics: topics.go:583-628):

- Every terminal trie path becomes one entry keyed by a 2x u32 whole-path
  hash; `+` levels hash as a sentinel constant, `#` filters are keyed by
  (levels-before-#, kind=HASH).
- The build enumerates the distinct (kind, depth, plus-mask) shapes; a
  topic of n levels probes each EXACT shape with depth == n and each HASH
  shape with depth <= n, substituting the sentinel at the shape's `+`
  positions. Probes are independent.
- The wildcard-walk corner cases are properties of entries, not control
  flow: `filter/#` matches `filter` itself only when the filter's LAST
  level is literal (topics.go:612) — a per-entry `last_plus` flag; that
  match excludes inline subscriptions (topics.go:615) — reg ids ordered
  before inl ids; `$`-topics never match client subscriptions whose
  filter starts with a top-level wildcard [MQTT-4.7.1-1/2] but
  shared/inline subscriptions are exempt (topics.go:637) — a per-entry
  top_wild flag plus the client prefix of the id window.
- Anything the device cannot prove is routed to the bit-identical host
  trie: probes of saturated buckets, entries whose id list exceeds the
  window, and topics deeper than the compiled level cap.

Table layout: `table[S, 16]` u32 = 4 entries/bucket x [key1, key2, meta,
base]. Sub ids are SYNTHETIC — entry ordinal x window + slot — so the
kernel computes them from the bucket row alone: matching costs exactly ONE
64-byte row gather per probe shape, and the host maps ids back to
subscriptions lazily (sid // window -> entry snapshot). On the card the
table and the pattern arrays are int32 tensors holding the u32 bit
patterns.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..topics import SHARE_PREFIX, TopicsIndex, ns_guard_class, shared_inner
from . import kernels
from .hashing import hash_token, tokenize_topics

KIND_CLIENT = 0  # a normal client subscription
KIND_SHARED = 1  # a $SHARE group member
KIND_INLINE = 2  # an in-process inline subscription

# path-hash domain constants (u32 wraparound arithmetic throughout)
_M1 = 0x9E3779B1
_M2 = 0x85EBCA77
PLUS1 = 0x9E3779B9  # sentinel level-hash for '+' (lane 1)
PLUS2 = 0xC2B2AE3D  # sentinel level-hash for '+' (lane 2)
KIND_EXACT = 0x165667B1
KIND_HASH = 0x27D4EB2F

# meta word bit layout (one per entry). Counts are window-bounded, so six
# bits each: ncli (the $-exempt boundary: slots >= ncli are shared/inline),
# nreg (clients+shared — the id count when a '#' entry matches its exact
# depth, which excludes inline), ninl (inline tail).
_CNT_BITS = 6
_NCLI_SHIFT = 0
_NREG_SHIFT = 6
_NINL_SHIFT = 12
_TOPWILD_SHIFT = 18
_LASTPLUS_SHIFT = 19
_SPILL_SHIFT = 20
_SAT_SHIFT = 21  # entry-0 meta only: whole bucket saturated at build
MAX_WINDOW = (1 << _CNT_BITS) - 1

ENTRY_INTS = 4
BUCKET_ENTRIES = 4
ROW_INTS = ENTRY_INTS * BUCKET_ENTRIES


def _bucket(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two >= n (at least ``minimum``) — the shape bucket
    that keeps tensor shapes (and the pinned-buffer sizes) stable across
    index rebuilds."""
    size = minimum
    while size < n:
        size *= 2
    return size


def _pad_to(a: np.ndarray, size: int, fill) -> np.ndarray:
    if len(a) >= size:
        return a
    return np.concatenate([a, np.full(size - len(a), fill, dtype=a.dtype)])


@dataclass
class SubEntry:
    """Host-side metadata for one device sub id."""

    kind: int
    client: str  # client id (CLIENT/SHARED) or "" (INLINE)
    group_filter: str  # full $SHARE filter (SHARED only)
    subscription: Any  # packets.Subscription or topics.InlineSubscription
    # the namespace guard class of the filter (for SHARED, of the inner
    # filter): the scoped topics whose match drops this entry
    # (topics.ns_guard_class; the materializer applies it, the kernels
    # cannot see it)
    guard: int = 0


@dataclass
class FlatIndex:
    """The device-side flat-hash encoding of the subscription set."""

    table: np.ndarray  # u32[S, 16] — 4 x [k1, k2, meta, base] per bucket
    pat_kind: np.ndarray  # u32[P] — KIND_EXACT / KIND_HASH
    pat_depth: np.ndarray  # i32[P]
    pat_mask: np.ndarray  # u32[P] — '+' level bitmask
    subs: Any = field(default_factory=list)  # _LazySubTable (sid -> SubEntry)
    salt: int = 0
    window: int = 16
    max_levels: int = 8
    n_entries: int = 0
    n_subs: int = 0  # actual subscriptions indexed (sid space is larger)
    n_sat: int = 0  # build-saturated buckets (probes host-route)
    n_spill: int = 0  # entries with more ids than the window (host-route)
    n_orphans: int = 0  # sid windows abandoned by in-place folds
    # Wildcard-free fast path (host fast path for exact-match-only
    # tries): when the filter set has NO '+'/'#' anywhere, matching
    # degenerates to one dict probe — path string -> snapshot tuple — and
    # the device round trip is pure loss. ``exact_map`` covers ALL terminal
    # paths, including over-deep and spilled entries the device table
    # cannot serve, so the fast path has no fallback classes at all. None
    # when the filter set has wildcards (or after a fold introduces one).
    exact_map: Any = None

    @property
    def wildcard_free(self) -> bool:
        """True when the exact-map fast path can serve every topic."""
        return self.exact_map is not None

    @property
    def num_nodes(self) -> int:
        """Entry count (the JAX package's name, kept from its CSR index)."""
        return self.n_entries

    @property
    def num_subs(self) -> int:
        return self.n_subs

    @property
    def num_patterns(self) -> int:
        return int(self.pat_depth.shape[0])

    # -- incremental fold --------------------------------------------------

    def clone_for_fold(self) -> "FlatIndex":
        """The copy-on-write clone a fold mutates: scalar fields and np
        arrays shared, sub table cloned (see ``fold`` for the safety
        contract)."""
        return dataclasses.replace(self, subs=self.subs.clone_for_fold())

    def fold(self, index: TopicsIndex, filters) -> "Optional[tuple[list, bool]]":
        """Apply subscription mutations for ``filters`` to this instance
        and return ``(bucket_updates, pats_changed)`` — the device-side
        scatter payload — or ``None`` when only a full rebuild can absorb
        them.

        MUST be called on a copy-on-write clone (``clone_for_fold``), never
        on the instance in-flight resolvers captured: a resolver issued
        generations ago may decode sids for a filter mutated only later —
        its generation's overlay does not host-route that filter, so it
        must keep seeing the snapshot from its own issue time. The np
        ``table``/pat arrays ARE shared with the live instance and
        mutated in place — safe because resolvers never read them (the
        device table changes only in the matcher's standby buffer,
        ``TorchMatcher.fold``) — which is also why an aborted
        fold poisons folding until a full rebuild rebuilds them fresh
        (TorchMatcher.fold).

        This is the churn path: a full rebuild of a large index costs
        seconds of host build plus a full-table H2D upload, while a fold
        touches one bucket row per distinct filter path (~KB).

        Full-rebuild (``None``) cases: a new wildcard SHAPE with no free
        pad slot in the pattern arrays, a token hashing to the ``+``
        sentinel pair under the current salt, a torn trie read that
        persists across retries, or degradation beyond the compaction
        thresholds (orphaned sid windows, fold-saturated buckets).
        Residual risk: a new filter whose 64-bit path key collides with a
        different live filter folds into the wrong entry (p ~ 2^-64 x n;
        the same order as the kernel's own topic-key match); the periodic
        full rebuild re-checks uniqueness and re-salts.
        """
        S = self.table.shape[0]
        tbl = self.table.reshape(S, BUCKET_ENTRIES, ENTRY_INTS)
        # compaction threshold: stop folding once orphaned sid windows
        # exceed a quarter of the sid space — with an absolute floor so
        # small indexes (where a full rebuild is cheap anyway, but also
        # where every unsubscribe is a large fraction) never thrash
        if self.n_orphans * self.window > max(4096, len(self.subs) // 4):
            return None
        # a fold appends at most one fresh window per filter: re-check the
        # sid-space int32 bound build_flat_index enforces (conservative
        # upper estimate; a None forces the rebuild that re-packs sids)
        if len(self.subs) + len(filters) * self.window >= 1 << 30:
            return None

        seen_paths = set()
        touched: set = set()
        pats_changed = False
        empty_snap = ((), (), ())
        cnt_mask = (1 << _CNT_BITS) - 1
        # exact-map maintenance is STAGED and applied only when the whole
        # fold succeeds: the dict is shared with the live instance
        # (clone_for_fold does not copy it — a 1M-entry dict copy would
        # defeat the fold's purpose), so an aborted fold must leave it
        # byte-identical to the snapshot the live instance serves
        map_updates: list = []
        map_disable = False

        for f in filters:
            parts = f.split("/")
            share_rooted = bool(parts) and parts[0].upper() == SHARE_PREFIX
            if share_rooted:
                parts = parts[2:]
            key = tuple(parts)
            if key in seen_paths:
                continue
            seen_paths.add(key)
            is_hash = bool(parts) and parts[-1] == "#"
            levels = parts[:-1] if is_hash else parts
            depth = len(levels)

            # ONE live node snapshot per filter (torn reads retried like
            # the full walk); serves both the exact-map and the bucket fold
            snap = None
            for _attempt in range(8):
                try:
                    node = index._seek(f, 2 if share_rooted else 0)
                    snap = empty_snap if node is None else _node_snap(node)
                    break
                except (RuntimeError, KeyError):
                    continue
            if snap is None:
                return None  # persistent tear: let the full rebuild quiesce

            if self.exact_map is not None and not map_disable:
                if is_hash or "+" in levels:
                    # a wildcard filter ends the exact-only regime; the
                    # fast path disengages until the next full rebuild
                    # re-evaluates the filter set
                    map_disable = True
                else:
                    map_updates.append(
                        ("/".join(parts), None if snap == empty_snap else snap)
                    )
            if depth > self.max_levels:
                continue  # over-deep: host-routed by length, never indexed

            # path key under the current salt (mirrors build_flat_index)
            mask = 0
            for d, tok in enumerate(levels):
                if tok == "+":
                    mask |= 1 << d
            tok1, tok2, _l, _dl, _ov = tokenize_topics(
                ["/".join(levels)], self.max_levels, self.salt
            )
            kind = KIND_HASH if is_hash else KIND_EXACT
            with np.errstate(over="ignore"):
                h1 = np.uint32(depth) * np.uint32(_M2) ^ np.uint32(kind)
                h2 = np.uint32(depth) * np.uint32(_M1) ^ np.uint32(kind)
                for d in range(depth):
                    if (mask >> d) & 1:
                        t1, t2 = np.uint32(PLUS1), np.uint32(PLUS2)
                    else:
                        t1, t2 = tok1[0, d], tok2[0, d]
                        if t1 == PLUS1 and t2 == PLUS2:
                            return None  # sentinel collision: needs a re-salt
                    h1 = _mix_np(h1, t1)
                    h2 = _mix_np(h2, t2)
            h1 = np.uint32(h1)
            h2 = np.uint32(h2)

            n_cli, n_shr, n_inl = len(snap[0]), len(snap[1]), len(snap[2])
            total = n_cli + n_shr + n_inl

            slot = int(h1 & np.uint32(S - 1))
            row = tbl[slot]
            if (int(row[0, 2]) >> _SAT_SHIFT) & 1:
                continue  # saturated bucket: already fully host-routed
            found = -1
            free = -1
            for e in range(BUCKET_ENTRIES):
                if row[e, 0] == h1 and row[e, 1] == h2 and row[e].any():
                    found = e
                    break
                if free < 0 and not row[e].any():
                    free = e

            top_wild = bool(parts) and parts[0] in ("+", "#")
            last_plus = is_hash and depth > 0 and ((mask >> (depth - 1)) & 1) == 1
            spill_new = (
                total > self.window
                or (n_cli + n_shr) > MAX_WINDOW
                or n_inl > MAX_WINDOW
            )

            def meta_word(ncli, nreg, ninl, spill):
                return np.uint32(
                    (ncli << _NCLI_SHIFT)
                    | (nreg << _NREG_SHIFT)
                    | (ninl << _NINL_SHIFT)
                    | (int(top_wild) << _TOPWILD_SHIFT)
                    | (int(last_plus) << _LASTPLUS_SHIFT)
                    | (int(spill) << _SPILL_SHIFT)
                )

            if found >= 0:
                old_meta = int(row[found, 2])
                old_spill = bool((old_meta >> _SPILL_SHIFT) & 1)
                # spilled entries carry zeroed counts, so this is 0 for them
                self.n_subs -= ((old_meta >> _NREG_SHIFT) & cnt_mask) + (
                    (old_meta >> _NINL_SHIFT) & cnt_mask
                )
                if not spill_new:
                    self.n_subs += total
                if total == 0:
                    if not old_spill:
                        self.subs.replace(int(row[found, 3]) // self.window, empty_snap)
                        self.n_orphans += 1
                    else:
                        self.n_spill -= 1
                    row[found] = 0
                    self.n_entries -= 1
                elif spill_new:
                    if not old_spill:
                        self.subs.replace(int(row[found, 3]) // self.window, empty_snap)
                        self.n_orphans += 1
                        self.n_spill += 1
                    row[found, 2] = meta_word(0, 0, 0, True)
                    row[found, 3] = 0
                else:
                    if old_spill:
                        ordinal = self.subs.append(snap)
                        self.n_spill -= 1
                    else:
                        ordinal = int(row[found, 3]) // self.window
                        self.subs.replace(ordinal, snap)
                    row[found, 2] = meta_word(n_cli, n_cli + n_shr, n_inl, False)
                    row[found, 3] = np.uint32(ordinal * self.window)
                touched.add(slot)
            else:
                if total == 0:
                    continue  # deleted before we ever indexed it
                if free < 0:
                    # fold-time saturation would orphan the bucket's OTHER
                    # entries — filters that are NOT in the delta overlay,
                    # so in-flight batches could still decode their sids
                    # against emptied snapshots. Only the full rebuild
                    # (which swaps a fresh FlatIndex wholesale, leaving
                    # captured snapshots intact) can absorb this safely.
                    return None
                # the shape must already be compiled (or claim a pad slot)
                shape_ok = False
                pad_free = -1
                for p in range(len(self.pat_depth)):
                    if (
                        self.pat_kind[p] == np.uint32(kind)
                        and self.pat_depth[p] == depth
                        and self.pat_mask[p] == np.uint32(mask)
                    ):
                        shape_ok = True
                        break
                    if pad_free < 0 and self.pat_depth[p] < 0:
                        pad_free = p
                if not shape_ok:
                    if pad_free < 0:
                        return None  # pads exhausted: recompile needed
                    self.pat_kind[pad_free] = np.uint32(kind)
                    self.pat_depth[pad_free] = np.int32(depth)
                    self.pat_mask[pad_free] = np.uint32(mask)
                    pats_changed = True
                if spill_new:
                    row[free] = (h1, h2, meta_word(0, 0, 0, True), 0)
                    self.n_spill += 1
                else:
                    ordinal = self.subs.append(snap)
                    row[free] = (
                        h1,
                        h2,
                        meta_word(n_cli, n_cli + n_shr, n_inl, False),
                        np.uint32(ordinal * self.window),
                    )
                    self.n_subs += total
                self.n_entries += 1
                touched.add(slot)

        # the fold succeeded: apply the staged exact-map maintenance. The
        # dict is shared with the live instance; mutating it here (before
        # the owner swaps this clone in) is safe for the same reason the
        # in-place np table edits are — every filter touched is in the
        # delta overlay, so in-flight resolvers host-route it
        if map_disable:
            self.exact_map = None
        elif self.exact_map is not None:
            for key_str, map_snap in map_updates:
                if map_snap is None:
                    self.exact_map.pop(key_str, None)
                else:
                    self.exact_map[key_str] = map_snap

        flat_rows = self.table  # [S, ROW_INTS] view of the same buffer
        updates = [(s, flat_rows[s].copy()) for s in sorted(touched)]
        return updates, pats_changed


def _mix_np(h: np.ndarray, t: np.ndarray) -> np.ndarray:
    h = (h ^ t).astype(np.uint32)
    h = ((h << np.uint32(13)) | (h >> np.uint32(19))).astype(np.uint32)
    return (h * np.uint32(_M1)).astype(np.uint32)


class _LazySubTable:
    """sid -> SubEntry, materialized on demand from per-entry snapshot
    tuples (clients, shared, inline) captured at build time. Sub ids are
    synthetic — entry ordinal x window + slot — so the mapping is two
    integer ops. Memoized: hot topics resolve to dict hits."""

    __slots__ = ("_window", "_snaps", "_n", "memo")

    def __init__(self, window, snaps, n) -> None:
        self._window = window
        self._snaps = snaps
        self._n = n
        self.memo: dict = {}  # public: expand_sids probes it directly

    def __len__(self) -> int:
        return self._n

    @property
    def snaps(self) -> list:
        """The raw snapshot tuples, indexed by entry ordinal — the C
        materializer (``native/accelmod.c``) walks these directly."""
        return self._snaps

    @property
    def window(self) -> int:
        """Slots per entry ordinal (sid = ordinal * window + slot)."""
        return self._window

    def __getitem__(self, sid: int) -> SubEntry:
        entry = self.memo.get(sid)
        if entry is not None:
            return entry
        cli, shr, inl = self._snaps[sid // self._window]
        local = sid % self._window
        if local < len(cli):
            client, sub = cli[local]
            entry = SubEntry(KIND_CLIENT, client, "", sub, ns_guard_class(sub.filter))
        elif local < len(cli) + len(shr):
            client, sub = shr[local - len(cli)]
            entry = SubEntry(KIND_SHARED, client, sub.filter, sub, ns_guard_class(shared_inner(sub.filter)))
        else:
            isub = inl[local - len(cli) - len(shr)]
            entry = SubEntry(KIND_INLINE, "", "", isub, ns_guard_class(isub.filter))
        self.memo[sid] = entry
        return entry

    # -- fold support (FlatIndex.fold) ------------------------------------

    def clone_for_fold(self) -> "_LazySubTable":
        """A copy-on-write clone for one fold: the snaps list is copied
        (refs only) so in-flight resolvers that captured THIS table keep
        their snapshot untouched; the memo starts empty (hot sids
        re-materialize in one batch). The clone is what fold mutates."""
        return _LazySubTable(self._window, list(self._snaps), self._n)

    def replace(self, ordinal: int, snap) -> None:
        """Swap one entry's snapshot (only ever called on a fold clone)."""
        self._snaps[ordinal] = snap
        w = self._window
        memo_pop = self.memo.pop
        for sid in range(ordinal * w, ordinal * w + w):
            memo_pop(sid, None)

    def append(self, snap) -> int:
        """Allocate a fresh ordinal for a new entry (fold clones only)."""
        self._snaps.append(snap)
        ordinal = len(self._snaps) - 1
        self._n += self._window
        return ordinal


def _node_snap(node) -> tuple:
    """Capture one trie node's subscriptions as an immutable snapshot
    tuple ``(clients, shared, inline)`` — the unit both the sid table and
    the exact-map fast path serve from. Reads the live maps without the
    lock (tears retry, same contract as ``_walk_terminals``)."""
    cli = tuple(node.subscriptions.internal.items())
    shr = (
        tuple(
            (c, s)
            for group in node.shared.internal.values()
            for c, s in group.items()
        )
        if node.shared.internal
        else ()
    )
    inl = tuple(node.inline_subscriptions.internal.values())
    return (cli, shr, inl)


def _walk_terminals(index: TopicsIndex):
    """Yield (path_levels, particle) for every trie node carrying
    subscriptions. Iterative (deep tries must not recurse) and lock-free:
    it reads the live maps without copying, so a concurrent structural
    mutation can tear the walk with RuntimeError/KeyError — callers retry
    (the same contract the sharded rebuild documents)."""
    stack = [(index.root, [])]
    while stack:
        p, path = stack.pop()
        if (
            p.subscriptions.internal
            or p.shared.internal
            or p.inline_subscriptions.internal
        ):
            yield path, p
        for key, child in p.particles.items():
            stack.append((child, path + [key]))


def build_flat_index(
    index: TopicsIndex,
    max_levels: int = 8,
    salt: int = 0,
    window: int = 16,
    min_buckets: int = 1024,
    cooperative: bool = False,
    _retries: int = 6,
) -> FlatIndex:
    """Compile the host trie into a :class:`FlatIndex`.

    Retries with a fresh salt when (a) two distinct paths collide on the
    64-bit key or (b) a real token hashes to the `+` sentinel pair
    (probability ~2^-64 each). Filters deeper than ``max_levels`` are
    omitted: every topic they could match is deeper than ``max_levels``
    too and therefore host-routed before probing.
    """
    import time as _time

    # cooperative mode (background rebuilds): yield the GIL periodically so
    # the serving thread's match latency stays flat during multi-second
    # builds — this is what keeps the churn benchmark's p99 honest
    yield_every = 4096 if cooperative else 0
    paths: list[list[str]] = []
    nodes = []
    for path, p in _walk_terminals(index):
        paths.append(path)
        nodes.append(p)
        if yield_every and len(paths) % yield_every == 0:
            _time.sleep(0)
    n_all = len(paths)

    # per-entry shape + level strings
    is_hash = np.zeros(n_all, dtype=bool)
    keep = np.ones(n_all, dtype=bool)
    depths = np.zeros(n_all, dtype=np.int32)
    masks = np.zeros(n_all, dtype=np.uint32)
    level_strs: list[list[str]] = []
    any_wild = False  # any '+'/'#' anywhere (incl. over-deep paths)
    for i, path in enumerate(paths):
        hsh = bool(path) and path[-1] == "#"
        if hsh or "+" in path:
            any_wild = True
        levels = path[:-1] if hsh else path
        if len(levels) > max_levels:
            keep[i] = False
            level_strs.append([])
            continue
        is_hash[i] = hsh
        depths[i] = len(levels)
        m = 0
        for d, tok in enumerate(levels):
            if tok == "+":
                m |= 1 << d
        masks[i] = m
        level_strs.append(levels)

    # level token hashes via the batch tokenizer (tokens never
    # contain '/', so the '/'-joined path re-tokenizes losslessly); '+'
    # levels are overwritten with the sentinel pair afterwards
    tok1, tok2, _lens, _dollar, _ovf = tokenize_topics(
        ["/".join(levels) if levels else "" for levels in level_strs],
        max_levels,
        salt,
    )
    tok1 = tok1.copy()
    tok2 = tok2.copy()
    level_idx = np.arange(max_levels)[None, :]
    in_depth = level_idx < depths[:, None]
    plus_at = ((masks[:, None] >> level_idx.astype(np.uint32)) & 1) == 1
    # a real token hashing to the sentinel pair would fake a '+' match
    if bool(np.any(in_depth & ~plus_at & (tok1 == PLUS1) & (tok2 == PLUS2))):
        if _retries <= 0:
            raise RuntimeError("persistent '+' sentinel collision")
        return build_flat_index(
            index, max_levels, salt + 1, window, min_buckets, cooperative,
            _retries - 1
        )
    tok1[plus_at & in_depth] = PLUS1
    tok2[plus_at & in_depth] = PLUS2
    # zero out beyond-depth lanes so the mix loop's `use` mask semantics
    # match the per-entry construction exactly
    tok1[~in_depth] = 0
    tok2[~in_depth] = 0

    # whole-path hashes (vectorized over entries, looped over levels)
    kind_w = np.where(is_hash, np.uint32(KIND_HASH), np.uint32(KIND_EXACT))
    with np.errstate(over="ignore"):
        h1 = (depths.astype(np.uint32) * np.uint32(_M2)) ^ kind_w
        h2 = (depths.astype(np.uint32) * np.uint32(_M1)) ^ kind_w
        for d in range(max_levels):
            use = d < depths
            h1 = np.where(use, _mix_np(h1, tok1[:, d]), h1)
            h2 = np.where(use, _mix_np(h2, tok2[:, d]), h2)

    sel = np.nonzero(keep)[0]
    key64 = (h1[sel].astype(np.uint64) << np.uint64(32)) | h2[sel].astype(np.uint64)
    if len(np.unique(key64)) != len(key64):  # distinct paths collided
        if _retries <= 0:
            raise RuntimeError("persistent path-key collision")
        return build_flat_index(
            index, max_levels, salt + 1, window, min_buckets, cooperative,
            _retries - 1
        )

    # per-entry subscription snapshots. A sub id is SYNTHETIC — entry
    # ordinal x window + slot (clients first, then shared, then inline) —
    # so nothing per-subscription is built or stored. SubEntry metadata
    # materializes lazily at expand time from the snapshot tuples
    # (:class:`_LazySubTable`), preserving build-time snapshot semantics.
    snaps: list = [None] * n_all
    n_cli = np.zeros(n_all, dtype=np.int64)
    n_shr = np.zeros(n_all, dtype=np.int64)
    n_inl = np.zeros(n_all, dtype=np.int64)
    spills = np.zeros(n_all, dtype=bool)
    top_wilds = np.zeros(n_all, dtype=bool)
    for k, i in enumerate(sel):
        node = nodes[i]
        path = paths[i]
        if yield_every and k % yield_every == 0:
            _time.sleep(0)
        top_wilds[i] = bool(path) and path[0] in ("+", "#")
        # .internal (no locked copy): tears retry, see _walk_terminals
        cli, shr, inl = snaps[i] = _node_snap(node)
        n_cli[i] = len(cli)
        n_shr[i] = len(shr)
        n_inl[i] = len(inl)
    total_ids = n_cli + n_shr + n_inl
    if window > MAX_WINDOW:
        raise ValueError(
            f"window must be <= {MAX_WINDOW} (meta packs counts in "
            f"{_CNT_BITS}-bit fields); got {window}"
        )
    spills = (
        (total_ids > window)
        | ((n_cli + n_shr) > MAX_WINDOW)
        | (n_inl > MAX_WINDOW)
    )
    n_spill = int(spills[sel].sum())
    # synthetic sid space: entry ordinal (over kept, non-spill entries) x
    # window + slot; nothing is stored — the kernel computes ids from the
    # bucket row and the host divides them back out
    ordinal = np.full(n_all, -1, dtype=np.int64)
    alive = np.zeros(n_all, dtype=bool)
    alive[sel] = True
    alive &= ~spills
    ordinal[alive] = np.arange(int(alive.sum()))
    n_sids = int(alive.sum()) * window
    if n_sids >= 1 << 30:
        # sid arithmetic is int32 end to end; leave sign-bit headroom
        raise RuntimeError(
            f"flat index sid space must stay < {1 << 30}, got {n_sids}"
        )
    bases = np.where(alive, ordinal * window, 0).astype(np.uint32)
    starts = bases  # the table's per-entry 4th word
    nclis = np.where(spills, 0, np.minimum(n_cli, MAX_WINDOW)).astype(np.uint32)
    nregs = np.where(spills, 0, np.minimum(n_cli + n_shr, MAX_WINDOW)).astype(np.uint32)
    ninls = np.where(spills, 0, np.minimum(n_inl, MAX_WINDOW)).astype(np.uint32)
    n_subs_total = int(total_ids[alive].sum())
    subs = _LazySubTable(
        window,
        [snaps[i] for i in range(n_all) if alive[i]],
        n_sids,
    )

    # size for ~0.6 entries per 4-slot bucket: P(bucket > 4 | Poisson 0.6)
    # ~ 3e-4, so saturation host-routes a negligible probe fraction
    n = len(sel)
    S = _bucket(max(min_buckets, int(n / 0.6) + 1), minimum=1024)
    slot = (h1[sel] & np.uint32(S - 1)).astype(np.int64)
    order = np.argsort(slot, kind="stable")
    sslot = slot[order]
    first = np.searchsorted(sslot, sslot, side="left")
    rank = np.arange(n) - first  # occupancy rank within each bucket
    counts = np.bincount(slot, minlength=S)
    sat = counts > BUCKET_ENTRIES
    n_sat = int(sat.sum())

    meta = (
        (nclis[sel] << np.uint32(_NCLI_SHIFT))
        | (nregs[sel] << np.uint32(_NREG_SHIFT))
        | (ninls[sel] << np.uint32(_NINL_SHIFT))
        | (top_wilds[sel].astype(np.uint32) << np.uint32(_TOPWILD_SHIFT))
        | (
            (is_hash[sel] & (depths[sel] > 0) & (((masks[sel] >> (depths[sel] - 1).astype(np.uint32)) & 1) == 1)).astype(np.uint32)
            << np.uint32(_LASTPLUS_SHIFT)
        )
        | (spills[sel].astype(np.uint32) << np.uint32(_SPILL_SHIFT))
    )
    table = np.zeros((S, BUCKET_ENTRIES, ENTRY_INTS), dtype=np.uint32)
    ok = ~sat[slot[order]]
    o = order[ok]
    cols = np.stack([h1[sel][o], h2[sel][o], meta[o], starts[sel][o]], axis=1)
    table[slot[o], rank[ok]] = cols
    table[np.nonzero(sat)[0], 0, 2] = np.uint32(1 << _SAT_SHIFT)
    table = table.reshape(S, ROW_INTS)

    # distinct probe shapes, power-of-two padded (pads have depth -1 and are
    # never active) so churn rebuilds keep the tensor shapes stable
    shape_keys = np.stack(
        [kind_w[sel], depths[sel].astype(np.uint32), masks[sel]], axis=1
    )
    if len(shape_keys):
        uniq = np.unique(shape_keys, axis=0)
    else:
        uniq = np.zeros((0, 3), dtype=np.uint32)
    pat_kind = uniq[:, 0].astype(np.uint32)
    pat_depth = uniq[:, 1].astype(np.int32)
    pat_mask = uniq[:, 2].astype(np.uint32)
    if len(uniq):
        pb = _bucket(len(uniq), minimum=2)
        pat_kind = _pad_to(pat_kind, pb, np.uint32(KIND_EXACT))
        pat_depth = _pad_to(pat_depth, pb, np.int32(-1))
        pat_mask = _pad_to(pat_mask, pb, np.uint32(0))

    # wildcard-free fast path: every terminal path (kept, spilled, and
    # over-deep alike) keyed by its literal path string — one dict probe
    # replaces the whole device round trip (FlatIndex.exact_map)
    exact_map = None
    if not any_wild:
        exact_map = {}
        for i in sel:
            exact_map["/".join(level_strs[i])] = snaps[i]
        for i in np.nonzero(~keep)[0]:
            exact_map["/".join(paths[i])] = _node_snap(nodes[i])

    return FlatIndex(
        table=table,
        pat_kind=pat_kind,
        pat_depth=pat_depth,
        pat_mask=pat_mask,
        subs=subs,
        salt=salt,
        window=window,
        max_levels=max_levels,
        n_entries=n,
        n_subs=n_subs_total,
        n_sat=n_sat,
        n_spill=n_spill,
        exact_map=exact_map,
    )


# ---------------------------------------------------------------------------
# device half: the match and fold entry points, each beside its plain
# PyTorch version. The plain versions compute u32 wraparound arithmetic in
# int64 masked to 32 bits (the CPU has no uint32 shifts) and cast outputs
# back to int32; they run only for tensors on the CPU. CUDA tensors go to
# the kernels of csrc/flat_match.cu.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_CNT_MASK = (1 << _CNT_BITS) - 1


def pack_tokens(tok1, tok2, lengths, is_dollar) -> np.ndarray:
    """Pack a tokenized batch into ONE int32 host array ``[B, 2L+2]`` so a
    match call performs a single H2D transfer."""
    return np.concatenate(
        [
            tok1.view(np.int32),
            tok2.view(np.int32),
            lengths[:, None].astype(np.int32),
            is_dollar[:, None].astype(np.int32),
        ],
        axis=1,
    )


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. CUDA is every entry
    point's default; asking for it where there is no card raises — there
    is no silent switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_index_from_numpy(table, pat_kind, pat_depth, pat_mask, device="cuda"):
    """Carry a built :class:`FlatIndex`'s numpy arrays (this package's or
    the JAX package's — they are bit-identical) onto ``device`` as the
    matcher's int32 tensors ``(table[S,16], pat_kind[P], pat_depth[P],
    pat_mask[P])``, u32 words kept as their bit patterns. Always copies:
    a fold edits the numpy table in place, and the device table must
    change only through ``scatter_rows``."""
    dev = resolve_device(device)
    return tuple(device_i32(a, dev) for a in (table, pat_kind, pat_depth, pat_mask))


def device_i32(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a 32-bit numpy array on ``device`` as an int32 tensor of
    the same bit patterns."""
    host = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return host.to(device, copy=True)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values, as int64."""
    return t.to(torch.int64) & _MASK32


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """The low 32 bits of ``x * m`` for ``x`` in [0, 2^32): split into 16-bit
    halves so no int64 product overflows."""
    hi = ((x >> 16) * m) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * m) & _MASK32


def _mix(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    x = h ^ t
    x = ((x << 13) | (x >> 19)) & _MASK32
    return _mul32(x, _M1)


def _unpack_tokens(packed: torch.Tensor, max_levels: int):
    """Split the packed ``[B, 2L+2]`` token matrix (``pack_tokens``)."""
    if packed.dim() != 2 or packed.shape[1] < 2 or packed.shape[1] % 2:
        raise ValueError(f"packed tokens must be [B, 2L+2], got {tuple(packed.shape)}")
    L = (packed.shape[1] - 2) // 2
    if not 0 <= max_levels <= L:
        raise ValueError(f"max_levels {max_levels} exceeds the token width {L}")
    return (
        packed[:, :L],
        packed[:, L : 2 * L],
        packed[:, 2 * L],
        packed[:, 2 * L + 1] != 0,
    )


def _path_hashes(pat_kind, pat_depth, pat_mask, tok1, tok2, lengths, max_levels):
    """Whole-path probe hashes ``h1, h2`` [B, P] with the ``+`` sentinel at
    each shape's plus levels, and the probe masks."""
    B, P = tok1.shape[0], pat_depth.shape[0]
    kd = _u32(pat_depth)
    kind = _u32(pat_kind)
    mask = _u32(pat_mask)
    h1 = (_mul32(kd, _M2) ^ kind).expand(B, P)
    h2 = (_mul32(kd, _M1) ^ kind).expand(B, P)
    t1 = _u32(tok1)
    t2 = _u32(tok2)
    for d in range(max_levels):
        use = (pat_depth > d)[None, :]
        plus = (((mask >> d) & 1) == 1)[None, :]
        h1 = torch.where(use, _mix(h1, torch.where(plus, PLUS1, t1[:, d : d + 1])), h1)
        h2 = torch.where(use, _mix(h2, torch.where(plus, PLUS2, t2[:, d : d + 1])), h2)
    n = lengths.to(torch.int64)[:, None]
    depth = pat_depth.to(torch.int64)[None, :]
    hash_pat = (kind == KIND_HASH)[None, :]
    exact_len = depth == n
    active = torch.where(hash_pat, depth <= n, exact_len)
    return h1, h2, active, hash_pat, exact_len


def probe_slots(table, pat_kind, pat_depth, pat_mask, packed_tokens, *, max_levels):
    """The bucket rows one batch's probes gather: the slot of every active
    (topic, shape) probe — what a batch must read from the table."""
    tok1, tok2, lengths, _ = _unpack_tokens(packed_tokens, max_levels)
    h1, _, active, _, _ = _path_hashes(
        pat_kind, pat_depth, pat_mask, tok1, tok2, lengths, max_levels
    )
    return (h1 & (table.shape[0] - 1))[active]


def probe_plain(table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels):
    """The probe stage (the JAX package's ``_probe_head``): per (topic,
    shape) probe, ONE bucket-row gather, a 4-way key compare, the meta
    decode and the ``#``/``$`` rules. Returns ``(start[B,P] i32,
    cnt[B,P] i32, overflow[B] bool)``."""
    tok1, tok2, lengths, is_dollar = _unpack_tokens(packed_tokens, max_levels)
    h1, h2, active, hash_pat, exact_len = _path_hashes(
        pat_kind, pat_depth, pat_mask, tok1, tok2, lengths, max_levels
    )
    B, P = h1.shape
    S = table.shape[0]
    slot = torch.where(active, h1 & (S - 1), 0)
    rows = _u32(table[slot]).reshape(B, P, BUCKET_ENTRIES, ENTRY_INTS)
    hit = (rows[..., 0] == h1[..., None]) & (rows[..., 1] == h2[..., None])
    hit = hit & active[..., None]
    meta = torch.where(hit, rows[..., 2], 0).amax(dim=-1)
    base = torch.where(hit, rows[..., 3], 0).amax(dim=-1)
    hit_any = hit.any(dim=-1)
    sat_probe = ((rows[:, :, 0, 2] >> _SAT_SHIFT) & 1) == 1

    ncli = (meta >> _NCLI_SHIFT) & _CNT_MASK
    nreg = (meta >> _NREG_SHIFT) & _CNT_MASK
    ninl = (meta >> _NINL_SHIFT) & _CNT_MASK
    top_wild = ((meta >> _TOPWILD_SHIFT) & 1) == 1
    last_plus = ((meta >> _LASTPLUS_SHIFT) & 1) == 1
    spill = ((meta >> _SPILL_SHIFT) & 1) == 1

    # 'filter/#' matching the exact-length topic: only via a literal last
    # level (topics.go:612), and without inline subs (topics.go:615)
    valid_hit = hit_any & ~(hash_pat & exact_len & last_plus)
    count = torch.where(hash_pat & exact_len, nreg, nreg + ninl)
    count = torch.where(valid_hit, count, 0)
    # $-topics never match top-level-wildcard CLIENT subscriptions
    # [MQTT-4.7.1-1/2]; clients occupy the window prefix [0, ncli)
    dollar = is_dollar[:, None] & top_wild
    lo = torch.where(dollar, torch.minimum(ncli, count), 0)
    cnt = count - lo
    base = torch.where(base >= 1 << 31, base - (1 << 32), base)  # i32 bitcast
    start = base + lo
    overflow = (sat_probe & active).any(dim=1) | (spill & valid_hit).any(dim=1)
    return start.to(torch.int32), cnt.to(torch.int32), overflow


def flat_match_packed_plain(table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels):
    """The probe with its per-topic total and overflow flag, packed into
    one ``[B, 2P+2]`` row per topic."""
    start, cnt, overflow = probe_plain(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels
    )
    return torch.cat(
        [
            start,
            cnt,
            cnt.sum(dim=1, dtype=torch.int32)[:, None],
            overflow[:, None].to(torch.int32),
        ],
        dim=1,
    )


def _slots_constant(B: int, out_slots: int, device):
    """The slot output of an index with no probes (P == 0): nothing
    matches, nothing overflows."""
    return (
        torch.full((B, out_slots), -1, dtype=torch.int32, device=device),
        torch.zeros((B,), dtype=torch.int32, device=device),
        torch.zeros((B,), dtype=torch.bool, device=device),
    )


def flat_match_core_plain(
    table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, out_slots, overflow_slots=0
):
    """The probe, expanded to ``out_slots`` sid slots per topic: slot k is
    ``start[p] + (k - prev[p])`` for the probe p whose range ``[prev[p],
    prev[p] + cnt[p])`` of the topic's running count holds k, and -1 past
    the total. One masked write per probe, the ranges' offsets from a
    cumsum over the probes. ``totals`` is not clipped; ``overflow`` adds
    ``totals > (overflow_slots or out_slots)`` to the probe's own flag."""
    B = packed_tokens.shape[0]
    P = pat_depth.shape[0]
    dev = packed_tokens.device
    if P == 0:
        _unpack_tokens(packed_tokens, max_levels)
        return _slots_constant(B, out_slots, dev)
    start, cnt, overflow = probe_plain(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels
    )
    offs = torch.cumsum(cnt.to(torch.int64), dim=1)  # inclusive; int64 on the CPU
    prev = offs - cnt
    ks = torch.arange(out_slots, dtype=torch.int64, device=dev)[None, :]
    out = torch.full((B, out_slots), -1, dtype=torch.int64, device=dev)
    for p in range(P):
        lo = prev[:, p : p + 1]
        inside = (ks >= lo) & (ks < offs[:, p : p + 1])
        out = torch.where(inside, start[:, p : p + 1].to(torch.int64) + (ks - lo), out)
    totals = offs[:, -1]
    overflow = overflow | (totals > (overflow_slots or out_slots))
    return out.to(torch.int32), totals.to(torch.int32), overflow


def _compact_constant(B: int, capacity: int, device) -> torch.Tensor:
    """The compact output of a batch with no probes (P == 0) or no topics:
    no hits, nothing overflows."""
    out = torch.full((2 + 2 * B + capacity,), -1, dtype=torch.int32, device=device)
    out[: 2 + 2 * B] = 0
    return out


def segment_of_slot_plain(c_flat: torch.Tensor, offs: torch.Tensor, capacity: int) -> torch.Tensor:
    """The JAX package's ``_segment_of_slot`` (int64): which segment
    supplies each of ``capacity`` compacted slots. Every non-empty segment
    marks ``id + 1`` at ``min(offset, capacity-1)``, a running max fills
    the runs, so an overflowing stream's last slot reads the LAST
    non-empty segment overall; slots past the hits read the last marked
    segment (callers mask them)."""
    n_segs = c_flat.shape[0]
    nonzero = c_flat > 0
    targets = torch.where(nonzero, offs.clamp(max=capacity - 1), capacity - 1)
    ids = torch.arange(1, n_segs + 1, dtype=torch.int64, device=c_flat.device)
    marks = torch.zeros(capacity, dtype=torch.int64, device=c_flat.device).scatter_reduce(
        0, targets, torch.where(nonzero, ids, 0), reduce="amax"
    )
    return (torch.cummax(marks, dim=0).values - 1).clamp(0, n_segs - 1)


def flat_match_compact_plain(
    table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, capacity
):
    """Probe, exclusive prefix sum over the B*P counts, and the topic-major
    sid stream, with the JAX package's segment-of-slot rule: every
    non-empty segment marks ``id + 1`` at ``min(offset, capacity-1)``, a
    running max assigns each slot its segment, so an overflowing batch's
    last slot reads the LAST non-empty segment overall."""
    B = packed_tokens.shape[0]
    P = pat_depth.shape[0]
    dev = packed_tokens.device
    if P == 0 or B == 0:
        _unpack_tokens(packed_tokens, max_levels)
        return _compact_constant(B, capacity, dev)
    start, cnt, overflow = probe_plain(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels
    )
    totals = cnt.sum(dim=1, dtype=torch.int32)
    c_flat = cnt.reshape(-1).to(torch.int64)
    cum = torch.cumsum(c_flat, dim=0)
    offs = cum - c_flat
    n_hits = cum[-1]
    seg = segment_of_slot_plain(c_flat, offs, capacity)
    k = torch.arange(capacity, dtype=torch.int64, device=dev)
    sid = start.reshape(-1).to(torch.int64)[seg] + (k - offs[seg])
    sid = torch.where(k < n_hits, sid, -1)
    header = torch.stack([n_hits, (n_hits > capacity).to(torch.int64)])
    return torch.cat(
        [header, totals.to(torch.int64), overflow.to(torch.int64), sid]
    ).to(torch.int32)


def scatter_rows_plain(table, idx, rows):
    """The plain version of K3, in place: ``table[idx] = rows`` with
    out-of-range indices dropped; returns ``table``."""
    ok = (idx >= 0) & (idx < table.shape[0])
    table[idx[ok].to(torch.int64)] = rows[ok]
    return table


def flat_match_packed(table, pat_kind, pat_depth, pat_mask, packed_tokens, *, max_levels):
    """The production single-device form: ONE packed input ``[B, 2L+2]``
    i32 (``pack_tokens``) and ONE packed ranges output ``[B, 2P+2]`` i32
    = (range starts | range counts | total | overflow). Ranges carry the
    complete result; ``overflow`` marks saturated-bucket probes and
    spilled-entry hits (the host re-walks those topics)."""
    if packed_tokens.device.type == "cpu":
        return flat_match_packed_plain(
            table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels
        )
    return kernels.flat_probe_ranges(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels
    )


def flat_match_ranges(
    table, pat_kind, pat_depth, pat_mask, tok1, tok2, lengths, is_dollar, *, max_levels
):
    """Match ``B`` pre-tokenized topics, emitting per-probe sid ranges:
    ``(start[B,P] i32, cnt[B,P] i32, totals[B] i32, overflow[B] bool)``.
    ``tok1``/``tok2`` are int32 or uint32 tensors of the u32 hashes. The
    same kernel as :func:`flat_match_packed`; its output columns are
    split into views."""
    packed = torch.cat(
        [
            tok1.view(torch.int32),
            tok2.view(torch.int32),
            lengths.to(torch.int32)[:, None],
            is_dollar.to(torch.int32)[:, None],
        ],
        dim=1,
    )
    out = flat_match_packed(
        table, pat_kind, pat_depth, pat_mask, packed, max_levels=max_levels
    )
    P = pat_depth.shape[0]
    return out[:, :P], out[:, P : 2 * P], out[:, 2 * P], out[:, 2 * P + 1] != 0


def flat_match_core(
    table, pat_kind, pat_depth, pat_mask, packed_tokens, *, max_levels, out_slots,
    overflow_slots=0,
):
    """Match ``B`` topics and expand every result to sid slots (the
    mesh-sharded path's per-shard form): ``(sub_ids[B, out_slots] int32
    -1-padded, totals[B] int32, overflow[B] bool)``. ``totals`` is the true
    hit count; ``overflow`` marks topics the host must re-walk (saturated
    probe, spilled hit, or more hits than ``overflow_slots or
    out_slots``)."""
    if out_slots < 1:
        raise ValueError(f"out_slots must be >= 1, got {out_slots}")
    if packed_tokens.device.type == "cpu":
        return flat_match_core_plain(
            table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, out_slots,
            overflow_slots,
        )
    if pat_depth.shape[0] == 0:  # the constant output, no launch
        _unpack_tokens(packed_tokens, max_levels)
        return _slots_constant(packed_tokens.shape[0], out_slots, packed_tokens.device)
    return kernels.flat_match_slots(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, out_slots,
        overflow_slots,
    )


def flat_match_compact(
    table, pat_kind, pat_depth, pat_mask, packed_tokens, *, max_levels, capacity
):
    """Device-resident hit compaction: match ``B`` topics and compact every
    hit into ONE int32 vector ``[2 + 2B + capacity]`` = ``(n_hits,
    batch_overflow | totals[B] | overflow[B] | sid stream)``, the stream
    topic-major and -1-padded. ``n_hits`` is the TRUE hit count even when
    it exceeds ``capacity`` (``batch_overflow`` then routes the batch onto
    the packed path). Nothing here synchronises with the host."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if packed_tokens.device.type == "cpu":
        return flat_match_compact_plain(
            table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, capacity
        )
    B = packed_tokens.shape[0]
    if pat_depth.shape[0] == 0 or B == 0:  # the constant output, no launch
        _unpack_tokens(packed_tokens, max_levels)
        return _compact_constant(B, capacity, packed_tokens.device)
    return kernels.flat_match_compact(
        table, pat_kind, pat_depth, pat_mask, packed_tokens, max_levels, capacity
    )


def scatter_rows(table, idx, rows):
    """The fold's bucket-row update, IN PLACE: ``table[idx] = rows``,
    returning ``table``. A departure from the JAX package, whose
    ``_scatter_core`` is functional (``table.at[idx].set(rows)``, a new
    table, so batches in flight keep the old one): a copy of the whole
    table per fold moved 64 MB each way at 1M subscriptions for a few KB
    of rows. The port keeps batches in flight safe another way:
    ``TorchMatcher`` holds two buffers of its table and writes only the
    one no batch has captured (``TorchMatcher.fold``). Duplicate indices
    carry identical rows; indices outside ``[0, S)`` are dropped; no
    padding is needed (K3 takes any ``k``)."""
    if table.device.type == "cpu":
        return scatter_rows_plain(table, idx, rows)
    return kernels.scatter_rows(table, idx, rows)
