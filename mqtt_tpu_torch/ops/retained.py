"""Retained matching on the card: the publish probe run in reverse.

A wildcard SUBSCRIBE against a large retained store is the mirror image of
the PUBLISH match: PUBLISH asks which of P filters match one topic, a
SUBSCRIBE asks which of B retained topics match one filter. Both are the
same hash join, so this engine runs K1 (``flat_match_packed``,
``csrc/flat_match.cu``) with the roles swapped: the SUBSCRIBE filter
becomes a one-pattern flat index (``build_flat_index`` over a throwaway
one-subscription trie; the build pads its pattern arrays to P = 2, the pad
never probing) and the retained topic NAMES become the topic batch (B =
the corpus capacity). The totals column of K1's output
names every retained topic the filter reaches.

A copy of the JAX package's ``ops/retained.py``. Its answers equal the
host walk (``TopicsIndex.messages``) by the same means:

- **Namespace partition.** The corpus is kept per tenant namespace with
  LOCAL names, so a global wildcard never reaches a namespace and a
  scoped filter never leaves one, by construction.
- **``$SYS`` override.** The kernel's dollar rule reads the packed
  ``is_dollar`` column, which the engine sets to "first local level is
  ``$SYS``" (the walk's guard), not to the tokenizer's ``startswith("$")``:
  ``$other/...`` stays visible to top-level wildcards, as in the walk.
- **``#`` base depth.** The kernel lets ``a/#`` match ``a`` (spec
  4.7.1.2); the retained walk collects only strictly deeper topics, so
  hits whose level count equals a ``#`` filter's base depth are dropped
  on the host.
- **Counted fallbacks.** A filter or a corpus topic deeper than
  ``max_levels`` (``depth``), a filter the one-pattern index cannot seat
  (``filter``) and a kernel probe overflow (``overflow``) answer None,
  and the caller walks the trie.
- **Sampled oracle.** One served match in ``oracle_sample`` replays the
  walk; the walk wins a mismatch, which is counted.

How the port departs from the JAX engine: there is no circuit breaker
(a failed launch or copy raises to the caller, so there is no ``error``
or ``breaker`` fallback class), and each namespace's packed corpus
``[cap, 2L+2]`` i32 lives on the device. A match copies to the device
only the rows tokenized since the last match, on the stream the kernel
runs on; a grown or compacted corpus gets a new tensor, so a queued
launch never reads rows being rewritten. Each match is one K1 launch and
one copy back of the ``total`` and ``overflow`` columns of the corpus's
first ``n`` rows.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..packets import Subscription
from ..topics import NS_CHAR, TopicsIndex, ns_local, ns_tenant
from .flat import (
    build_flat_index,
    device_index_from_numpy,
    flat_match_packed,
    resolve_device,
)
from .hashing import tokenize_topics

# host-fallback classes (counted)
FALLBACK_CLASSES = ("depth", "filter", "overflow")

_MIN_CAPACITY = 1024  # padded corpus floor: bounds the launch shapes
_FILTER_CACHE = 512  # one-pattern indexes kept, first in first out


def _is_sys_local(name: str) -> bool:
    """The walk's guard: the first LOCAL level is exactly ``$SYS``."""
    return name == "$SYS" or name.startswith("$SYS/")


class _NsCorpus:
    """One namespace's retained names and their packed token rows on the
    device. Tombstoned rows keep their stale tokens (a match drops them
    by ``names[i] is None``) until the tombstone share forces a
    compaction. ``overflow`` and ``lengths`` are the host copies of the
    tokenizer's over-deep flags and level counts."""

    __slots__ = ("names", "pos", "tombstones", "packed", "overflow", "lengths", "n_tok")

    def __init__(self) -> None:
        self.names: List[Optional[str]] = []
        self.pos: Dict[str, int] = {}
        self.tombstones = 0
        self.packed: Optional[torch.Tensor] = None  # i32 [cap, 2L+2] on the device
        self.overflow: Optional[np.ndarray] = None  # bool [cap]
        self.lengths: Optional[np.ndarray] = None  # i32 [cap]
        self.n_tok = 0  # rows of `names` present in `packed`

    def active(self) -> int:
        return len(self.names) - self.tombstones


class RetainedMatchEngine:
    """Retained-topic matching for wildcard SUBSCRIBE on ``device``
    (``"cuda"`` by default, raising where there is no card; ``"cpu"`` runs
    K1's plain version), with the host walk as its sampled oracle."""

    def __init__(
        self,
        index: TopicsIndex,
        max_levels: int = 8,
        oracle_sample: int = 16,
        min_capacity: int = _MIN_CAPACITY,
        rebuild_ratio: float = 0.25,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.index = index
        self.max_levels = max_levels
        # 1-in-N sampled replay of the walk (0 disables it)
        self.oracle_sample = max(0, oracle_sample)
        self.min_capacity = max(1, min_capacity)
        self.rebuild_ratio = rebuild_ratio
        self._corpora: Dict[str, _NsCorpus] = {}
        # local filter -> (FlatIndex, its four arrays on the device)
        self._fidx_cache: Dict[str, tuple] = {}
        self._lock = threading.Lock()  # corpus and cache bookkeeping
        self._calls = 0
        self.device_matches = 0
        self.oracle_checks = 0
        self.oracle_mismatches = 0
        self.fallbacks: Dict[str, int] = {k: 0 for k in FALLBACK_CLASSES}

    # -- corpus maintenance ------------------------------------------------

    def note_retained(self, topic: str, retained: bool) -> None:
        """Track one scoped retained-topic mutation (a broker calls this
        after ``retain_message``: ``retained`` is ``r == 1``)."""
        ns = ns_tenant(topic)
        local = ns_local(topic)
        with self._lock:
            c = self._corpora.get(ns)
            if c is None:
                if not retained:
                    return
                c = self._corpora[ns] = _NsCorpus()
            if retained:
                if local not in c.pos:
                    c.pos[local] = len(c.names)
                    c.names.append(local)
            else:
                i = c.pos.pop(local, None)
                if i is not None:
                    c.names[i] = None
                    c.tombstones += 1
                    if c.tombstones > self.rebuild_ratio * max(1, len(c.names)):
                        self._compact(c)

    def reseed(self) -> int:
        """Rebuild every corpus from the trie's retained store (restart
        restore, drift repair). Returns the corpus size."""
        snapshot = self.index.retained.get_all()
        corpora: Dict[str, _NsCorpus] = {}
        for topic in snapshot:
            ns = ns_tenant(topic)
            c = corpora.get(ns)
            if c is None:
                c = corpora[ns] = _NsCorpus()
            local = ns_local(topic)
            c.pos[local] = len(c.names)
            c.names.append(local)
        with self._lock:
            self._corpora = corpora
        return len(snapshot)

    def _compact(self, c: _NsCorpus) -> None:
        """Drop tombstones; the next match tokenizes the corpus into a new
        tensor (lock held)."""
        c.names = [n for n in c.names if n is not None]
        c.pos = {n: i for i, n in enumerate(c.names) if n is not None}
        c.tombstones = 0
        c.packed = None
        c.overflow = None
        c.lengths = None
        c.n_tok = 0

    def _ensure_tokens(self, c: _NsCorpus) -> None:
        """Tokenize the rows appended since the last match and copy them
        into the device corpus (lock held). The corpus pads to a power of
        two of at least ``min_capacity`` rows (zero rows, never read on
        the host); a larger capacity takes a new tensor, the kept rows
        copied over on the device."""
        n = len(c.names)
        L = self.max_levels
        width = 2 * L + 2
        cap = self.min_capacity
        while cap < n:
            cap *= 2
        if c.packed is None or c.packed.shape[0] < cap:
            packed = torch.zeros((cap, width), dtype=torch.int32, device=self.device)
            overflow = np.zeros(cap, dtype=bool)
            lengths = np.zeros(cap, dtype=np.int32)
            if c.packed is not None and c.n_tok:
                packed[: c.n_tok].copy_(c.packed[: c.n_tok])
                overflow[: c.n_tok] = c.overflow[: c.n_tok]  # type: ignore[index]
                lengths[: c.n_tok] = c.lengths[: c.n_tok]  # type: ignore[index]
            c.packed, c.overflow, c.lengths = packed, overflow, lengths
        if c.n_tok < n:
            rows, over = self._tokenize(c.names[c.n_tok : n])
            assert c.overflow is not None and c.lengths is not None
            c.packed[c.n_tok : n].copy_(torch.from_numpy(rows))
            c.overflow[c.n_tok : n] = over
            c.lengths[c.n_tok : n] = rows[:, 2 * L]
            c.n_tok = n

    def _tokenize(self, names: list) -> tuple:
        """Packed rows ``[len(names), 2L+2]`` i32 and over-deep flags of
        local names (a tombstone packs as ``""``), on the host."""
        L = self.max_levels
        fresh = [x if x is not None else "" for x in names]
        tok1, tok2, lengths, _dollar, over = tokenize_topics(fresh, L, 0)
        rows = np.empty((len(fresh), 2 * L + 2), dtype=np.int32)
        rows[:, :L] = tok1.view(np.int32)
        rows[:, L : 2 * L] = tok2.view(np.int32)
        rows[:, 2 * L] = lengths
        # the $SYS guard override (module docstring): NOT startswith("$")
        rows[:, 2 * L + 1] = np.fromiter((_is_sys_local(x) for x in fresh), dtype=bool, count=len(fresh))
        return rows, over

    # -- filter index ------------------------------------------------------

    def _filter_index(self, local_filter: str) -> Optional[tuple]:
        """The one-pattern flat index of a SUBSCRIBE filter and its arrays
        on the device (cached: fleets re-subscribe the same wildcard
        filters), or None when the kernel cannot represent it."""
        hit = self._fidx_cache.get(local_filter)
        if hit is not None:
            return hit
        tmp = TopicsIndex()
        tmp.subscribe("\x00probe", Subscription(filter=local_filter, qos=0))
        fidx = build_flat_index(tmp, max_levels=self.max_levels, salt=0, min_buckets=64)
        if fidx.n_entries != 1 or fidx.salt != 0:
            return None  # an over-deep filter omitted, or the salt re-rolled
        arrays = device_index_from_numpy(
            fidx.table, fidx.pat_kind, fidx.pat_depth, fidx.pat_mask, self.device
        )
        if len(self._fidx_cache) >= _FILTER_CACHE:
            self._fidx_cache.pop(next(iter(self._fidx_cache)))
        self._fidx_cache[local_filter] = (fidx, arrays)
        return fidx, arrays

    # -- matching ----------------------------------------------------------
    #
    # A device match is four steps, each its own method so a measurement
    # can time them apart: ``_corpus`` (``_tokenize`` the fresh rows and
    # copy them to the device), ``_launch`` (K1), ``_fetch`` (the copy
    # back) and ``_select`` (the host filter).

    def _host_names(self, filter: str) -> List[str]:
        return [pk.topic_name for pk in self.index.messages(filter)]

    def _corpus(self, ns: str) -> Optional[tuple]:
        """``(names, n, packed, lengths)`` of a namespace with its device
        rows up to date; ``()`` for an empty namespace; None (``depth``
        counted) when it holds an over-deep topic, whose deep levels the
        kernel cannot see, so the walk serves the whole namespace."""
        with self._lock:
            c = self._corpora.get(ns)
            if c is None or c.active() == 0:
                return ()
            self._ensure_tokens(c)
            assert c.packed is not None and c.overflow is not None
            n = len(c.names)
            if bool(c.overflow[:n].any()):
                self.fallbacks["depth"] += 1
                return None
            # rows below n never move: a compaction replaces the list and
            # the tensor, and a row cleared meanwhile reads None
            return c.names, n, c.packed, c.lengths

    def _launch(self, arrays: tuple, packed: torch.Tensor) -> torch.Tensor:
        """K1 over the whole padded corpus: ``[cap, 2P+2]`` i32 on the device."""
        return flat_match_packed(*arrays, packed, max_levels=self.max_levels)

    @staticmethod
    def _fetch(out: torch.Tensor, n: int, p: int) -> np.ndarray:
        """The ``total`` and ``overflow`` columns of the first ``n`` rows,
        on the host: ``[n, 2]`` i32."""
        return out[:n, 2 * p :].cpu().numpy()

    @staticmethod
    def _select(res: np.ndarray, names: list, lengths: np.ndarray, local: str) -> Optional[list]:
        """The live hits, ascending by row, with the walk's strictly-deeper
        ``#`` rule; None when a probe overflowed."""
        if bool(res[:, 1].any()):
            return None
        hits = np.flatnonzero(res[:, 0] > 0)
        if local == "#" or local.endswith("/#"):
            base = len(local.split("/")) - 1
            hits = hits[lengths[hits] != base]
        return [names[i] for i in hits.tolist() if names[i] is not None]

    def _device_names(self, filter: str) -> Optional[List[str]]:
        """The kernel leg: scoped retained names matching ``filter``, or
        None with the fallback class counted."""
        ns = ns_tenant(filter)
        local = ns_local(filter)
        if len(local.split("/")) > self.max_levels:
            self.fallbacks["depth"] += 1
            return None
        corpus = self._corpus(ns)
        if corpus is None:
            return None
        if not corpus:
            return []
        names, n, packed, lengths = corpus
        entry = self._filter_index(local)
        if entry is None:
            self.fallbacks["filter"] += 1
            return None
        fidx, arrays = entry
        res = self._fetch(self._launch(arrays, packed), n, fidx.num_patterns)
        hits = self._select(res, names, lengths, local)
        if hits is None:
            self.fallbacks["overflow"] += 1
            return None
        self.device_matches += 1
        if ns:
            prefix = NS_CHAR + ns + "/"
            return [prefix + name for name in hits]
        return hits

    def match(self, filter: str) -> Optional[List[str]]:
        """Scoped retained topic names matching a scoped WILDCARD filter,
        or None when the caller must walk the trie itself (an exact or
        ``$SHARE/`` filter, a fallback class)."""
        local = ns_local(filter)
        if "+" not in local and "#" not in local:
            return None  # exact filters take the walk's one-lookup path
        if local.startswith("$SHARE/"):
            return None  # shared filters get no retained delivery
        names = self._device_names(filter)
        if names is None:
            return None
        self._calls += 1
        if self.oracle_sample and self._calls % self.oracle_sample == 0:
            self.oracle_checks += 1
            host = self._host_names(filter)
            if sorted(host) != sorted(names):
                self.oracle_mismatches += 1
                return host  # the walk wins
        return names

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            corpus = sum(c.active() for c in self._corpora.values())
        return {
            "corpus": corpus,
            "device_matches": self.device_matches,
            "oracle_checks": self.oracle_checks,
            "oracle_mismatches": self.oracle_mismatches,
            "fallbacks": dict(self.fallbacks),
        }
