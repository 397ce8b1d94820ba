"""Subscription-sharded matching over a 2-D mesh of card positions.

Mesh axes, as in the JAX package (``mqtt_tpu/parallel/sharded.py``):

- ``batch`` — data parallelism over the PUBLISH topic batch
- ``subs``  — the subscription set split into shards: the positions along
  this axis hold the flat-hash index (``ops/flat.py``) of their shard

One step matches every (batch tile, shard) pair and gathers the per-shard
sid slots of a tile into one ``[S, b, K]`` buffer on the tile's owner
(the tile's first position), so every batch row ends with the full union
of sub ids. One process drives the whole mesh, as the JAX package's
``shard_map`` does; positions may repeat a device. Where a tile's shards
lie on its owner's card the kernel writes straight into the gathered
layout, one launch for every such tile of the owner (on one card, one
launch per step); shards on another card write there and are copied
across. A second kernel compacts each gathered tile into a ``(shard,
sid)`` pair stream sized for the hits that exist, and the host maps local
sub ids through per-shard tables and merges them shard by shard.

Who is delivered, and at which QoS, equals the host trie. One known
departure, kept from the JAX package (whose results the port reproduces
result for result, and where it must be fixed as well): a client whose
matching filters lie in different shards gets the merged Subscription of
the first shard's filter — its ``filter``, ``identifier`` and retain
flags — where the trie keeps the walk's first. With one matching filter
per client the results are identical to the trie.

Shard assignment is a stable hash of (client, filter), so one
subscription mutation touches exactly one shard. The matcher keeps a
per-shard replica ``TopicsIndex`` fed from the trie's mutation stream
(``TopicsIndex.add_observer``), marks the owning shard dirty, and an
incremental ``rebuild()`` recompiles only dirty shards.

The kernels (``csrc/sharded.cu``): K7/K8 ``match_slots`` (the JAX
``flat_match_core`` inside ``step_fn``) and K9 ``tile_compact``
(``_tile_compact_core``). On CPU positions their plain PyTorch versions
run; on a card a kernel or copy failure raises to the caller.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.devicestats import KernelWatch
from ..ops.flat import (
    KIND_CLIENT,
    KIND_INLINE,
    KIND_SHARED,
    _bucket,
    _pad_to,
    _walk_terminals,
    build_flat_index,
    device_i32,
    flat_match_core_plain,
    pack_tokens,
    resolve_device,
    segment_of_slot_plain,
)
from ..ops.hashing import tokenize_topics
from ..ops.matcher import (
    MatcherStats,
    _accel,
    fold_hits_ewma,
    materialize_compact_pairs,
    ns_modes,
    pick_compact_capacity,
)
from ..telemetry import FILL_BOUNDS, Histogram
from ..topics import Mutation, Subscribers, TopicsIndex

_log = logging.getLogger("mqtt_tpu_torch.parallel")


class Mesh:
    """A 2-D grid of ``torch.device`` positions with the axes ``batch`` and
    ``subs``. Positions may repeat a device."""

    axis_names = ("batch", "subs")

    def __init__(self, grid) -> None:
        rows = [tuple(row) for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = tuple(rows)
        self.shape = {"batch": len(rows), "subs": len(rows[0])}

    def unique_devices(self) -> list:
        """The distinct devices of the mesh, in position order."""
        seen: list = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def _position(device) -> torch.device:
    """One mesh position: a resolved device, a CUDA one with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, batch_axis: Optional[int] = None) -> Mesh:
    """A 2-D (batch, subs) mesh over the given positions (default: every
    visible CUDA device; raises when there is none). The batch axis is 2
    when the count is even and above 1, as in the JAX package."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; give make_mesh CPU positions "
                "(make_mesh(['cpu'] * n)) to run the plain PyTorch path"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_position(d) for d in devices]
    n = len(devs)
    if batch_axis is None:
        batch_axis = 2 if n % 2 == 0 and n > 1 else 1
    subs_axis = n // batch_axis if batch_axis > 0 else 0
    if subs_axis < 1:
        raise ValueError(f"cannot lay {n} positions out with batch axis {batch_axis}")
    return Mesh([devs[r * subs_axis : (r + 1) * subs_axis] for r in range(batch_axis)])


def shard_of(kind, client: str, filter: str, identifier: int, n_shards: int) -> int:
    """Stable shard assignment: a deterministic hash of the subscription's
    identity, independent of enumeration order or churn history — so the
    same subscription always lands on the same shard and a mutation dirties
    exactly one shard."""
    if kind in (KIND_INLINE, "inline"):
        key = f"\x00inline\x00{identifier}\x00{filter}"
    else:
        key = f"{client}\x00{filter}"
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) % n_shards


# -- K8: the step --------------------------------------------------------------


def sharded_step_plain(tables, pat_kind, pat_depth, pat_mask, tokens, *, max_levels, out, totals, overflow):
    """Every shard of the stack on ``T`` batch tiles (``flat_match_core``
    per shard and tile): ``tokens [T*b, 2L+2]`` written into the gathered
    ``out [T, S, b, K]``, ``totals [T, S, b]`` and ``overflow [T, S, b]``.
    Outputs ``[S, b, K]``, ``[S, b]``, ``[S, b]`` are one tile."""
    if out.dim() == 4:
        b = out.shape[2]
        for t in range(out.shape[0]):
            sharded_step_plain(
                tables, pat_kind, pat_depth, pat_mask, tokens[t * b : (t + 1) * b], max_levels=max_levels,
                out=out[t], totals=totals[t], overflow=overflow[t],
            )
        return
    for s in range(tables.shape[0]):
        o, t, v = flat_match_core_plain(
            tables[s], pat_kind[s], pat_depth[s], pat_mask[s], tokens, max_levels, out.shape[2]
        )
        out[s] = o
        totals[s] = t
        overflow[s] = v


def sharded_step(tables, pat_kind, pat_depth, pat_mask, tokens, *, max_levels, out, totals, overflow):
    """K8: ``T`` batch tiles against the stacked shards ``tables [S, NB,
    16]`` (patterns ``[S, P]``, padded with depth -1), written straight into
    the gathered views ``[T, S, b, K]`` (or one tile's ``[S, b, K]``). CPU
    tensors take the plain version; CUDA tensors launch the kernel once or
    raise."""
    if tokens.device.type == "cpu":
        sharded_step_plain(
            tables, pat_kind, pat_depth, pat_mask, tokens, max_levels=max_levels,
            out=out, totals=totals, overflow=overflow,
        )
        return
    kernels.sharded_match_slots(
        tables, pat_kind, pat_depth, pat_mask, tokens, max_levels, out, totals, overflow
    )


# -- K9: the tile compaction ---------------------------------------------------


def _tile_compact_one(out, totals, overflow, cap_local: int) -> torch.Tensor:
    """One gathered tile ``[S, bl, K]`` -> its row ``[2 + 2*bl +
    2*cap_local]`` (the JAX ``_tile_compact_core``, in int64)."""
    S, bl, K = out.shape
    dev = out.device
    out_t = out.permute(1, 0, 2).reshape(bl * S, K)
    t_flat = totals.t().reshape(bl * S).to(torch.int64).clamp(max=K)
    cum = torch.cumsum(t_flat, dim=0)
    offs = cum - t_flat
    n_hits = cum[-1]
    seg = segment_of_slot_plain(t_flat, offs, cap_local)
    k = torch.arange(cap_local, dtype=torch.int64, device=dev)
    slot = (k - offs[seg]).clamp(max=K - 1)
    # jnp indexing: a negative index wraps once, then clamps into range
    slot = torch.where(slot < 0, slot + K, slot).clamp(0, K - 1)
    sid = out_t[seg, slot].to(torch.int64)
    valid = k < n_hits
    header = torch.stack([n_hits, (n_hits > cap_local).to(torch.int64)])
    return torch.cat([
        header,
        totals.to(torch.int64).clamp(max=K).sum(dim=0),
        overflow.any(dim=0).to(torch.int64),
        torch.where(valid, seg % S, -1),
        torch.where(valid, sid, -1),
    ]).to(torch.int32)


def tile_compact_plain(out, totals, overflow, cap_local: int) -> torch.Tensor:
    """``T`` gathered tiles ``out [T, S, bl, K]``, ``totals [T, S, bl]``,
    ``overflow [T, S, bl]`` -> ``rows [T, 2 + 2*bl + 2*cap_local]`` =
    ``(n_hits, n_hits > cap_local | per_topic[bl] | ovf_topic[bl] |
    pair_shard[cap_local] | pair_sid[cap_local])`` per tile: the slot
    counts clamped to ``K``, segments topic-major and shard-minor, -1 past
    the tile's hits."""
    return torch.stack([_tile_compact_one(out[t], totals[t], overflow[t], cap_local) for t in range(out.shape[0])])


def tile_compact(out, totals, overflow, cap_local: int) -> torch.Tensor:
    """K9: the per-tile compaction of the gathered result. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if cap_local < 1:
        raise ValueError(f"cap_local must be >= 1, got {cap_local}")
    if out.device.type == "cpu":
        return tile_compact_plain(out, totals, overflow, cap_local)
    return kernels.tile_compact(out, totals, overflow, cap_local)


# -- device helpers ------------------------------------------------------------


def _on(device):
    """The device context a launch or event on ``device`` needs (a CUDA
    stream belongs to one device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    """One H2D copy through a pinned buffer (the CPU keeps the tensor)."""
    if device.type == "cpu":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _to_host_async(t: torch.Tensor):
    """Start the D2H copy of ``t`` into a fresh pinned buffer and record an
    event after it; a CPU tensor is already on the host."""
    if t.device.type == "cpu":
        return t, None
    with _on(t.device):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return host, event


class ShardedTorchMatcher:
    """Shards a TopicsIndex's subscriptions across the ``subs`` axis of a
    mesh and matches topic batches with one step over every position.

    The matcher subscribes to the trie's mutation stream, and
    ``rebuild()`` recompiles only the shards whose subscriptions changed;
    call :meth:`close` to detach the observer. ``rebuild()`` retries torn
    walks and quiesces the trie itself: callers must not wrap it in
    ``with topics._lock``, which would invert its rebuild-mutex -> trie-lock
    order and deadlock. With no mesh it builds one over every visible CUDA
    device (and raises when there is none). Results differ from the trie
    only where a client's matching filters span shards (module docstring).
    """

    def __init__(
        self,
        topics: TopicsIndex,
        mesh: Optional[Mesh] = None,
        max_levels: int = 8,
        out_slots: int = 64,
        window: int = 16,
        compact: bool = True,
        compact_capacity: int = 0,
        hits_estimate: float = 2.0,
        lazy: bool = False,
    ) -> None:
        self.topics = topics
        self.mesh = mesh or make_mesh()
        self.max_levels = max_levels
        self.out_slots = out_slots
        self.window = window
        self.n_shards = self.mesh.shape["subs"]
        self.n_batch = self.mesh.shape["batch"]
        # on-device compaction of the gathered result: the same knob
        # contract as TorchMatcher
        self.compact = compact
        self.compact_capacity = max(0, compact_capacity)
        # lazy SubscribersView results over the stitched (shard, sid) pair
        # stream of the compact route (False by default, as the JAX
        # package's ShardedTpuMatcher; DeltaMatcher passes its own True)
        self.lazy = lazy
        self._hits_ewma = max(1.0, float(hits_estimate))
        # sticky per-batch-bucket capacities (pick_compact_capacity)
        self._caps: dict[int, int] = {}
        self.stats = MatcherStats()
        # device pipeline profiler (tracing.DeviceProfiler) or None; the
        # same seam as TorchMatcher.profiler: the step's issue leg and
        # D2H window feed duty-cycle/overlap/idle-gap accounting
        self.profiler = None
        self._plan_mesh()
        # one (placed arrays, tables, salt) tuple swapped atomically so a
        # concurrent match never mixes generations
        self._compiled: Optional[tuple] = None
        self._built_version = -1
        # per-shard replica tries + their last compiled flat indexes +
        # dirty flags; guarded by _state_lock (held briefly — the observer
        # runs under the main trie's lock, so installs must never block)
        self._state_lock = threading.Lock()
        # serializes whole rebuilds: without it, a concurrent rebuild can
        # observe the storm path's intermediate state (fresh replicas,
        # cleared dirty flags, old compiled arrays) and stamp the stale
        # snapshot as current via the empty-dirty early return
        self._rebuild_mutex = threading.Lock()
        self._replicas: Optional[list[TopicsIndex]] = None
        self._flats: Optional[list] = None
        self._dirty = [False] * self.n_shards
        self._salt = 0
        # per-tile imbalance: cumulative hit counts, one per batch tile,
        # folded from each resolved compact batch under _tile_lock
        self._tile_lock = threading.Lock()
        self._tile_hits = np.zeros(self.n_batch, dtype=np.int64)
        self._tile_batches = 0
        # per-batch fill of each tile's compact capacity, one histogram a
        # tile, folded under _tile_lock with the hit counts
        self.tile_fill_hists = [Histogram(bounds=FILL_BOUNDS) for _ in range(self.n_batch)]
        # seconds of each shard's most recent compile, and per-shard
        # compile-time histogram SHARDS: the thread compiling shard s
        # records into shard s's own histogram, and a scrape merges them
        # (merged_shard_compile)
        self.shard_compile_seconds = [0.0] * self.n_shards
        self.shard_compile_hists = [Histogram() for _ in range(self.n_shards)]
        # the mesh step and each capacity's tile compaction under the
        # first-launch ledger's watch (ops/devicestats), named as the JAX
        # package names its jitted mesh steps
        self._step_watch = KernelWatch("sharded_step", self._mesh_step)
        self._compact_steps: dict[int, KernelWatch] = {}
        topics.add_observer(self._on_mutation)

    def _plan_mesh(self) -> None:
        """Where each tile's shards run: per tile, runs of consecutive
        shards whose positions share a device, as ``(device, s0, s1)``; the
        tile's owner (its first position) holds the gathered result."""
        grid = self.mesh.devices
        self._owner = [row[0] for row in grid]
        self._plan = []
        for row in grid:
            runs = []
            s0 = 0
            for s in range(1, self.n_shards + 1):
                if s == self.n_shards or row[s] != row[s0]:
                    runs.append((row[s0], s0, s))
                    s0 = s
            self._plan.append(runs)
        # tiles per owner, and each tile's slot in its owner's buffer
        self._tiles_of: dict = {}
        self._slot_of = []
        for t, owner in enumerate(self._owner):
            tiles = self._tiles_of.setdefault(owner, [])
            self._slot_of.append(len(tiles))
            tiles.append(t)
        # the step's launches: a run of consecutive tiles of one owner whose
        # shards all lie on it is one launch, as (owner, first tile, tiles);
        # every other tile launches per run of shards
        self._fused: list = []
        self._split: list = []
        for t, (owner, runs) in enumerate(zip(self._owner, self._plan)):
            if runs != [(owner, 0, self.n_shards)]:
                self._split.append(t)
                continue
            if self._fused:
                last_owner, t0, n = self._fused[-1]
                if last_owner == owner and t0 + n == t:
                    self._fused[-1] = (owner, t0, n + 1)
                    continue
            self._fused.append((owner, t, 1))
        self._devices = self.mesh.unique_devices()
        # the cards the step runs on, stamped onto each BatchProfile so
        # the profiler keeps one window per card (the host is device 0)
        self._device_ids = tuple(sorted({d.index or 0 for d in self._devices}))

    def tile_hit_counts(self) -> np.ndarray:
        """Cumulative per-batch-tile hit counts (a copy)."""
        with self._tile_lock:
            return self._tile_hits.copy()

    def device_skew_ratio(self) -> float:
        """max/mean per-tile cumulative hits: 1.0 = balanced mesh,
        n_batch = one hot tile, 0.0 = no traffic yet."""
        with self._tile_lock:
            hits = self._tile_hits
            mean = float(hits.mean()) if hits.size else 0.0
            if mean <= 0.0:
                return 0.0
            return float(hits.max()) / mean

    def _fold_tile_hits(self, tile_hits: np.ndarray, cap_local: int) -> None:
        """Fold one resolved batch's per-tile hit counts into the skew
        accounting and the fill histograms (called from resolvers, any
        thread)."""
        n = min(len(tile_hits), self.n_batch)
        with self._tile_lock:
            self._tile_hits[:n] += tile_hits[:n].astype(np.int64)
            self._tile_batches += 1
            if cap_local > 0:
                for t in range(n):
                    self.tile_fill_hists[t].observe(float(tile_hits[t]) / cap_local)

    def merged_shard_compile(self) -> Histogram:
        """One merged snapshot of the per-shard compile-time histogram
        shards (a scrape-time callback for a ``MetricsRegistry``)."""
        merged = Histogram()
        for h in self.shard_compile_hists:
            merged.merge(h)
        return merged

    def close(self) -> None:
        """Detach from the trie's mutation stream."""
        self.topics.remove_observer(self._on_mutation)

    # -- delta stream --------------------------------------------------------

    def _on_mutation(self, m: Mutation) -> None:
        """Apply one trie mutation to the owning shard's replica and mark it
        dirty. Called under the main trie's lock — must stay fast and must
        never raise into the broker's subscribe path."""
        with self._state_lock:
            reps = self._replicas
            if reps is None:
                return  # first full build will capture current state
            s = shard_of(m.kind, m.client, m.filter, m.identifier, self.n_shards)
            try:
                rep = reps[s]
                if m.kind == "inline":
                    if m.op == "add":
                        rep.inline_subscribe(m.subscription)
                    else:
                        rep.inline_unsubscribe(m.identifier, m.filter)
                else:
                    if m.op == "add":
                        rep.subscribe(m.client, m.subscription)
                    else:
                        rep.unsubscribe(m.filter, m.client)
                self._dirty[s] = True
            except Exception:
                _log.exception("shard replica update failed; forcing full rebuild")
                self._replicas = None

    # -- build -------------------------------------------------------------

    def rebuild(self) -> None:
        """Bring the compiled index up to date.

        Full path (first build, or after a replica fault): walk the live
        trie, partition by stable hash into fresh replicas, compile all
        shards. Incremental path: recompile only dirty shards' replicas and
        restack — cost bounded by the dirty shards, not the index.

        The observer's fault path can null the replicas mid-compile; each
        attempt would then fold nothing, so retry a bounded number of
        times instead of recursing unboundedly under a persistent fault."""
        t0 = time.perf_counter()
        with self._rebuild_mutex:
            # the except runs INSIDE the mutex: re-marking dirty after
            # release would leave a gap where a concurrent rebuild sees
            # empty dirty flags and stamps the stale snapshot as current
            try:
                for _attempt in range(4):
                    if self._replicas is None:
                        done = self._full_rebuild()
                    else:
                        done = self._incremental_rebuild()
                    if done:
                        break
                else:
                    raise RuntimeError(
                        "rebuild could not complete: persistent replica faults"
                    )
            except BaseException:
                # a rebuild that dies after clearing dirty flags (a failed
                # device copy in _assemble) must not let the next rebuild's
                # empty-dirty early return pass off the stale snapshot as
                # current — over-mark everything dirty instead
                with self._state_lock:
                    self._dirty = [True] * self.n_shards
                raise
        self.stats.rebuilds += 1
        self.stats.note_rebuild(time.perf_counter() - t0)

    def _partition_live(self) -> list[TopicsIndex]:
        """Walk the live trie and split its subscriptions into fresh
        per-shard replicas. Concurrent structural mutations can tear the
        walk (RuntimeError/KeyError from dict iteration) — callers retry."""
        replicas = [TopicsIndex() for _ in range(self.n_shards)]
        for _path, node in _walk_terminals(self.topics):
            for client, sub in node.subscriptions.get_all().items():
                s = shard_of(KIND_CLIENT, client, sub.filter, 0, self.n_shards)
                replicas[s].subscribe(client, sub)
            for group in node.shared.get_all().values():
                for client, sub in group.items():
                    s = shard_of(KIND_SHARED, client, sub.filter, 0, self.n_shards)
                    replicas[s].subscribe(client, sub)
            for isub in node.inline_subscriptions.get_all().values():
                s = shard_of(KIND_INLINE, "", isub.filter, isub.identifier, self.n_shards)
                replicas[s].inline_subscribe(isub)
        return replicas

    def _full_rebuild(self) -> bool:
        for _attempt in range(8):
            v0 = self.topics.version
            try:
                replicas = self._partition_live()
            except (RuntimeError, KeyError):
                continue  # concurrent mutation tore the walk; retry
            flats = self._compile_all(replicas)
            if self.topics.version != v0:
                continue  # doomed: skip the H2D copy, retry the walk
            # device placement happens OUTSIDE _state_lock: the observer
            # runs under the broker trie's lock and blocks on _state_lock,
            # so holding it across an H2D copy would stall every subscribe
            compiled = self._assemble(flats)
            with self._state_lock:
                if self.topics.version == v0:
                    self._replicas = replicas
                    self._flats = flats
                    self._dirty = [False] * self.n_shards
                    self._salt = flats[0].salt
                    self._compiled = compiled
                    self._built_version = v0
                    return True
            # a mutation landed while we walked: the fresh replicas may miss
            # it (the observer was still feeding the OLD replicas) — retry
        # mutation storm: quiesce the trie ONLY long enough to walk it and
        # swap fresh replicas in (pure host work, no device copies) —
        # subscribes resume while we compile; every mutation from the swap
        # onward feeds the new replicas and marks its shard dirty, and
        # _built_version = v0 keeps `stale` true until they are folded
        with self.topics._lock:
            v0 = self.topics.version
            replicas = self._partition_live()
            with self._state_lock:
                self._replicas = replicas
                self._dirty = [False] * self.n_shards
        flats = self._compile_all(replicas, retry_tears=True)
        compiled = self._assemble(flats)
        with self._state_lock:
            fault = self._replicas is not replicas
            if not fault:
                self._flats = flats
                self._salt = flats[0].salt
                self._compiled = compiled
                self._built_version = v0
        # on fault the observer nulled the replicas mid-compile; returning
        # success would report a rebuild that folded nothing (DeltaMatcher
        # would drop its overlay) — the caller retries, boundedly
        return not fault

    def _incremental_rebuild(self) -> bool:
        # read the version under the trie lock: the trie bumps it BEFORE
        # notifying observers, so a bare read could adopt a version whose
        # mutation hasn't marked its shard dirty yet — stamping that
        # version as built would hide the unfolded shard from `stale`.
        # Holding the trie lock waits out any in-flight notify.
        with self.topics._lock:
            version = self.topics.version
        with self._state_lock:
            # snapshot under the lock: the observer's exception path sets
            # _replicas = None concurrently
            replicas = self._replicas
            if replicas is None or self._flats is None:
                replicas = None  # fall through to a full rebuild below
            else:
                dirty = [s for s in range(self.n_shards) if self._dirty[s]]
                # clear BEFORE compiling: a mutation racing the compile
                # re-marks the shard, so it is recompiled next round even
                # if this walk already included it
                for s in dirty:
                    self._dirty[s] = False
                flats = list(self._flats)
                if not dirty and self._compiled is not None:
                    # nothing to fold: stamp INSIDE the lock — outside it, a
                    # mutation between the dirty check and the stamp could
                    # publish a version whose shard was never folded
                    self._built_version = version
                    return True
        if replicas is None:
            return self._full_rebuild()
        for s in dirty:
            # compile at the generation's bucket count up front: defaulting
            # to the minimum would make _unify recompile the shard again
            flats[s] = self._compile_shard(s, replicas, min_buckets=flats[s].table.shape[0])
        flats = self._unify(flats, replicas)
        compiled = self._assemble(flats)
        with self._state_lock:
            fault = self._replicas is not replicas
            if not fault:
                self._flats = flats
                self._salt = flats[0].salt
                self._compiled = compiled
                self._built_version = version
        # on fault: see _full_rebuild — the caller retries, boundedly
        return not fault

    def _compile_shard(
        self,
        s: int,
        replicas,
        salt: Optional[int] = None,
        min_buckets: int = 1024,
        retry_tears: bool = True,
    ):
        t0 = time.perf_counter()
        try:
            return self._compile_shard_inner(s, replicas, salt, min_buckets, retry_tears)
        finally:
            # shard-local: only the thread compiling shard s writes here
            dt = time.perf_counter() - t0
            self.shard_compile_seconds[s] = dt
            self.shard_compile_hists[s].observe(dt)

    def _compile_shard_inner(
        self,
        s: int,
        replicas,
        salt: Optional[int] = None,
        min_buckets: int = 1024,
        retry_tears: bool = True,
    ):
        rep = replicas[s]
        salt = self._salt if salt is None else salt

        def build():
            return build_flat_index(
                rep, max_levels=self.max_levels, salt=salt, window=self.window,
                min_buckets=min_buckets,
            )

        if retry_tears:
            for _ in range(8):
                try:
                    return build()
                except (RuntimeError, KeyError):
                    continue  # replica mutated mid-walk; retry
            with rep._lock:  # mutation storm on this shard: build quiesced
                return build()
        # fresh, unpublished replicas can't tear: no retry wrapper
        return build()

    def _compile_all(self, replicas: list[TopicsIndex], retry_tears: bool = False):
        """Compile every shard at a uniform salt and bucket count. With
        ``retry_tears`` the per-shard compile retries walks torn by
        concurrent replica mutations (live replicas); without it a tear
        propagates to the caller (fresh, unpublished replicas can't tear)."""

        def compile_one(s: int, salt: int, min_buckets: int = 1024):
            return self._compile_shard(
                s, replicas, salt=salt, min_buckets=min_buckets, retry_tears=retry_tears,
            )

        flats = [compile_one(s, self._salt) for s in range(len(replicas))]
        return self._unify(flats, replicas, compile_one)

    def _unify(self, flats, replicas, compile_one: Optional[Callable] = None):
        """Recompile shards until all

        - agree on the hash salt (topics tokenize at ONE salt: serving
          mixed-salt shards would silently drop subscribers), and
        - agree on the bucket count (the stacked table is one array; each
          shard's ``slot = h1 & (NB-1)`` must use the stacked NB).
        """
        if compile_one is None:

            def compile_one(s, salt, min_buckets=1024):
                return self._compile_shard(s, replicas, salt=salt, min_buckets=min_buckets)

        for _ in range(8):
            salts = {f.salt for f in flats}
            sizes = {f.table.shape[0] for f in flats}
            if len(salts) == 1 and len(sizes) == 1:
                return flats
            salt = max(salts)
            NB = max(sizes)
            flats = [
                f
                if f.salt == salt and f.table.shape[0] == NB
                else compile_one(s, salt, min_buckets=NB)
                for s, f in enumerate(flats)
            ]
        if len({(f.salt, f.table.shape[0]) for f in flats}) == 1:
            return flats
        raise RuntimeError("shard salt/size unification failed")

    def _assemble(self, flats) -> tuple:
        """Stack the per-shard flat indexes and place each tile's runs of
        shards on their devices; return the compiled generation (the caller
        swaps it in under _state_lock — placement itself happens lock-free).
        Pattern rows are power-of-two bucketed, and the padding is inert:
        pad patterns have depth -1 (never active)."""

        def stack(get, fill, min_len=2):
            arrs = [np.asarray(get(f)) for f in flats]
            n = _bucket(max(min_len, max(len(a) for a in arrs)), minimum=min_len)
            return np.stack([_pad_to(a, n, fill) for a in arrs])

        # table bucket counts are unified by _unify; stack directly
        host = (
            np.stack([f.table for f in flats]),
            stack(lambda f: f.pat_kind, fill=np.uint32(0)),
            stack(lambda f: f.pat_depth, fill=np.int32(-1)),
            stack(lambda f: f.pat_mask, fill=np.uint32(0)),
        )
        placed: dict = {}
        for runs in self._plan:
            for dev, s0, s1 in runs:
                if (dev, s0, s1) not in placed:
                    placed[(dev, s0, s1)] = tuple(device_i32(a[s0:s1], dev) for a in host)
        tables = [f.subs for f in flats]
        return (placed, tables, flats[0].salt)

    @property
    def stale(self) -> bool:
        return self._compiled is None or self._built_version != self.topics.version

    # -- matching ----------------------------------------------------------

    def _mesh_step(self, host_tokens: torch.Tensor, placed, tokens_on: dict) -> dict:
        """``_step`` over the batch ``host_tokens`` (its copies on each
        device in ``tokens_on``): the callable the ledger watches, keyed
        by the batch's shape."""
        return self._step(placed, tokens_on, host_tokens.shape[0] // self.n_batch)

    def _step(self, placed, tokens_on: dict, bl: int) -> dict:
        """K8 over every tile: per owner device, the gathered ``(out [n, S,
        bl, K], totals [n, S, bl], overflow [n, S, bl])`` of its ``n``
        tiles. Consecutive tiles whose shards all lie on their owner's
        device are one launch, written straight into the gathered views (on
        one card: one launch per step); a run of shards on another device
        writes there and is copied to the owner."""
        S, K = self.n_shards, self.out_slots
        gathered = {}
        for owner, tiles in self._tiles_of.items():
            n = len(tiles)
            gathered[owner] = (
                torch.empty((n, S, bl, K), dtype=torch.int32, device=owner),
                torch.empty((n, S, bl), dtype=torch.int32, device=owner),
                torch.empty((n, S, bl), dtype=torch.bool, device=owner),
            )
        for owner, t0, n in self._fused:
            j0 = self._slot_of[t0]
            g_out, g_tot, g_ovf = (a[j0 : j0 + n] for a in gathered[owner])
            with _on(owner):
                sharded_step(
                    *placed[(owner, 0, S)], tokens_on[owner][t0 * bl : (t0 + n) * bl],
                    max_levels=self.max_levels, out=g_out, totals=g_tot, overflow=g_ovf,
                )
        for t in self._split:
            runs = self._plan[t]
            owner = self._owner[t]
            j = self._slot_of[t]
            g_out, g_tot, g_ovf = (a[j] for a in gathered[owner])
            for dev, s0, s1 in runs:
                arrays = placed[(dev, s0, s1)]
                toks = tokens_on[dev][t * bl : (t + 1) * bl]
                if dev == owner:
                    with _on(dev):
                        sharded_step(
                            *arrays, toks, max_levels=self.max_levels,
                            out=g_out[s0:s1], totals=g_tot[s0:s1], overflow=g_ovf[s0:s1],
                        )
                    continue
                n = s1 - s0
                part = (
                    torch.empty((n, bl, K), dtype=torch.int32, device=dev),
                    torch.empty((n, bl), dtype=torch.int32, device=dev),
                    torch.empty((n, bl), dtype=torch.bool, device=dev),
                )
                with _on(dev):
                    sharded_step(
                        *arrays, toks, max_levels=self.max_levels,
                        out=part[0], totals=part[1], overflow=part[2],
                    )
                # the union over the subs axis across cards: a device copy
                # into the owner's gathered views
                for dst, src in zip((g_out[s0:s1], g_tot[s0:s1], g_ovf[s0:s1]), part):
                    dst.copy_(src, non_blocking=True)
        return gathered

    def _compact_step(self, cap_local: int) -> KernelWatch:
        """K9 at one local capacity under its own watch: each capacity is
        a kernel name of the ledger, so a capacity that changes batch after
        batch shows as a steady stream of first launches."""
        step = self._compact_steps.get(cap_local)
        if step is None:
            step = self._compact_steps.setdefault(
                cap_local, KernelWatch(f"sharded_tile_compact_c{cap_local}", tile_compact)
            )
        return step

    def match_topics_async(self, topics: list[str], route_to_host=None, profile=None):
        """Issue one step over the mesh and return a zero-arg resolver.

        Mirrors ``TorchMatcher.match_topics_async``: tokenize, one H2D copy
        per device, K8 on every tile, K9 on every owner's tiles and the
        start of the D2H copy of the compacted rows, all asynchronous. The
        resolver waits on the copies, then materializes
        ``list[Subscribers]`` on the host. ``route_to_host`` forces extra
        topics onto the host walk: a ``topic -> bool`` predicate or an
        object with ``affected``/``affected_batch`` (the delta overlay).
        ``profile`` is the caller's per-batch ``tracing.BatchProfile``, as
        for ``TorchMatcher``: with a profiler attached, the issue leg and
        the D2H window are stamped on it for every card of the mesh."""
        if self._compiled is None or self.stale:
            self.rebuild()
        placed, tables, salt = self._compiled
        prof = self.profiler
        rec = None
        if prof is not None:
            rec = profile if profile is not None else prof.open_batch()
            t_issue0 = time.perf_counter()
        b = len(topics)
        # pad ragged batches to a power-of-two bucket, rounded up to a
        # multiple of the batch axis for even tiles
        target = _bucket(max(1, b), minimum=max(2, self.n_batch))
        target += (-target) % self.n_batch
        padded = topics + [""] * (target - b)
        tok1, tok2, lengths, is_dollar, len_overflow = tokenize_topics(
            padded, self.max_levels, salt
        )
        host_tokens = torch.from_numpy(pack_tokens(tok1, tok2, lengths, is_dollar))
        tokens_on = {dev: _to_device(host_tokens, dev) for dev in self._devices}
        bp = len(padded)
        bl = bp // self.n_batch
        gathered = self._step_watch(host_tokens, placed, tokens_on)
        cap_local = 0
        rows_host: dict = {}
        full_host: dict = {}
        if self.compact:
            # compact each gathered tile ON DEVICE before any copy: the
            # [S, bl, K] slot buffer collapses to a (shard, sid) pair
            # stream sized for the hits that exist
            cap_local = max(16, self._compact_capacity_for(bp) // self.n_batch)
            compact = self._compact_step(cap_local)
            for owner, arrays in gathered.items():
                with _on(owner):
                    rows_host[owner] = _to_host_async(compact(*arrays, cap_local))
        else:
            for owner, arrays in gathered.items():
                full_host[owner] = tuple(_to_host_async(a) for a in arrays)
        if prof is not None:
            # the issue leg ends here; every card of the mesh took part in
            # the step, so each card's window gets this batch
            rec.devices = self._device_ids
            prof.note_dispatch(rec, t_issue0, time.perf_counter())
        if route_to_host is None:
            pred = batch_pred = None
        elif hasattr(route_to_host, "affected_batch"):
            pred = route_to_host.affected
            batch_pred = route_to_host.affected_batch
        else:
            pred = route_to_host
            batch_pred = None
        S, K = self.n_shards, self.out_slots
        # the pre-compaction transfer geometry: the full gathered slot buffer
        bytes_padded = S * bp * K * 4

        def routed_indices() -> list:
            if batch_pred is not None:
                return batch_pred(topics)
            if pred is not None:
                return [i for i, t in enumerate(topics) if t and pred(t)]
            return []

        def resolve_full(t_sync0: float) -> list[Subscribers]:
            # the gathered slot buffers, tile by tile into [S, bp, K]
            out = np.empty((S, bp, K), dtype=np.int32)
            ovf = np.empty((S, bp), dtype=bool)
            for owner, tiles in self._tiles_of.items():
                if owner in full_host:
                    parts = []
                    for host, event in full_host[owner]:
                        if event is not None:
                            event.synchronize()
                        parts.append(host.numpy())
                    g_out, _g_tot, g_ovf = parts
                else:
                    g_out = gathered[owner][0].cpu().numpy()
                    g_ovf = gathered[owner][2].cpu().numpy()
                for j, t in enumerate(tiles):
                    out[:, t * bl : (t + 1) * bl] = g_out[j]
                    ovf[:, t * bl : (t + 1) * bl] = g_ovf[j]
            overflow = (ovf.any(axis=0) | len_overflow).tolist()
            stats = self.stats
            stats.add(d2h_bytes=int(out.nbytes))
            if prof is not None:
                # every copy has landed: close the device window
                rec.d2h_bytes += int(out.nbytes)
                rec.d2h_bytes_ranges += int(out.nbytes)
                rec.d2h_bytes_dense += bytes_padded
                prof.note_resolve(rec, t_sync0, time.perf_counter())
            routed = frozenset(routed_indices())
            rows = np.transpose(out[:, :b], (1, 0, 2)).tolist()
            modes = ns_modes(topics)
            acc = _accel()  # once per batch, not per topic
            results = []
            n_host = n_ovf = 0
            for i, topic in enumerate(topics):
                if not topic:
                    results.append(Subscribers())
                elif overflow[i] or i in routed:
                    n_host += 1
                    n_ovf += int(overflow[i])
                    results.append(self.topics.subscribers(topic))
                else:
                    results.append(self._expand(tables, rows[i], 0 if modes is None else int(modes[i]), acc))
            stats.add(host_fallbacks=n_host, overflows=n_ovf)
            return results

        if not self.compact:

            def resolve() -> list[Subscribers]:
                t_sync0 = time.perf_counter() if prof is not None else 0.0
                self.stats.add(batches=1, topics=b)
                return resolve_full(t_sync0)

            return resolve

        def resolve_compact() -> list[Subscribers]:
            t_sync0 = time.perf_counter() if prof is not None else 0.0
            # [n_batch, 2 + 2*bl + 2*cap_local]: one compacted row per tile
            rows = np.empty((self.n_batch, 2 + 2 * bl + 2 * cap_local), dtype=np.int32)
            for owner, tiles in self._tiles_of.items():
                host, event = rows_host[owner]
                if event is not None:
                    event.synchronize()
                rows[tiles] = host.numpy()
            stats = self.stats
            n_hits = int(rows[:, 0].sum())
            batch_ovf = bool(rows[:, 1].any())
            self._observe_hits(n_hits, b)
            # every resolved batch, the overflow fallback included (its tile
            # counts are true hit counts), feeds the skew accounting
            self._fold_tile_hits(rows[:, 0], cap_local)
            if batch_ovf:
                # a tile outgrew its pair buffer: THIS batch copies the
                # gathered slot buffers (still resident) instead; both
                # copies count (resolve_full adds the gather's bytes)
                stats.add(batches=1, topics=b, d2h_bytes=int(rows.nbytes), compact_overflows=1)
                self._hits_ewma = max(self._hits_ewma, n_hits / max(1, b))
                if rec is not None:
                    rec.compact = True
                    rec.compact_overflow = True
                    rec.d2h_bytes = int(rows.nbytes)
                return resolve_full(t_sync0)
            if prof is not None:
                rec.d2h_bytes = int(rows.nbytes)
                rec.d2h_bytes_ranges = bytes_padded
                rec.d2h_bytes_dense = bytes_padded
                rec.compact = True
                prof.note_resolve(rec, t_sync0, time.perf_counter())
            stats.add(batches=1, topics=b, d2h_bytes=int(rows.nbytes), compact_batches=1)
            # stitch the per-tile streams back into one topic-major batch
            per_topic = rows[:, 2 : 2 + bl].reshape(bp)
            true_overflow = rows[:, 2 + bl : 2 + 2 * bl].reshape(bp).astype(bool) | len_overflow
            tile_hits = rows[:, 0]
            lo = 2 + 2 * bl
            pair_shard = np.concatenate([rows[t, lo : lo + tile_hits[t]] for t in range(self.n_batch)])
            pair_sid = np.concatenate(
                [rows[t, lo + cap_local : lo + cap_local + tile_hits[t]] for t in range(self.n_batch)]
            )
            host_route = true_overflow.copy()
            routed = routed_indices()
            if len(routed):
                host_route[np.asarray(routed, dtype=np.int64)] = True
            return materialize_compact_pairs(
                stats, self.topics.subscribers, pair_sid, per_topic, host_route, n_hits,
                topics, None, true_overflow, pair_shard=pair_shard, tables=tables,
                lazy=self.lazy,
            )

        return resolve_compact

    def _compact_capacity_for(self, b_padded: int) -> int:
        """Pair-buffer capacity for one gathered batch (the shared
        pick_compact_capacity policy), capped at the slot-buffer bound
        the gather could actually fill."""
        max_hits = b_padded * self.n_shards * self.out_slots
        return pick_compact_capacity(
            self.compact_capacity, self._hits_ewma, b_padded, max_hits, self._caps,
        )

    def _observe_hits(self, n_hits: int, b: int) -> None:
        self._hits_ewma = fold_hits_ewma(self._hits_ewma, n_hits, b)

    def match_topics(self, topics: list[str], route_to_host=None) -> list[Subscribers]:
        """Match a batch of topics (overflowing topics are re-walked on
        the host trie)."""
        return self.match_topics_async(topics, route_to_host)()

    def subscribers(self, topic: str) -> Subscribers:
        return self.match_topics([topic])[0]

    def _expand(self, tables, shard_sids: list, mode: int, acc) -> Subscribers:
        """Union per-shard local sub ids (one list per shard) into one
        Subscribers set through the C materializer ``acc`` (``expand_sids``
        shard by shard is its plain version); ``mode`` is the topic's
        ``ns_guard_mode``. The slot route (compact off, or a batch whose
        hits outgrew the pair buffer) is eager, as in the JAX package."""
        subs = Subscribers()
        for s in range(self.n_shards):
            acc.expand_sids_list(shard_sids[s], tables[s].snaps, tables[s].window, subs, mode)
        return subs


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Lay a mesh of ``n_devices`` positions on ``device``, run one full
    sharded step (batch tiles x subscription shards, gathered per tile) and
    the ``DeltaMatcher(mesh=...)`` fold on a tiny corpus, and check every
    result against the host trie. Raises on any mismatch, and where
    ``device`` is ``"cuda"`` and there is no card."""
    from ..packets import Subscription

    mesh = make_mesh([device] * n_devices)
    index = TopicsIndex()
    filters = ["a/b/c", "a/+/c", "a/#", "d/e", "+/e", "x/y/z", "q/+/+", "#"]
    for i, flt in enumerate(filters * 4):
        index.subscribe(f"cl{i}", Subscription(filter=flt, qos=i % 3))
    topics = ["a/b/c", "d/e", "x/y/z", "q/w/e", "nope", "a/z/c", "e", "a/b"]

    def check(match) -> None:
        for topic in topics:
            got = match(topic)
            want = index.subscribers(topic)
            if set(got.subscriptions) != set(want.subscriptions):
                raise AssertionError(
                    f"{topic}: {sorted(got.subscriptions)} != {sorted(want.subscriptions)}"
                )

    matcher = ShardedTorchMatcher(index, mesh=mesh, max_levels=4, out_slots=32)
    try:
        results = matcher.match_topics(topics)
        check(lambda t: results[topics.index(t)])
        # the incremental path: each mutation dirties one shard, and the
        # rebuilt step still equals the trie
        index.subscribe("late", Subscription(filter="a/b/c", qos=1))
        index.unsubscribe("d/e", "cl3")
        check(matcher.subscribers)
    finally:
        matcher.close()
    # the live-broker configuration: DeltaMatcher folding trie churn over a
    # mesh-sharded snapshot
    from ..ops.delta import DeltaMatcher

    dm = DeltaMatcher(index, mesh=mesh, max_levels=4, background=False)
    try:
        index.subscribe("churn", Subscription(filter="a/+/c", qos=1))
        check(dm.subscribers)  # overlay: churned topics host-route
        dm.flush()  # fold the overlay into a fresh per-shard snapshot
        if dm.pending_deltas != 0:
            raise AssertionError("the flush left deltas pending")
        check(dm.subscribers)
    finally:
        dm.close()


class ShardedSnapshot(ShardedTorchMatcher):
    """The snapshot ``DeltaMatcher(mesh=...)`` serves: never stale, since
    the delta overlay host-routes every topic a pending mutation may
    affect."""

    stale = False
