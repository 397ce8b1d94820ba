"""Delta-staged device matcher: serve from a frozen snapshot while the trie
churns, stay bit-identical, rebuild in the background.

A full rebuild is seconds at 1M subscriptions, which no live broker can
afford on every SUBSCRIBE. So:

- The device keeps serving the last compiled snapshot.
- Every trie mutation (via ``TopicsIndex.add_observer``) records the mutated
  filter in a host-side *delta overlay*: an append log plus a mini-trie of
  just the mutated filters. Client/shared mutations are recorded as client
  subscriptions and inline mutations as inline subscriptions, so the
  overlay applies the same $-topic exclusion rules [MQTT-4.7.1-1/2] as the
  real walk.
- Per matched topic, the mini-trie answers "could any mutation since the
  snapshot affect this topic's subscriber set?" — a topic that matches no
  delta filter has an identical subscriber set in the snapshot and the
  live trie, so the device result is served; affected topics re-walk the
  live host trie. Results are therefore bit-identical to
  ``TopicsIndex.subscribers`` at every instant, at any rebuild cadence.
- A background thread folds the overlay into the snapshot (an incremental
  ``TorchMatcher.fold`` — one ``scatter_rows`` launch — or a full rebuild;
  over a mesh, the sharded snapshot's rebuild of the dirty shards)
  when the overlay grows past ``rebuild_after`` filters, every
  ``rebuild_interval`` seconds while it is non-empty, or on demand via
  :meth:`flush`; the overlay generation swaps atomically and carries over
  only the mutations that arrived while the fold ran.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Optional

from ..packets import Subscription
from ..topics import InlineSubscription, Mutation, Subscribers, TopicsIndex
from .kernels import KernelError
from .matcher import TorchMatcher

_DELTA_CLIENT = "\x00delta"  # mini-trie marker client; never a real client id
_log = logging.getLogger("mqtt_tpu_torch.ops.delta")


def _noop_handler(*_a) -> None:  # pragma: no cover - marker, never invoked
    pass


class _Snapshot(TorchMatcher):
    """A TorchMatcher that never self-rebuilds: the delta overlay makes
    serving a stale snapshot safe, so staleness is frozen off."""

    @property
    def stale(self) -> bool:  # noqa: D401 - see class docstring
        return False


class _Gen:
    """One snapshot generation: the compiled device index plus the overlay
    of filters mutated since its build started."""

    __slots__ = ("snap", "delta_trie", "deltas", "seen")

    def __init__(self, snap: _Snapshot, deltas: list[tuple[str, str]]) -> None:
        self.snap = snap
        self.delta_trie = TopicsIndex()
        self.deltas: list[tuple[str, str]] = []
        self.seen: set[tuple[str, str]] = set()
        for f, kind in deltas:
            self.record(f, kind)

    def record(self, filter: str, kind: str) -> None:
        key = (filter, kind)
        self.deltas.append(key)
        if key in self.seen:
            return
        self.seen.add(key)
        if filter:
            if kind == "inline":
                # inline markers follow inline gather rules (no $-exclusion)
                self.delta_trie.inline_subscribe(
                    InlineSubscription(filter=filter, identifier=1, handler=_noop_handler)
                )
            else:
                self.delta_trie.subscribe(_DELTA_CLIENT, Subscription(filter=filter))

    def affected(self, topic: str) -> bool:
        """True when some mutation since the snapshot may change ``topic``'s
        subscriber set."""
        if not self.deltas:
            return False
        s = self.delta_trie.subscribers(topic)
        return bool(s.subscriptions or s.shared or s.inline_subscriptions)

    def affected_batch(self, topics: list[str]) -> list[int]:
        """Indices of topics the overlay may affect (empty, and no per-topic
        work, when no mutations are pending)."""
        if not self.deltas:
            return []
        affected = self.affected
        return [i for i, t in enumerate(topics) if t and affected(t)]


class DeltaMatcher:
    """Drop-in for ``TopicsIndex.subscribers`` that serves device matches
    from a snapshot + host delta overlay and rebuilds off the hot path.

    Parameters
    ----------
    rebuild_after:
        Overlay size (mutation events) that triggers an immediate background
        fold. The overlay stays correct at any size — this only tunes how
        much traffic takes the slower host path.
    rebuild_interval:
        The background thread additionally folds a NON-empty overlay every
        this many seconds, so a quiet broker drains its overlay.
    background:
        When True (default), folds run on a daemon thread; when False, call
        :meth:`flush` to fold synchronously (tests, benchmarks).
    device:
        Where the snapshot's index lives and its kernels run (``"cuda"`` by
        default; ``"cpu"`` runs the plain PyTorch versions). Unused with a
        mesh: the mesh names the devices.
    mesh:
        When given (``parallel.make_mesh``), the snapshot is a
        mesh-sharded matcher (``parallel.ShardedTorchMatcher``) whose
        rebuild recompiles only the shards touched since the last fold.
        Its results differ from the trie in one known way, kept from the
        JAX package and to be fixed in both: a client whose matching
        filters lie in different shards gets the first shard's
        subscription fields (filter, MQTT 5 subscription identifier,
        retain flags) where the trie keeps the walk's first. Who is
        delivered, and at which QoS, is the trie's.
    """

    def __init__(
        self,
        topics: TopicsIndex,
        max_levels: int = 8,
        rebuild_after: int = 1024,
        rebuild_interval: float = 1.0,
        background: bool = True,
        window: int = 16,
        compact: bool = True,
        compact_capacity: int = 0,
        hits_estimate: float = 2.0,
        device="cuda",
        mesh=None,
        out_slots: int = 64,
        lazy: bool = True,
    ) -> None:
        self.topics = topics
        self.max_levels = max_levels
        self.window = window
        self.rebuild_after = rebuild_after
        self.rebuild_interval = rebuild_interval
        self.background = background
        self._lock = threading.Lock()  # guards generation swap + delta append
        self._rebuild_lock = threading.Lock()  # one rebuild at a time
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # a kernel failure in a background fold; the next match raises it
        self._kernel_error: Optional[KernelError] = None
        # ONE snapshot matcher reused across generations: both kinds swap
        # their compiled state atomically
        self._sharded = mesh is not None
        if self._sharded:
            # imported here: ``parallel.sharded`` imports this package
            from ..parallel.sharded import ShardedSnapshot

            snap = ShardedSnapshot(
                topics,
                mesh=mesh,
                max_levels=max_levels,
                out_slots=out_slots,
                window=window,
                compact=compact,
                compact_capacity=compact_capacity,
                hits_estimate=hits_estimate,
                lazy=lazy,
            )
        else:
            snap = _Snapshot(
                topics,
                max_levels,
                window=window,
                # background rebuilds must not starve the serving thread's
                # match latency for the build duration
                cooperative=background,
                compact=compact,
                compact_capacity=compact_capacity,
                hits_estimate=hits_estimate,
                device=device,
                lazy=lazy,
            )
        try:
            snap.rebuild()
        except BaseException:
            if self._sharded:
                snap.close()  # detach the sharded snapshot's observer
            raise
        self._snap = snap
        self._gen = _Gen(snap, [])
        topics.add_observer(self._on_mutation)
        if background:
            self._thread = threading.Thread(
                target=self._rebuild_loop, name="mqtt-torch-index-rebuild", daemon=True
            )
            self._thread.start()

    @property
    def stats(self):
        """The underlying matcher's observability counters."""
        return self._snap.stats

    @property
    def snapshot(self):
        """The snapshot matcher: a ``TorchMatcher`` (its ``index`` and
        ``device_arrays`` are the compiled index the device serves) or,
        over a mesh, a ``ShardedTorchMatcher``."""
        return self._snap

    # -- delta stream --------------------------------------------------------

    def _on_mutation(self, m: Mutation) -> None:
        with self._lock:
            gen = self._gen
            gen.record(m.filter, m.kind)
            pending = len(gen.deltas)
        if pending >= self.rebuild_after:
            self._wake.set()

    @property
    def pending_deltas(self) -> int:
        with self._lock:
            return len(self._gen.deltas)

    # -- rebuild -------------------------------------------------------------

    def _rebuild_snapshot(self, filters=None) -> None:
        """Fold the live trie into the snapshot without holding its lock;
        concurrent structural mutations can tear the walk (RuntimeError from
        a mutated dict iteration, KeyError from a node inserted mid-walk),
        in which case retry — every mutation racing the walk is in the delta
        overlay, so a successful walk is always safe to serve.

        When the pending mutations' filter set is known, the snapshot first
        attempts an incremental fold (TorchMatcher.fold): per-bucket edits
        plus a device row scatter instead of a full rebuild + table upload.
        The sharded snapshot has no fold: its rebuild recompiles the dirty
        shards and retries torn walks itself."""
        if self._sharded:
            # its rebuild takes its rebuild mutex BEFORE the trie lock, so
            # wrapping it in `with self.topics._lock` here would invert
            # that order and deadlock against a concurrent rebuild
            self._snap.rebuild()
            return
        if filters is not None and self._snap.fold(filters):
            return
        for _ in range(8):
            try:
                self._snap.rebuild()
                return
            except (RuntimeError, KeyError):
                continue
        with self.topics._lock:  # mutation storm: build quiesced
            self._snap.rebuild()

    def _rebuild_once(self) -> None:
        with self._rebuild_lock:
            with self._lock:
                old = self._gen
                k = len(old.deltas)
            if k == 0:
                return
            self._rebuild_snapshot(filters={f for f, _ in old.deltas[:k]})
            with self._lock:
                # mutations that raced the walk (appended after index k)
                # might be missing from the new snapshot: carry them over
                self._gen = _Gen(self._snap, old.deltas[k:])

    def flush(self) -> None:
        """Synchronously fold all pending deltas into a fresh snapshot."""
        self._rebuild_once()

    @contextlib.contextmanager
    def held(self):
        """Hold every fold until the block ends, then wake the fold: a
        bulk load (the durable restore) folds once, instead of rebuilding
        the growing trie each time the overlay passes ``rebuild_after``.
        Matches stay exact meanwhile (the overlay routes the held
        mutations' topics to the host walk). Not reentrant, and
        :meth:`flush` inside the block deadlocks."""
        with self._rebuild_lock:
            yield
        self._wake.set()

    def _rebuild_loop(self) -> None:
        while not self._stop.is_set():
            # wake on overflow OR on the interval tick, so a quiet overlay
            # still drains (count threshold alone could starve forever)
            self._wake.wait(timeout=self.rebuild_interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._rebuild_once()
            except KernelError as e:
                # a retry cannot mend a kernel that fails to build or
                # launch, and the overlay would serve ever more topics
                # from the host: stop folding and fail the next match
                _log.exception("background fold: kernel failed")
                self._kernel_error = e
                return
            except Exception:
                # never let the rebuild thread die: a degraded matcher keeps
                # serving (host path for the overlay), a dead one degrades
                # forever
                _log.exception("background index rebuild failed; will retry")
                self._stop.wait(1.0)
                self._wake.set()

    def close(self) -> None:
        self.topics.remove_observer(self._on_mutation)
        if self._sharded:
            self._snap.close()  # detach the sharded snapshot's own observer
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- matching ------------------------------------------------------------

    def match_topics_async(self, topics: list[str], profile=None):
        """Issue one batch; the returned resolver yields the results. The
        generation (snapshot + overlay) is captured at issue time; the
        generation object itself is the route-to-host authority.
        ``profile`` is the caller's per-batch ``tracing.BatchProfile``,
        stamped by the snapshot when a profiler is attached to it. Raises
        the ``KernelError`` of a failed background fold."""
        if self._kernel_error is not None:
            raise self._kernel_error
        gen = self._gen  # atomic read: one generation per call
        return gen.snap.match_topics_async(topics, route_to_host=gen, profile=profile)

    def match_topics(self, topics: list[str]) -> list[Subscribers]:
        """Match a batch of topics, bit-identical to the live host trie."""
        return self.match_topics_async(topics)()

    def subscribers(self, topic: str) -> Subscribers:
        """Drop-in for ``TopicsIndex.subscribers`` (batch of one)."""
        return self.match_topics([topic])[0]
