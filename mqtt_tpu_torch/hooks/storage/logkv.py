"""Log-structured embedded KV storage hook — the analog of the reference's
badger/pebble backends (hooks/storage/badger/badger.go, pebble/pebble.go),
grown into the durable session plane's store. A copy of the JAX package's;
its store lock is a member of the port's lock plane (``utils.locked``).

Bitcask-style design: every ``_set``/``_del`` appends a CRC-framed record
to the active segment file while a full in-memory map serves reads; on
open, the newest valid snapshot loads first and only the segment TAIL
(segments at or after the snapshot boundary) replays — recovery cost is
``O(live keys + tail)``, not ``O(total appends)``. Replay tolerates a torn
tail record (the crash-mid-append shape: at most one record lost) and
counts mid-file corruption instead of hiding it.

Durability is a policy knob (``durability_fsync``):

- ``"always"`` — fsync per append (the pebble hook's ``Mode: Sync``).
- ``"batch"`` — group commit: appends mark the log dirty and a flusher
  thread fsyncs at ``fsync_interval_ms`` cadence, so a burst of appends
  shares one fsync. Crash window = at most one interval of appends.
- ``"off"`` — no fsync until rotation/snapshot/close (page cache only).

Segments rotate on size (``max_segment_bytes``) or age
(``max_segment_age_s``). A background GC thread mirrors the badger hook's
value-log GC loop (badger.go:110-121): when the dead-record ratio exceeds
``gc_discard_ratio`` it compacts the live map into a fresh segment, and at
``snapshot_interval_s`` cadence it checkpoints the map into a snapshot
file so restart replay starts at the boundary. Shutdown QUIESCES both:
``stop()`` raises ``_closing`` first, so an in-flight compaction aborts at
its next batch boundary (leaving only already-live records behind — replay
still converges) and no daemon thread ever touches a closed segment file.

Record framing: ``op(1) klen(4) vlen(4) key value crc32(4)`` with crc over
everything before it; op 1=set, 2=delete. A snapshot file
(``snapNNNNNN.snap``) is a counted header plus the same framing: magic,
boundary seq, entry count, then one set-record per live key — any CRC or
count mismatch invalidates the whole snapshot (falling back to the next
older one, then to full segment replay), so a torn checkpoint can only
cost recovery TIME, never correctness.

Crash-point fault injection hangs off ``crash_plan``: a plan object with
``reach(point, store)`` and ``append_record(store, rec)`` observes named
crash points (append / rotate / snapshot / compact) and may simulate a
kill there (``SimulatedCrash``), including a TORN append (a prefix of the
record reaches the file). The port has no ``faults`` module yet; its
tests bring their own plan.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterable, Optional

from ...utils.locked import InstrumentedLock
from .base import StorageHook

DEFAULT_PATH = "mqtt_tpu_logkv"
_HEADER = struct.Struct("<BII")
_CRC = struct.Struct("<I")
_OP_SET = 1
_OP_DEL = 2

# snapshot framing: magic(4) version(1) boundary_seq(4) count(8), then
# `count` set-records in segment framing, each individually CRC'd
_SNAP_MAGIC = b"MTKV"
_SNAP_VERSION = 1
_SNAP_HEADER = struct.Struct("<4sBIQ")

FSYNC_ALWAYS = "always"
FSYNC_BATCH = "batch"
FSYNC_OFF = "off"
_FSYNC_POLICIES = (FSYNC_ALWAYS, FSYNC_BATCH, FSYNC_OFF)


class LogKVOptions:
    def __init__(
        self,
        path: str = DEFAULT_PATH,
        sync: bool = False,
        gc_interval: float = 5 * 60.0,
        gc_discard_ratio: float = 0.5,
        max_segment_bytes: int = 64 * 1024 * 1024,
        max_segment_age_s: float = 0.0,
        snapshot_interval_s: float = 0.0,
        snapshot_min_bytes: int = 1024 * 1024,
        durability_fsync: str = "",
        fsync_interval_ms: float = 50.0,
    ) -> None:
        self.path = path
        self.sync = sync
        self.gc_interval = gc_interval
        self.gc_discard_ratio = gc_discard_ratio
        self.max_segment_bytes = max_segment_bytes
        # rotate the active segment once it is this old (0 = size-only):
        # bounded segment AGE bounds how stale the newest-but-one segment
        # can be, which bounds snapshot tail length on quiet brokers
        self.max_segment_age_s = max_segment_age_s
        # checkpoint cadence for the GC thread (0 = snapshots only via an
        # explicit snapshot() call); recovery replays snapshot + tail
        self.snapshot_interval_s = snapshot_interval_s
        # skip a due snapshot when fewer than this many payload bytes
        # were appended since the last one (nothing worth checkpointing)
        self.snapshot_min_bytes = snapshot_min_bytes
        # "always" | "batch" | "off"; "" resolves from the legacy `sync`
        # flag (True -> always, False -> off) so old configs keep their
        # exact durability contract
        self.durability_fsync = durability_fsync
        self.fsync_interval_ms = fsync_interval_ms

    def fsync_policy(self) -> str:
        if self.durability_fsync:
            if self.durability_fsync not in _FSYNC_POLICIES:
                raise ValueError(
                    f"durability_fsync must be one of {_FSYNC_POLICIES}, "
                    f"got {self.durability_fsync!r}"
                )
            return self.durability_fsync
        return FSYNC_ALWAYS if self.sync else FSYNC_OFF


def _segments(path: str) -> list[str]:
    names = [n for n in os.listdir(path) if n.startswith("seg") and n.endswith(".log")]
    return sorted(names)


def _snapshots(path: str) -> list[str]:
    names = [n for n in os.listdir(path) if n.startswith("snap") and n.endswith(".snap")]
    return sorted(names)


def _seg_seq(name: str) -> int:
    return int(name[3:-4])


def _snap_seq(name: str) -> int:
    return int(name[4:-5])


class SimulatedCrash(RuntimeError):
    """Raised by a crash plan at its chosen kill point (tests only)."""


class LogKVStore(StorageHook):
    """Mirrors broker state into an append-only segmented log with
    snapshot + tail recovery."""

    def __init__(self) -> None:
        super().__init__()
        self.config = LogKVOptions()
        self._map: Dict[str, bytes] = {}
        # the store lock is a named lock-plane member: every hook event
        # append and every recovery read serializes here, and the witness
        # blesses its position (utils.locked's static order)
        self._lock = InstrumentedLock("durable_store", rlock=True)
        # maintenance serializer: GC-thread compaction/snapshot vs
        # explicit compact()/snapshot() calls. Ordered BEFORE the store
        # lock everywhere (never acquired under it).
        self._maint = threading.Lock()
        self._file: Optional[Any] = None
        self._active_path = ""
        self._seg_seq = 0
        self._seg_opened_at = 0.0  # monotonic, for age-based rotation
        self._live_bytes = 0  # payload bytes of live records
        self._total_bytes = 0  # payload bytes appended since last compaction
        self._bytes_since_snapshot = 0
        self._dirty = False  # unsynced appends (batch policy)
        self._fsync_policy = FSYNC_OFF
        # replay-corruption accounting: a mid-file corrupt record skips
        # everything after it in that segment — count the events and the
        # skipped trailing bytes so the data loss is never silent
        self.replay_corruptions = 0
        self.replay_skipped_bytes = 0
        self.snapshot_invalid = 0  # snapshots rejected at recovery
        # durable-plane counters (surfaced via durable_stats())
        self.replayed_keys = 0  # snapshot entries + tail records applied
        self.recovery_seconds = 0.0
        self.appends = 0
        self.fsyncs = 0
        self.snapshots = 0
        self.compactions = 0
        self.snapshot_seq = -1  # boundary seq of the newest durable snapshot
        self._snap_wall = 0.0  # wall time of that snapshot (age metric)
        self.synced_bytes = 0  # active-segment bytes covered by an fsync
        self._closing = threading.Event()  # quiesce: compaction + flusher
        self._stop_gc = threading.Event()
        self._gc_thread: Optional[threading.Thread] = None
        self._flush_thread: Optional[threading.Thread] = None
        # crash-point fault injection seam: consulted at named points;
        # None in production
        self.crash_plan: Optional[Any] = None

    def id(self) -> str:
        return "logkv-db"

    # -- lifecycle -----------------------------------------------------------

    def init(self, config: Any) -> None:
        if config is not None and not isinstance(config, LogKVOptions):
            raise TypeError("invalid config type provided")
        self.config = config or LogKVOptions()
        self._fsync_policy = self.config.fsync_policy()
        os.makedirs(self.config.path, exist_ok=True)
        t0 = time.perf_counter()
        with self._lock:
            snap_boundary = self._load_newest_snapshot()
            for name in _segments(self.config.path):
                seq = _seg_seq(name)
                self._seg_seq = max(self._seg_seq, seq + 1)
                if seq < snap_boundary:
                    continue  # already covered by the snapshot
                self._replay(os.path.join(self.config.path, name))
            self._seg_seq = max(self._seg_seq, snap_boundary)
            self._live_bytes = sum(len(k) + len(v) for k, v in self._map.items())
            self._open_segment()
        self.recovery_seconds = time.perf_counter() - t0
        if self.config.gc_interval > 0:
            self._gc_thread = threading.Thread(
                target=self._gc_loop, name="mqtt-torch-logkv-gc", daemon=True
            )
            self._gc_thread.start()
        if self._fsync_policy == FSYNC_BATCH:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, name="mqtt-torch-logkv-fsync", daemon=True
            )
            self._flush_thread.start()

    def stop(self) -> None:
        # quiesce FIRST: an in-flight GC compaction aborts at its next
        # batch boundary and the flusher exits, so by the time the file
        # closes below no daemon thread can touch it
        self._closing.set()
        self._stop_gc.set()
        if self._gc_thread is not None:
            self._gc_thread.join(timeout=30)
            self._gc_thread = None
        if self._flush_thread is not None:
            self._flush_thread.join(timeout=30)
            self._flush_thread = None
        with self._lock:
            if self._file is not None:
                self._file.flush()
                # brokerlint: ok=R1 shutdown flush: the lock IS the writer quiesce; no data plane is waiting on it
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None

    # -- log machinery -------------------------------------------------------

    def _open_segment(self) -> None:
        name = f"seg{self._seg_seq:06d}.log"
        self._seg_seq += 1
        self._active_path = os.path.join(self.config.path, name)
        self._file = open(self._active_path, "ab")
        self._seg_opened_at = time.monotonic()
        self.synced_bytes = 0

    def _load_newest_snapshot(self) -> int:
        """Load the newest VALID snapshot into the map; returns its
        boundary seq (segments >= it form the replay tail), or 0 when no
        usable snapshot exists (full segment replay)."""
        for name in reversed(_snapshots(self.config.path)):
            p = os.path.join(self.config.path, name)
            entries = self._read_snapshot(p)
            if entries is None:
                self.snapshot_invalid += 1
                self.log.warning(
                    "logkv snapshot %s failed validation; falling back to "
                    "an older snapshot or full segment replay",
                    name,
                )
                continue
            self._map.update(entries)
            self.replayed_keys += len(entries)
            self.snapshot_seq = _snap_seq(name)
            try:
                self._snap_wall = os.path.getmtime(p)
            except OSError:
                self._snap_wall = time.time()  # brokerlint: ok=R3 cross-restart snapshot age is wall-clock by nature
            return self.snapshot_seq
        return 0

    def _read_snapshot(self, filepath: str) -> Optional[Dict[str, bytes]]:
        """Parse + validate one snapshot file; None = invalid (torn
        write, bad magic/CRC, short count)."""
        try:
            with open(filepath, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) < _SNAP_HEADER.size:
            return None
        magic, version, _boundary, count = _SNAP_HEADER.unpack_from(data, 0)
        if magic != _SNAP_MAGIC or version != _SNAP_VERSION:
            return None
        entries: Dict[str, bytes] = {}
        pos = _SNAP_HEADER.size
        for _ in range(count):
            if pos + _HEADER.size + _CRC.size > len(data):
                return None
            op, klen, vlen = _HEADER.unpack_from(data, pos)
            end = pos + _HEADER.size + klen + vlen
            if op != _OP_SET or end + _CRC.size > len(data):
                return None
            (crc,) = _CRC.unpack_from(data, end)
            if crc != zlib.crc32(data[pos:end]):
                return None
            key = data[pos + _HEADER.size : pos + _HEADER.size + klen].decode("utf-8")
            entries[key] = data[pos + _HEADER.size + klen : end]
            pos = end + _CRC.size
        return entries

    def _replay(self, filepath: str) -> None:
        """Apply one segment's records to the in-memory map; stop at the
        first torn or corrupt record (crash tolerance).

        A record that simply runs past EOF is a torn tail — the expected
        crash-mid-append shape, at most one record lost. Anything else
        (bad op byte, CRC mismatch) is CORRUPTION mid-file: everything
        after it in the segment is unreadable and skipped, so the event
        is logged with the segment name and byte offset and the skipped
        trailing bytes are counted (``replay_corruptions`` /
        ``replay_skipped_bytes``) — data loss must never be silent."""
        # brokerlint: ok=R14 replay runs once at startup under the store lock; the held lock IS the recovery barrier that keeps writers out mid-replay
        with open(filepath, "rb") as f:
            data = f.read()
        pos = 0
        corrupt = False
        while pos + _HEADER.size + _CRC.size <= len(data):
            op, klen, vlen = _HEADER.unpack_from(data, pos)
            end = pos + _HEADER.size + klen + vlen
            if op not in (_OP_SET, _OP_DEL):
                corrupt = True
                break
            if end + _CRC.size > len(data):
                # the record extends past EOF: the torn-tail crash shape
                # (a flipped LENGTH field can also land here — that case
                # is indistinguishable from a torn large append, so the
                # CRC check below is the corruption tripwire)
                break
            (crc,) = _CRC.unpack_from(data, end)
            if crc != zlib.crc32(data[pos:end]):
                corrupt = True
                break
            key = data[pos + _HEADER.size : pos + _HEADER.size + klen].decode("utf-8")
            if op == _OP_SET:
                self._map[key] = data[pos + _HEADER.size + klen : end]
            else:
                self._map.pop(key, None)
            # count every replayed record (set AND del) so dead-bytes
            # accounting survives a restart — otherwise pre-existing garbage
            # never triggers GC until fresh appends re-accumulate
            self._total_bytes += klen + vlen
            self.replayed_keys += 1
            pos = end + _CRC.size
        if corrupt:
            skipped = len(data) - pos
            self.replay_corruptions += 1
            self.replay_skipped_bytes += skipped
            self.log.warning(
                "logkv replay hit a corrupt record: segment=%s offset=%d "
                "skipped_trailing_bytes=%d (records after the corruption "
                "are lost; a later segment or compaction may re-cover them)",
                os.path.basename(filepath),
                pos,
                skipped,
            )

    def _crashpoint(self, point: str) -> None:
        """Consult the attached crash plan at a named point (no-op in
        production)."""
        plan = self.crash_plan
        if plan is not None:
            plan.reach(point, self)

    def _fsync_active(self) -> None:
        """fsync the active segment and advance the durable watermark.
        Caller holds the store lock."""
        assert self._file is not None
        self._file.flush()
        os.fsync(self._file.fileno())
        self.fsyncs += 1
        self.synced_bytes = self._file.tell()
        self._dirty = False

    def _append(self, op: int, key: str, value: bytes) -> None:
        kb = key.encode("utf-8")
        rec = _HEADER.pack(op, len(kb), len(value)) + kb + value
        rec += _CRC.pack(zlib.crc32(rec))
        plan = self.crash_plan
        if plan is not None:
            # the torn-write plan writes a seeded PREFIX of `rec` and
            # raises SimulatedCrash; a clean-kill plan just raises
            plan.append_record(self, rec)
        assert self._file is not None
        self._file.write(rec)
        self.appends += 1
        if self._fsync_policy == FSYNC_ALWAYS:
            # brokerlint: ok=R1 per-append fsync IS the "always" durability contract; batch/off policies exist for callers that cannot absorb it
            self._fsync_active()
        elif self._fsync_policy == FSYNC_BATCH:
            self._dirty = True  # the flusher owns the group fsync
        self._total_bytes += len(kb) + len(value)
        self._bytes_since_snapshot += len(kb) + len(value)
        age = self.config.max_segment_age_s
        if self._file.tell() >= self.config.max_segment_bytes or (
            age > 0 and time.monotonic() - self._seg_opened_at >= age
        ):
            self._crashpoint("rotate")
            self._file.flush()
            # brokerlint: ok=R1,R14 rotation seals the old segment durably before records land in the next one (replay-order invariant)
            os.fsync(self._file.fileno())
            self._file.close()
            self._open_segment()

    # -- flusher (group commit) ---------------------------------------------

    def _flush_loop(self) -> None:
        """Group-commit flusher: one fsync per interval covers every
        append since the last — the "batch" durability policy."""
        interval = max(0.001, self.config.fsync_interval_ms / 1e3)
        while not self._closing.wait(interval):
            with self._lock:
                if self._file is None:
                    return
                if self._dirty:
                    try:
                        # brokerlint: ok=R1 the group fsync must pin the exact append watermark it covers; the store lock is that pin
                        self._fsync_active()
                    except (OSError, ValueError):
                        self.log.exception("logkv group fsync failed")
                        return

    def sync(self) -> None:
        """Force-fsync outstanding appends (any policy)."""
        with self._lock:
            if self._file is not None:
                # brokerlint: ok=R1 explicit durability barrier requested by the caller
                self._fsync_active()

    # -- gc / snapshot / compaction ------------------------------------------

    def _gc_loop(self) -> None:
        last_snap = time.monotonic()
        while not self._stop_gc.wait(self.config.gc_interval):
            try:
                snap_iv = self.config.snapshot_interval_s
                if snap_iv > 0 and time.monotonic() - last_snap >= snap_iv:
                    if self.snapshot(min_bytes=self.config.snapshot_min_bytes):
                        last_snap = time.monotonic()
                self.compact(self.config.gc_discard_ratio)
            except Exception:
                self.log.exception("logkv gc failed; will retry")

    def snapshot(self, min_bytes: int = 0) -> bool:
        """Checkpoint the live map into a snapshot file so recovery
        replays ``snapshot + tail``; returns True if one was written.

        Sequence: rotate (the boundary), copy the map under the lock,
        write + fsync + rename the snapshot OFF the lock (appends keep
        flowing into the tail), then prune snapshots and segments the new
        one subsumes. A crash at any point leaves either the old
        snapshot + full tail or the new snapshot + shorter tail — both
        replay to the same map."""
        with self._maint:
            with self._lock:
                if self._file is None or self._closing.is_set():
                    return False
                if self._bytes_since_snapshot < min_bytes:
                    return False
                self._crashpoint("snapshot.begin")
                # seal the boundary: records before it live in segments
                # < boundary (all covered by the map copy below)
                self._file.flush()
                # brokerlint: ok=R1 the snapshot boundary must be durable before the snapshot claims to cover it
                os.fsync(self._file.fileno())
                self._file.close()
                self._open_segment()
                boundary = self._seg_seq - 1  # the fresh (empty) segment
                items = list(self._map.items())
                self._bytes_since_snapshot = 0
            name = f"snap{boundary:06d}.snap"
            final = os.path.join(self.config.path, name)
            tmp = final + ".tmp"
            with open(tmp, "wb") as f:
                f.write(
                    _SNAP_HEADER.pack(
                        _SNAP_MAGIC, _SNAP_VERSION, boundary, len(items)
                    )
                )
                for key, value in items:
                    kb = key.encode("utf-8")
                    rec = _HEADER.pack(_OP_SET, len(kb), len(value)) + kb + value
                    f.write(rec + _CRC.pack(zlib.crc32(rec)))
                f.flush()
                os.fsync(f.fileno())
            self._crashpoint("snapshot.rename")
            os.replace(tmp, final)
            self._fsync_dir()
            self.snapshots += 1
            self.snapshot_seq = boundary
            self._snap_wall = time.time()  # brokerlint: ok=R3 snapshot age survives restarts, so the stamp is wall-clock
            self._crashpoint("snapshot.prune")
            # prune what the new snapshot subsumes. Order matters for
            # crash safety: stale SNAPSHOTS first (a stale snapshot
            # surviving while its tail segments vanish could resurrect
            # deleted keys), then covered segments oldest-first.
            for n in _snapshots(self.config.path):
                if _snap_seq(n) < boundary:
                    os.unlink(os.path.join(self.config.path, n))
            dropped = 0
            for n in _segments(self.config.path):
                if _seg_seq(n) < boundary:
                    os.unlink(os.path.join(self.config.path, n))
                    dropped += 1
            with self._lock:
                # the pruned segments' dead bytes are gone from disk
                self._total_bytes = self._live_bytes
            self.log.debug(
                "logkv snapshot written: boundary=%d keys=%d pruned_segments=%d",
                boundary,
                len(items),
                dropped,
            )
            return True

    def compact(self, discard_ratio: float = 0.0) -> bool:
        """Rewrite the live map into a fresh segment when the dead ratio
        exceeds ``discard_ratio``; returns True if compaction ran.
        Aborts (False) at shutdown quiesce: an aborted rewrite leaves a
        partial segment holding only current live values, which replay
        re-applies harmlessly."""
        with self._maint:
            with self._lock:
                if self._file is None or self._closing.is_set():
                    return False
                dead = self._total_bytes - self._live_bytes
                if self._total_bytes == 0 or dead / max(1, self._total_bytes) < discard_ratio:
                    return False
                old_segs = _segments(self.config.path)
                old_snaps = _snapshots(self.config.path)
                self._file.flush()
                self._file.close()
                self._open_segment()
                self._crashpoint("compact.rewrite")
                for i, (key, value) in enumerate(self._map.items()):
                    if (i & 0xFFF) == 0 and self._closing.is_set():
                        # shutdown quiesce: stop() is waiting — leave the
                        # partial rewrite (pure live records) in place
                        self._file.flush()
                        return False
                    self._append(_OP_SET, key, value)
                self._file.flush()
                # brokerlint: ok=R1 compaction must quiesce writers for the rewrite; the store lock is that quiesce by design
                os.fsync(self._file.fileno())
                self._crashpoint("compact.prune")
                # a pre-compaction snapshot is stale the moment the old
                # segments die (it could resurrect deleted keys), so
                # snapshots go first, then segments oldest-first
                for name in old_snaps:
                    # brokerlint: ok=R1 stale-snapshot removal is part of the same quiesced compaction step
                    os.unlink(os.path.join(self.config.path, name))
                for name in old_segs:
                    # brokerlint: ok=R1 dead-segment removal is part of the same quiesced compaction step
                    os.unlink(os.path.join(self.config.path, name))
                self.snapshot_seq = -1
                self._total_bytes = self._live_bytes
                self.compactions += 1
                return True

    def _fsync_dir(self) -> None:
        """Durably record directory mutations (the snapshot rename)."""
        try:
            fd = os.open(self.config.path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    # -- durable-plane stats -------------------------------------------------

    def durable_stats(self) -> Dict[str, Any]:
        """The durable-plane snapshot the server's ``$SYS/broker/durable``
        tree reads."""
        with self._lock:
            try:
                segments = len(_segments(self.config.path))
            except OSError:
                segments = 0
            return {
                "keys": len(self._map),
                "segments": segments,
                "snapshot_seq": self.snapshot_seq,
                "snapshot_age_seconds": (
                    max(0.0, time.time() - self._snap_wall)  # brokerlint: ok=R3 snapshot age spans restarts; wall-clock is the metric's contract
                    if self._snap_wall
                    else -1.0
                ),
                "replayed_keys": self.replayed_keys,
                "replay_corruptions": self.replay_corruptions,
                "replay_skipped_bytes": self.replay_skipped_bytes,
                "snapshot_invalid": self.snapshot_invalid,
                "recovery_seconds": self.recovery_seconds,
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "snapshots": self.snapshots,
                "compactions": self.compactions,
                "fsync_policy": self._fsync_policy,
            }

    # -- KV interface --------------------------------------------------------

    def _set(self, key: str, value: bytes) -> None:
        with self._lock:
            if self._file is None:
                self.log.error("logkv store not open")
                return
            prev = self._map.get(key)
            self._map[key] = value
            self._live_bytes += len(value) - (len(prev) if prev is not None else -len(key))
            self._append(_OP_SET, key, value)

    def _get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._map.get(key)

    def _del(self, key: str) -> None:
        with self._lock:
            if self._file is None:
                self.log.error("logkv store not open")
                return
            prev = self._map.pop(key, None)
            if prev is not None:
                self._live_bytes -= len(key) + len(prev)
            self._append(_OP_DEL, key, b"")

    def _iter(self, prefix: str) -> Iterable[bytes]:
        with self._lock:
            return [v for k, v in self._map.items() if k.startswith(prefix)]
