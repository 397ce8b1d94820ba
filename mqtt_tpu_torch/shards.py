"""Event-loop shard fabric: the connection front-end as a small pool of
threads, each running its OWN asyncio event loop that owns thousands of
connections.

A copy of the JAX package's ``mqtt_tpu/shards.py``.

The inherited model — one asyncio loop, one read task per connection —
serializes every socket wakeup, every decode, and every fan-out behind a
single thread: receive flatness collapses ~10x going 10 -> 100 clients
(BENCH_r05 receive_flatness ~0.095) while production MQTT means 100k-1M
mostly-idle devices. The fabric splits that front-end:

- ``LoopShard``: a daemon thread running its own event loop, its own
  read-side :class:`~mqtt_tpu_torch.clients.ScanGate` (decode batching is
  per-shard and DEFAULT-ON inside the fabric — every read loop that
  wakes in one shard tick lands in one ``mqtt_frame_scan_multi`` call),
  and a 1 Hz housekeeping tick running the server's slow-consumer
  eviction sweep over the clients this shard owns.
- ``ShardFabric``: the router. Accepted sockets dispatch to the
  least-loaded shard (live-connection count, ties to the lowest index)
  and are wrapped into streams ON the shard's loop via
  ``loop.connect_accepted_socket`` — reader, writer, TLS handshake, the
  CONNECT handshake, and the whole packet read loop all live on the
  owning shard. ``serve_reuseport`` instead gives every shard its own
  SO_REUSEPORT-bound listening socket and accept loop (kernel load
  balancing; no hand-off hop).

Cross-shard invariants (the contract the server relies on):

- every transport write/close happens on the OWNING shard's loop —
  cross-shard deliveries ride the thread-safe bounded outbound queue
  (``clients.OutboundQueue``) or are marshaled to the owner via
  ``call_soon_threadsafe`` (``server._deliver_to_client`` /
  ``_flush_variant``'s per-shard split / ``disconnect_client``);
- per-client QoS state (packet ids, inflight) mutates only on the
  owning loop;
- the registries every shard touches concurrently (clients, trie,
  retained, governor, telemetry rings) were already lock-planed
  — the fabric adds no new shared mutable state beyond its
  own counters under the blessed ``shard_fabric`` lock.

``Options.loop_shards`` (default 1) keeps the single-loop path
bit-for-bit: with no fabric none of this module is imported.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import threading
from typing import Any, Awaitable, Callable, Optional

from .utils.locked import InstrumentedLock
from .utils.loopwitness import DEFAULT_LOOP_PLANE as _LOOP_PLANE

_log = logging.getLogger("mqtt_tpu_torch.shards")

# a task created by the fabric carries this attribute so the server's
# establish path skips the main-loop ClientsWg tracking (those tasks
# belong to a shard loop; awaiting them from the main loop is illegal)
SHARD_TASK_ATTR = "_mqtt_tpu_shard"

# (reader, writer) -> awaitable: the listener's established-stream
# handler (StreamListener._handle bound over the establish fn), so
# stream-wrapping listeners (websocket) ride the fabric unchanged
StreamHandler = Callable[[asyncio.StreamReader, asyncio.StreamWriter], Awaitable]


class LoopShard:
    """One event-loop shard: a daemon thread + its own asyncio loop."""

    def __init__(self, index: int, fabric: "ShardFabric") -> None:
        self.index = index
        self.fabric = fabric
        self.loop = asyncio.new_event_loop()
        # read-side decode batching is per-shard and default-on inside
        # the fabric: the gate is loop-affine by design
        from .clients import ScanGate

        self.scan_gate = ScanGate()
        # live connections / lifetime accepts; mutated under the
        # fabric's dispatch lock so the least-loaded pick is exact
        self.connections = 0
        self.accepted = 0
        self.evictions = 0  # slow-consumer evictions this shard ran
        self.tasks: set = set()  # establish tasks (loop-confined)
        self._tick_task: Optional[asyncio.Task] = None
        self._accept_tasks: list[asyncio.Task] = []
        self._ready = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"mqtt-tpu-shard-{index}", daemon=True
        )

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self._ready.set()
        try:
            self.loop.run_forever()
        finally:
            # drain callbacks scheduled between stop() and close()
            try:
                self.loop.run_until_complete(asyncio.sleep(0))
            except Exception:  # brokerlint: ok=R4 teardown; a dead loop has nothing left to drain
                pass
            self.loop.close()

    def start(self, server: Any) -> None:
        self.thread.start()
        self._ready.wait(timeout=5.0)
        self.loop.call_soon_threadsafe(self._arm_tick, server)

    def _arm_tick(self, server: Any) -> None:
        self._tick_task = self.loop.create_task(
            self._tick(server), name=f"mqtt-tpu-shard-{self.index}-tick"
        )

    async def _tick(self, server: Any) -> None:
        """Per-shard housekeeping: the slow-consumer eviction sweep over
        THIS shard's clients, on this shard's loop — transport reads and
        disconnects stay loop-local (the single-loop sweep's invariant,
        preserved per shard)."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self.evictions += server.sweep_clients_for_loop(self.loop)
            except Exception:
                _log.exception("shard %d eviction sweep failed", self.index)

    def track(self, task: asyncio.Task) -> None:
        if _LOOP_PLANE.active:
            w = _LOOP_PLANE.witness
            if w is not None:
                # tracking mutates the shard-owned task set: legal only
                # on this shard's loop (dispatch marshals _go here)
                w.check_owner("shard_task", "tracked", self.loop)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)


class ShardFabric:
    """The shard router + lifecycle owner (``Options.loop_shards``)."""

    def __init__(self, n_shards: int, server: Any) -> None:
        self.server = server
        self.n_shards = max(1, int(n_shards))
        self.shards = [LoopShard(i, self) for i in range(self.n_shards)]
        self._by_loop = {s.loop: s for s in self.shards}
        # guards the least-loaded pick + per-shard counters; a leaf
        # lock (nothing else is ever taken under it — blessed last in
        # LOCK_ORDER)
        self._lock = InstrumentedLock("shard_fabric")
        self.dispatched = 0  # lifetime dispatches through the router
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for s in self.shards:
            s.start(self.server)

    async def stop(self) -> None:
        """Stop every shard: cancel its tasks, give the establish tasks
        a bounded drain (their transports were closed by the listener
        teardown), then stop + join the loops."""
        self._stopping = True

        def _cancel(shard: LoopShard) -> None:
            if shard._tick_task is not None:
                shard._tick_task.cancel()
            for t in shard._accept_tasks:
                t.cancel()
            for t in list(shard.tasks):
                t.cancel()

        for s in self.shards:
            try:
                s.loop.call_soon_threadsafe(_cancel, s)
            except RuntimeError:
                continue
        # bounded drain off the main loop (thread joins block)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._join_all)

    def _join_all(self) -> None:
        import time as _time

        deadline = _time.monotonic() + 5.0
        for s in self.shards:
            while s.tasks and _time.monotonic() < deadline:
                _time.sleep(0.01)
            try:
                s.loop.call_soon_threadsafe(s.loop.stop)
            except RuntimeError:
                pass
            s.thread.join(timeout=max(0.1, deadline - _time.monotonic()))

    # -- routing -----------------------------------------------------------

    def gate_for(self, loop: Any) -> Optional[Any]:
        """The shard ScanGate owning ``loop`` (None off-fabric)."""
        shard = self._by_loop.get(loop)
        return shard.scan_gate if shard is not None else None

    def shard_of(self, loop: Any) -> Optional[LoopShard]:
        return self._by_loop.get(loop)

    def owns(self, loop: Any) -> bool:
        return loop in self._by_loop

    def _pick(self) -> LoopShard:
        with self._lock:
            shard = min(
                self.shards, key=lambda s: (s.connections, s.index)
            )
            shard.connections += 1
            shard.accepted += 1
            self.dispatched += 1
        return shard

    def _release(self, shard: LoopShard) -> None:
        with self._lock:
            shard.connections -= 1

    def dispatch(
        self,
        sock: socket.socket,
        tls: Optional[Any],
        handler: StreamHandler,
    ) -> None:
        """Hand one accepted socket to the least-loaded shard. The
        wrap (streams + optional server-side TLS handshake) and the
        whole connection lifetime run on the shard's loop."""
        if self._stopping:
            try:
                sock.close()
            except OSError:
                pass
            return
        shard = self._pick()
        try:
            sock.setblocking(False)
        except OSError:
            self._release(shard)
            return

        def _go() -> None:
            task = shard.loop.create_task(
                self._serve_socket(shard, sock, tls, handler)
            )
            setattr(task, SHARD_TASK_ATTR, shard.index)
            shard.track(task)

        try:
            shard.loop.call_soon_threadsafe(_go)
        except RuntimeError:  # shard loop already closed (shutdown race)
            self._release(shard)
            try:
                sock.close()
            except OSError:
                pass

    async def _serve_socket(
        self,
        shard: LoopShard,
        sock: socket.socket,
        tls: Optional[Any],
        handler: StreamHandler,
    ) -> None:
        writer: Optional[asyncio.StreamWriter] = None
        try:
            try:
                reader = asyncio.StreamReader(limit=2**16, loop=shard.loop)
                protocol = asyncio.StreamReaderProtocol(reader, loop=shard.loop)
                transport, _ = await shard.loop.connect_accepted_socket(
                    lambda: protocol, sock, ssl=tls
                )
                writer = asyncio.StreamWriter(
                    transport, protocol, reader, shard.loop
                )
            except Exception as e:
                _log.debug("shard %d failed to wrap socket: %s", shard.index, e)
                try:
                    sock.close()
                except OSError:
                    pass
                return
            try:
                await handler(reader, writer)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                _log.debug("shard %d establish error: %s", shard.index, e)
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception:  # brokerlint: ok=R4 teardown; the transport is already gone
                    pass
            self._release(shard)

    # -- per-shard accept (SO_REUSEPORT mode) ------------------------------

    def serve_reuseport(
        self,
        socks: list,
        tls: Optional[Any],
        handler: StreamHandler,
    ) -> None:
        """Give shard i its own listening socket (all bound to one
        address with SO_REUSEPORT): the kernel load-balances accepts and
        connections never pay the hand-off hop. ``socks`` must carry one
        socket per shard (the listener binds them)."""
        for shard, lsock in zip(self.shards, socks):
            lsock.setblocking(False)

            def _arm(shard: LoopShard = shard, lsock: Any = lsock) -> None:
                t = shard.loop.create_task(
                    self._accept_loop(shard, lsock, tls, handler)
                )
                shard._accept_tasks.append(t)

            shard.loop.call_soon_threadsafe(_arm)

    async def _accept_loop(
        self,
        shard: LoopShard,
        lsock: socket.socket,
        tls: Optional[Any],
        handler: StreamHandler,
    ) -> None:
        loop = shard.loop
        try:
            while True:
                try:
                    sock, _addr = await loop.sock_accept(lsock)
                except (asyncio.CancelledError, GeneratorExit):
                    raise
                except OSError:
                    return  # listener closed under us
                with self._lock:
                    shard.connections += 1
                    shard.accepted += 1
                    self.dispatched += 1
                sock.setblocking(False)
                task = loop.create_task(
                    self._serve_socket(shard, sock, tls, handler)
                )
                setattr(task, SHARD_TASK_ATTR, shard.index)
                shard.track(task)
        finally:
            try:
                lsock.close()
            except OSError:
                pass

    # -- observability -----------------------------------------------------

    def spread(self) -> dict:
        """Per-shard live-connection counts (the conn-smoke gate's
        within-2x assertion reads this shape off /metrics)."""
        with self._lock:
            return {s.index: s.connections for s in self.shards}

    def register_metrics(self, registry: Any) -> None:
        """Per-shard gauge/counter families, folded at scrape — the
        per-loop planes' per-shard face. Labeled children
        are registered up front (shard count is fixed for the broker's
        life), one family per README catalog row."""
        for s in self.shards:
            lab = str(s.index)
            registry.gauge(
                "mqtt_tpu_shard_connections",
                "Live connections owned by each event-loop shard",
                fn=lambda s=s: s.connections,
                shard=lab,
            )
            registry.counter(
                "mqtt_tpu_shard_accepted_total",
                "Connections ever dispatched to each shard",
                fn=lambda s=s: s.accepted,
                shard=lab,
            )
            registry.counter(
                "mqtt_tpu_shard_evictions_total",
                "Slow-consumer evictions run by each shard's sweep",
                fn=lambda s=s: s.evictions,
                shard=lab,
            )
            registry.counter(
                "mqtt_tpu_shard_scan_batches_total",
                "Per-shard coalesced read-side decode batches (ScanGate "
                "flushes on that shard's loop)",
                fn=lambda s=s: s.scan_gate.batches,
                shard=lab,
            )
            registry.counter(
                "mqtt_tpu_shard_scan_buffers_total",
                "Read buffers scanned through each shard's ScanGate",
                fn=lambda s=s: s.scan_gate.scans,
                shard=lab,
            )
            registry.gauge(
                "mqtt_tpu_shard_backlog_messages",
                "Queued outbound publishes across each shard's clients",
                fn=lambda loop=s.loop: self.server.shard_backlog(loop),
                shard=lab,
            )
        registry.counter(
            "mqtt_tpu_shard_dispatch_total",
            "Accepted sockets routed through the shard router",
            fn=lambda: self.dispatched,
        )
