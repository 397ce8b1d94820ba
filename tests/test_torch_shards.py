"""The port's event-loop shard fabric (``mqtt_tpu_torch.shards``, the
listeners' fabric accept and the server's fabric branches) held against
the JAX package's on the CPU.

Every case of ``tests/test_shards.py`` runs again on the port
(``tests/torch_mirror.py``: the same bodies and assertions, the imports
answered by the port): the thread-safe outbound queue, delivery equal to
the single-loop broker, the least-loaded spread, the per-shard scan gate
and metrics, QoS 1 across shards, the cross-shard takeover, the per-shard
eviction sweep, the stage's cross-loop submit and resolve, and the knobs.

Then the scripted sessions of ``tests/test_torch_server.py`` run through a
JAX ``Server(loop_shards=4)`` and a port ``Server(loop_shards=4)`` (the
device matcher over the stage, predicates on, the port on
``device="cpu"``), in both accept modes: every client's bytes, connection
by connection, must be equal, and the clients must have stood on every
shard. A step waits, beyond the single-loop barrier, for every shard loop
to have run what was marshaled onto it, so the streams do not depend on
timing.
"""

import asyncio
import socket

import pytest

import chip_smoke as cs
from tests import test_torch_server as ts
from tests import torch_mirror

torch_mirror.export(torch_mirror.mirror("tests.test_shards"), globals(), "Port")
pinned_clock = ts.pinned_clock

SHARDS = 4


class FabricBroker(ts.Broker):
    """``test_torch_server.Broker`` over the shard fabric: its barrier also
    drains every shard loop (a marshaled delivery or disconnect runs
    there), and it keeps the highest per-shard connection counts seen."""

    def __init__(self, pkg, hooks=(), **opts) -> None:
        super().__init__(pkg, hooks=hooks, **opts)
        self.peak: dict = {}

    async def settle(self, c=None) -> None:
        fabric = self.srv._fabric
        for _ in range(3):
            await super().settle(c)
            if fabric is None:
                return
            for shard in fabric.shards:
                fut = asyncio.run_coroutine_threadsafe(asyncio.sleep(0), shard.loop)
                await asyncio.wait_for(asyncio.wrap_future(fut), ts.LIMIT)
            for k, n in fabric.spread().items():
                self.peak[k] = max(self.peak.get(k, 0), n)


class NetFabricBroker(FabricBroker):
    """``FabricBroker`` whose listener ``t`` is a ``listeners.Net`` over a
    socket bound and listening before the server starts."""

    def __init__(self, pkg, hooks=(), **opts) -> None:
        super().__init__(pkg, hooks=hooks, **opts)
        self.srv.listeners.delete("t")
        sock = socket.create_server(("127.0.0.1", 0))
        self.srv.add_listener(pkg.listeners.Net("t", sock))


def run_fabric(script, hooks_of, accept: str, broker=FabricBroker, **opts) -> dict:
    out = {}
    for name in ("jax", "torch"):
        pkg = ts.package(name)

        async def main():
            b = broker(pkg, hooks=hooks_of(pkg), loop_shards=SHARDS, loop_shard_accept=accept, **opts)
            await b.start()
            assert b.srv._fabric is not None and b.srv._fabric.n_shards == SHARDS
            await script(b)
            return await b.close(), b

        out[name] = asyncio.run(main())
    return out


@pytest.mark.parametrize("accept", ["handoff", "reuseport"])
def test_scripted_sessions_on_four_shards_equal_the_jax_server(pinned_clock, accept):
    got = run_fabric(ts.script_core, ts.allow, accept)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert list(tout) == list(jout)
    for name in jout:
        assert tout[name] == jout[name], name
    assert sum(len(c) for conns in tout.values() for c in conns) > 2500
    assert tb.srv.matcher.stats.as_dict()["batches"] > 0
    # the handoff router's least-loaded pick spreads the clients; the
    # kernel's SO_REUSEPORT balance may leave a shard idle
    if accept == "handoff":
        assert all(tb.peak.get(k, 0) > 0 for k in range(SHARDS)), tb.peak


async def script_spread(b: FabricBroker) -> None:
    """Sixteen subscribers over the four shards, each with its own filter
    of one QoS and a shared wildcard; three publishers (v4 QoS 0, v4 QoS 1,
    v5 QoS 2 with its acks) publish into them; the subscribers ack their
    QoS 1/2 deliveries; then every subscriber reconnects with its session
    (clean off), most onto another shard, and takes the publishes sent
    while it was away."""
    for i in range(16):
        await b.connect(f"s{i}", 4 + i % 2, clean=False,
                        props=[(cs.P_SESSION_EXPIRY, 600)] if i % 2 else ())
        await b.send(f"s{i}", cs.subscribe_frame(1, [(f"t/{i}/#", i % 3, 0), ("all/+", 1, 0)], 4 + i % 2))
    await b.connect("p0", 4)
    await b.connect("p1", 4)
    await b.connect("p2", 5)
    b.fold()
    for k in range(12):
        i = k % 16
        await b.send("p0", cs.publish_frame(f"t/{i}/x", b"q0-%d" % k))
        await b.send("p1", cs.publish_frame(f"t/{(i + 5) % 16}/y", b"q1-%d" % k, 1, 100 + k))
        await b.send("p2", cs.publish_frame("all/z", b"q2-%d" % k, 2, 200 + k, version=5))
        await b.send("p2", cs.ack_frame(cs.PUBREL, 200 + k))
    for i in range(16):
        for pid in range(1, 20):
            await b.send(f"s{i}", cs.ack_frame(cs.PUBACK, pid))
    for i in range(16):
        await b.drop(f"s{i}")
    for k in range(4):
        await b.send("p1", cs.publish_frame(f"t/{k}/away", b"away-%d" % k, 1, 300 + k))
    for i in range(15, -1, -1):
        await b.connect(f"s{i}", 4 + i % 2, clean=False,
                        props=[(cs.P_SESSION_EXPIRY, 600)] if i % 2 else ())
    await b.send("p0", cs.publish_frame("all/end", b"end"))


def test_sessions_across_shards_equal_the_jax_server(pinned_clock):
    got = run_fabric(script_spread, ts.allow, "handoff")
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    assert all(len(tout[f"s{i}"]) == 2 for i in range(16))
    assert all(tb.peak.get(k, 0) >= 3 for k in range(SHARDS)), tb.peak
    assert tb.srv._fabric is None  # stopped by close()


def test_net_clients_spread_over_the_shards_as_the_jax_servers(pinned_clock):
    """A ``Net`` listener (a caller's pre-bound socket) hands its clients to
    the fabric's accept loop in both packages: the same bytes per client,
    and every shard serves several of them."""
    got = run_fabric(script_spread, ts.allow, "handoff", broker=NetFabricBroker)
    (jout, jb), (tout, tb) = got["jax"], got["torch"]
    assert tout == jout
    assert all(len(tout[f"s{i}"]) == 2 for i in range(16))
    for b in (jb, tb):
        assert all(b.peak.get(k, 0) >= 3 for k in range(SHARDS)), b.peak
