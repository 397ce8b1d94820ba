"""The port's worker cluster (``mqtt_tpu_torch.cluster`` over
``mesh_topology``, the server's forwards, ``fast_deliver_frame`` and the
``$SYS/broker/cluster/`` gauges) held against the JAX package's on the CPU.

In-process meshes of 2 and 3 workers, each worker a ``Server`` with its
own TCP listener and a ``Cluster`` on one private socket directory, in
mesh and in tree mode, with the device matcher over the stage (the port on
``device="cpu"``) and, once, without it (so QoS 0 v4 publishes take the
frame passthrough and peers deliver them through ``fast_deliver_frame``).
One script of sessions runs through a mesh of JAX workers, a mesh of port
workers and a mixed mesh of both packages on one socket directory: every
client's bytes and every ``$SYS/broker/cluster/`` gauge of every worker
must be equal, and so must every frame each worker received from each
peer, so the mixed mesh speaks the same bytes. Then the link re-dial:
a severed link heals, the dialing side counts the reconnect, and the
publishes cross again, in both packages alike; and the JAX suite's own
in-process re-dial case on the port.

The clusters' ping and gossip clock is set far beyond a test's length on
the instance (as ``maybe_attach_from_env`` sets it), so no time-driven
frame enters the comparison. A step's barrier: every broker has processed
what was sent and drained its queues, every cluster has flushed its
presence, then each worker's sentinel client in turn publishes a marker
that every sentinel must receive before the next; the links are FIFO, so
everything a step forwarded has been delivered. Nothing waits a fixed time; every wait
has its own limit.
"""

import asyncio
import random
import time

import pytest

import chip_smoke as cs
from tests import test_torch_server as ts
from tests import torch_mirror

torch_mirror.export(torch_mirror.mirror("tests.test_cluster"), globals(), "Port",
                    only=("test_peer_link_reconnects_in_process",))
pinned_clock = ts.pinned_clock

SYNC = "zz/sync/"


async def until(cond, what: str, limit: float = ts.LIMIT) -> None:
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.002)


def cluster_mod(pkg):
    if pkg.name == "jax":
        from mqtt_tpu import cluster
    else:
        from mqtt_tpu_torch import cluster
    return cluster


class PingBroker(ts.Broker):
    """A ``test_torch_server.Broker`` without the counting hook (a hook on
    ``on_packet_processed`` turns the QoS 0 frame passthrough off): a send
    ends with a PINGREQ and waits for its PINGRESP, which the read loop
    answers after every packet before it (no stage: processing is
    synchronous)."""

    def __init__(self, pkg, hooks=(), **opts) -> None:
        self.pkg = pkg
        self.srv = pkg.server.Server(ts.options(pkg, **opts))
        for hook, conf in hooks:
            self.srv.add_hook(hook, conf)
        self.srv.add_listener(pkg.listeners.TCP(pkg.listeners.Config(type="tcp", id="t", address="127.0.0.1:0")))
        self.clients: dict = {}
        self.sent = 0

    async def send(self, name: str, *frames: bytes) -> None:
        c = self.clients[name]
        n0 = len(c.frames())
        for f in frames:
            c.send(f)
        c.send(cs.PINGREQ_FRAME)
        await until(lambda: any(f[0] == 0xD0 for f in c.frames()[n0:]) or c.task.done(), f"{name}'s PINGRESP")
        await self.settle()

    async def settle(self, c=None) -> None:
        self.count = type("Done", (), {"n": self.sent})  # nothing to count: the PINGRESP was the barrier
        await super().settle(c)


class Rig:
    """``n`` workers, each a ``test_torch_server.Broker`` (or ``broker``) of
    the package named at its position, joined by a ``Cluster`` per
    worker."""

    def __init__(self, kinds, sock_dir: str, topology: str = "mesh", broker=ts.Broker, **opts) -> None:
        self.n = len(kinds)
        self.brokers = []
        self.clusters = []
        self.rx: dict = {}  # (receiver, sender) -> [(type, payload)]
        for i, kind in enumerate(kinds):
            pkg = ts.package(kind)
            b = broker(pkg, hooks=ts.allow(pkg), cluster_topology=topology, cluster_tree_degree=1, **opts)
            random.seed(1000 + i)  # the worker's boot nonce
            c = cluster_mod(pkg).Cluster(b.srv, i, self.n, sock_dir)
            c.PING_INTERVAL_S = 3600.0
            c._rx_filter = self._recorder(i)
            self.brokers.append(b)
            self.clusters.append(c)
        self.owner: dict = {}  # client name -> worker
        self.step = 0

    def _recorder(self, me: int):
        def keep(peer: int, mtype: int, payload: bytes) -> bool:
            self.rx.setdefault((me, peer), []).append((mtype, bytes(payload)))
            return True

        return keep

    async def start(self) -> None:
        for b in self.brokers:
            await b.start()
        for c in self.clusters:
            await c.start()
        await until(lambda: all(self._links_up(c) for c in self.clusters), "links up")
        for i in range(self.n):
            await self.connect(i, f"sync-w{i}", 4)
            await self.send(f"sync-w{i}", cs.subscribe_frame(1, [(SYNC + "+", 0, 0)], 4))
        await self.sync()

    @staticmethod
    def _links_up(c) -> bool:
        if c.topo is not None:
            return all(p in c._writers for p in c.topo.neighbors())
        return c.peer_count == c.n_workers - 1

    async def connect(self, worker: int, name: str, version: int = 4, **kw) -> list:
        self.owner[name] = worker
        return await self.brokers[worker].connect(name, version, **kw)

    async def send(self, name: str, *frames: bytes) -> None:
        await self.brokers[self.owner[name]].send(name, *frames)

    def fold(self) -> None:
        for b in self.brokers:
            if b.srv.matcher is not None:
                b.fold()

    async def sync(self) -> None:
        """The step barrier (the module docstring)."""
        for b in self.brokers:
            await b.settle()
        for c in self.clusters:
            await until(lambda c=c: not c._pending_presence and not c._presence_wake.is_set(), "presence flushed")
        self.step += 1
        topic = SYNC + str(self.step)
        # one worker's marker at a time, so every sentinel's stream is in
        # one order
        for i in range(self.n):
            b = self.brokers[i]
            b.clients[f"sync-w{i}"].send(cs.publish_frame(topic, b"w%d" % i))
            b.sent += 1
            for k in range(self.n):
                c = self.brokers[k].clients[f"sync-w{k}"]
                await until(lambda c=c, i=i: sum(1 for p in cs._publishes(c, 0) if p["topic"] == topic) == i + 1,
                            f"{topic} from worker {i} at worker {k}")
        for b in self.brokers:
            await b.settle()

    def gauges(self) -> list:
        """Each worker's ``$SYS/broker/cluster/`` rows after one more tick."""
        out = []
        for b in self.brokers:
            b.srv.publish_sys_topics()
            out.append({m.topic_name: bytes(m.payload) for m in b.srv.topics.messages("$SYS/broker/cluster/#")})
        return out

    async def close(self) -> dict:
        for c in self.clusters:
            await c.stop()
        out = {}
        for b in self.brokers:
            out.update(await b.close())
        return out


async def script_mesh(rig: Rig) -> None:
    """Subscribers on every worker (v4 and v5, QoS 0-2, a per-worker
    shared group, a predicated filter on the last worker), then one
    publisher per step: QoS 0, 1 and 2 (with its acks) from v4 and v5
    publishers on each worker, a retained publish replicated to every
    worker and taken by a later subscriber, an unsubscribe that withdraws
    interest, and publishes after it."""
    n = rig.n
    for i in range(n):
        await rig.connect(i, f"s{i}a", 4)
        await rig.send(f"s{i}a", cs.subscribe_frame(1, [("t/+/x", 1, 0), ("r/#", 0, 0)], 4))
        await rig.connect(i, f"s{i}b", 5)
        await rig.send(f"s{i}b", cs.subscribe_frame(2, [(f"t/{i}/#", 2, 0), ("$share/g/t/+/y", 1, 0)], 5))
        await rig.connect(i, f"p{i}", 4)
        await rig.connect(i, f"q{i}", 5)
    await rig.send(f"s{n - 1}a", cs.subscribe_frame(3, [("m/+/temp$GT{v:20}", 1, 0)], 4))
    await rig.sync()
    rig.fold()
    await rig.sync()
    for k in range(4):
        for i in range(n):
            await rig.send(f"p{i}", cs.publish_frame(f"t/{(i + k) % n}/x", b"p%d-q0-%d" % (i, k)))
            await rig.sync()
            await rig.send(f"p{i}", cs.publish_frame(f"t/{(i + 1) % n}/y", b"p%d-q1-%d" % (i, k), 1, 10 + k))
            await rig.sync()
            await rig.send(f"q{i}", cs.publish_frame(f"t/{k % n}/x/deep", b"q%d-q2-%d" % (i, k), 2, 20 + k,
                                                     version=5))
            await rig.send(f"q{i}", cs.ack_frame(cs.PUBREL, 20 + k))
            await rig.sync()
            await rig.send(f"q{i}", cs.publish_frame("m/a/temp", b'{"v": %d}' % (15 + 3 * k), 1, 30 + k,
                                                     version=5))
            await rig.sync()
    await rig.send("p0", cs.publish_frame("r/state", b"retained-0", 1, 40, retain=True))
    await rig.sync()
    await rig.connect(n - 1, "late", 4)
    await rig.send("late", cs.subscribe_frame(4, [("r/+", 1, 0)], 4))
    await rig.sync()
    for i in range(n):
        for pid in range(1, 12):
            await rig.send(f"s{i}a", cs.ack_frame(cs.PUBACK, pid))
    await rig.sync()
    await rig.send(f"s{n - 1}a", cs.unsubscribe_frame(5, ["t/+/x"], 4))
    await rig.sync()
    rig.fold()
    for i in range(n):
        await rig.send(f"p{i}", cs.publish_frame("t/0/x", b"after-unsub-%d" % i, 1, 50 + i))
        await rig.sync()


def run_rig(kinds, sock_dir, script=script_mesh, topology: str = "mesh", **opts):
    sock_dir.mkdir()

    async def main():
        rig = Rig(kinds, str(sock_dir), topology, **opts)
        await rig.start()
        await script(rig)
        gauges = rig.gauges()
        return await rig.close(), gauges, rig

    return asyncio.run(asyncio.wait_for(main(), 300))


def _assert_same(a, b) -> None:
    (aout, ag, arig), (bout, bg, brig) = a, b
    assert list(bout) == list(aout)
    for name in aout:
        assert bout[name] == aout[name], name
    assert bg == ag
    assert brig.rx == arig.rx


@pytest.mark.parametrize("n,topology", [(2, "mesh"), (3, "mesh"), (2, "tree"), (3, "tree")])
def test_meshes_equal_the_jax_workers(pinned_clock, tmp_path, n, topology):
    j = run_rig(["jax"] * n, tmp_path / "j", topology=topology)
    t = run_rig(["torch"] * n, tmp_path / "t", topology=topology)
    _assert_same(j, t)
    out, gauges, rig = t
    # the script crossed workers: every worker forwarded and delivered
    assert all(rig.rx.get((i, p)) for i in range(n) for p in range(n) if p != i and
               (topology == "mesh" or p in rig.clusters[i].topo.neighbors()))
    links = [n - 1 if topology == "mesh" else len(rig.clusters[i].topo.neighbors()) for i in range(n)]
    assert [g["$SYS/broker/cluster/peers"] for g in gauges] == [b"%d" % k for k in links]
    assert all(g["$SYS/broker/cluster/dropped_forwards"] == b"0" for g in gauges)
    late = cs.split_frames(out["late"][0])
    assert any(b"retained-0" in f for f in late)
    assert rig.brokers[0].srv.matcher.stats.as_dict()["batches"] > 0


def test_frame_passthrough_workers_equal_the_jax_workers(pinned_clock, tmp_path):
    """Without the device matcher a v4 QoS 0 publish takes the frame
    passthrough and crosses as a verbatim frame (``forward_frame``); the
    peer delivers it through ``fast_deliver_frame``'s cached plans."""
    j = run_rig(["jax"] * 2, tmp_path / "j", broker=PingBroker, device_matcher=False)
    t = run_rig(["torch"] * 2, tmp_path / "t", broker=PingBroker, device_matcher=False)
    _assert_same(j, t)
    assert 0x46 in {m for m, _p in t[2].rx[(1, 0)]}  # 'F': a verbatim frame crossed


@pytest.mark.parametrize("kinds", [("jax", "torch"), ("torch", "jax")])
def test_a_mixed_mesh_speaks_the_same_frames(pinned_clock, tmp_path, kinds):
    """A JAX worker and a port worker on one socket directory deliver each
    other's publishes; every client's bytes, every gauge and every frame
    each worker received equal those of a mesh of JAX workers."""
    j = run_rig(["jax", "jax"], tmp_path / "j")
    m = run_rig(list(kinds), tmp_path / "m")
    _assert_same(j, m)


async def script_redial(rig: Rig) -> None:
    """A subscriber on worker 0 and a publisher on worker 1; the link is
    severed from worker 0's side, the dialing worker re-dials, presence is
    replayed, and publishes cross again."""
    await rig.connect(0, "sub", 4)
    await rig.send("sub", cs.subscribe_frame(1, [("heal/+", 1, 0)], 4))
    await rig.connect(1, "pub", 4)
    await rig.sync()
    rig.fold()
    await rig.send("pub", cs.publish_frame("heal/a", b"before", 1, 1))
    await rig.sync()
    c0, c1 = rig.clusters
    w = c0._writers[1]
    w.transport.abort()
    await until(lambda: c0._writers.get(1) not in (None, w) and c1.peer_count == 1 and c0.peer_count == 1,
                "the link re-dialed")
    await until(lambda: c1._interested_peers("heal/b") == (0,), "presence replayed")
    await rig.sync()
    await rig.send("pub", cs.publish_frame("heal/b", b"after", 1, 2))
    await rig.sync()


def test_a_severed_link_redials_as_the_jax_workers(pinned_clock, tmp_path):
    j = run_rig(["jax"] * 2, tmp_path / "j", script=script_redial)
    t = run_rig(["torch"] * 2, tmp_path / "t", script=script_redial)
    (jout, jg, _jr), (tout, tg, _tr) = j, t
    assert tout == jout
    assert [p["payload"] for p in cs._publishes(_tr.brokers[0].clients["sub"], 0)] == [b"before", b"after"]
    assert tg == jg
    assert tg[1]["$SYS/broker/cluster/reconnects"] == b"1" and tg[0]["$SYS/broker/cluster/reconnects"] == b"0"


class _WedgedLink:
    """A peer link whose peer reads nothing: every write stays in the
    buffer until ``abort()``, which drops the buffer and every later write,
    as an asyncio transport does."""

    def __init__(self, buffered: int) -> None:
        self.transport = self
        self.buffered = buffered
        self.written = bytearray()
        self.aborted = False

    def get_write_buffer_size(self) -> int:
        return 0 if self.aborted else self.buffered

    def abort(self) -> None:
        self.aborted = True

    def write(self, data: bytes) -> None:
        if not self.aborted:
            self.buffered += len(data)
            self.written += data


@pytest.mark.parametrize("buffered", [0, 4096, 8192, 8193, 50_000])
def test_a_large_presence_flush_closes_a_wedged_link_as_the_jax_cluster(buffered):
    """Two presence flushes of 100 frames (20,500 B each) land on a wedged
    link under a control cap of 8,192 B: the JAX cluster's one write a
    frame and the port's one write a flush put the same bytes on the link,
    close it at the same frame and count the same ``control_bytes``."""
    from mqtt_tpu import cluster as jc
    from mqtt_tpu_torch import cluster as tc

    rng = random.Random(7)
    flushes = [[bytes(rng.getrandbits(8) for _ in range(200)) for _ in range(100)] for _ in range(2)]
    out = []
    for send in ("jax", "torch"):
        node = type("Node", (), {"MAX_PEER_BUFFER": 1024, "control_bytes": 0})()
        link = _WedgedLink(buffered)
        for msgs in flushes:
            if send == "jax":
                for m in msgs:
                    jc.Cluster._send_nowait(node, 1, link, jc._T_PRESENCE, m)
            else:
                tc.Cluster._send_control_batch(node, link, tc._T_PRESENCE, msgs)
        out.append((bytes(link.written), link.aborted, node.control_bytes))
    assert out[1] == out[0]
    assert out[1][1], "the link was left open past the control cap"
