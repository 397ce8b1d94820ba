"""The port's session layer (``mqtt_tpu_torch.clients``, ``inflight``,
``hooks``, ``system``, ``server``'s first cut) against the JAX package's.

Each test drives a port ``Client`` (on ``server._Ops`` over the port's
``Options``) and a JAX ``Client`` from ``Server(Options()).new_client``
through the same steps and compares what they hold or write: inflight
order and quotas, packet-id allocation, ``parse_connect``'s clamps, the
bytes ``write_packet`` and ``write_frame`` write, the read loop over a fed
``StreamReader`` (whole, split, malformed, too large) and the coalesced
scans of ``ScanGate``. All comparisons are exact; no test sleeps or waits
on a socket.
"""

import asyncio
import logging
import random

import pytest

from mqtt_tpu import Options as JOptions
from mqtt_tpu import Server as JServer
from mqtt_tpu import clients as jclients
from mqtt_tpu import hooks as jhooks
from mqtt_tpu import packets as jp
from mqtt_tpu import topics as jtopics
from mqtt_tpu_torch import clients as tclients
from mqtt_tpu_torch import hooks as thooks
from mqtt_tpu_torch import inflight as tinflight
from mqtt_tpu_torch import packets as tp
from mqtt_tpu_torch import server as tserver
from mqtt_tpu_torch import system as tsystem
from mqtt_tpu_torch import topics as ttopics
from test_torch_packets import canon


class Writer:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    def get_extra_info(self, name, default=None):
        return default

    def close(self):
        pass


class Counting:
    """A hook on both packages' QoS events, counting each call."""

    def __init__(self, hk):
        self.calls = []
        outer = self

        class H(hk.Hook):
            def id(self):
                return "counting"

            def provides(self, b):
                return b in (hk.ON_QOS_PUBLISH, hk.ON_QOS_COMPLETE, hk.ON_QOS_DROPPED, hk.ON_PACKET_READ)

            def on_qos_publish(self, cl, pk, sent, resends):
                outer.calls.append(("publish", pk.packet_id, resends))

            def on_qos_complete(self, cl, pk):
                outer.calls.append(("complete", pk.packet_id))

            def on_qos_dropped(self, cl, pk):
                outer.calls.append(("dropped", pk.packet_id))

            def on_packet_read(self, cl, pk):
                outer.calls.append(("read", pk.fixed_header.type))
                return pk

        self.hook = H()


def twins(reader=None, writer=True, **caps):
    """A JAX client and a port client, each on its package's defaults
    (capabilities overridden by ``caps``), with writers."""
    srv = JServer(JOptions())
    for k, v in caps.items():
        setattr(srv.options.capabilities, k, v)
    jw, tw = (Writer(), Writer()) if writer else (None, None)
    jcl = srv.new_client(reader, jw, "t1", "cl1", False)
    opts = tserver.Options()
    opts.ensure_defaults()
    for k, v in caps.items():
        setattr(opts.capabilities, k, v)
    ops = tserver._Ops(opts, tsystem.Info(), thooks.Hooks(opts.logger), opts.logger)
    tcl = tclients.Client(reader, tw, ops)
    tcl.id, tcl.net.listener = "cl1", "t1"
    return (srv, jcl, jw), (ops, tcl, tw)


def publish(pkts, pid, qos=1, created=0, topic="a/b", payload=b"x", version=4):
    return pkts.Packet(fixed_header=pkts.FixedHeader(type=pkts.PUBLISH, qos=qos), packet_id=pid,
                       created=created, topic_name=topic, payload=payload, protocol_version=version)


def test_defaults_are_the_jax_defaults():
    (srv, _, _), (ops, _, _) = twins()
    assert canon(ops.options.capabilities) == canon(srv.options.capabilities)
    assert ops.options.logger is not None and srv.options.logger is not None
    assert sorted(vars(tsystem.Info()).keys()) == sorted(vars(srv.info).keys())
    assert tsystem.Info().as_dict().keys() == srv.info.as_dict().keys()
    assert [n for n in dir(thooks) if n.startswith(("ON_", "STORED_", "SET_"))] == \
        [n for n in dir(jhooks) if n.startswith(("ON_", "STORED_", "SET_"))]
    assert all(getattr(thooks, n) == getattr(jhooks, n) for n in dir(jhooks) if n.startswith(("ON_", "STORED_")))


def test_inflight_order_quotas_and_clone_equal_the_jax_package():
    rng = random.Random(3)
    (_, jcl, _), (_, tcl, _) = twins()
    ji, ti = jcl.state.inflight, tcl.state.inflight
    assert type(ti) is tinflight.Inflight and ti._lock.stats.name == ji._lock.stats.name == "inflight"
    for k in (ji, ti):
        k.reset_send_quota(5)
        k.reset_receive_quota(3)
    for step in range(400):
        op = rng.randrange(6)
        pid, created = rng.randrange(1, 40), rng.randrange(1 << 18)
        expiry = rng.choice([0, -1, 5])
        if op < 3:
            got = [k.set(publish(p, pid, created=created)) for k, p in ((ji, jp), (ti, tp))]
            for k in (ji, ti):
                k.get(pid).expiry = expiry
        elif op == 3:
            got = [k.delete(pid) for k in (ji, ti)]
        elif op == 4:
            got = [[x.packet_id for x in k.get_all(bool(step % 2))] for k in (ji, ti)]
        else:
            for name in ("decrease_send_quota", "increase_send_quota", "decrease_receive_quota",
                         "increase_receive_quota"):
                for k in (ji, ti):
                    getattr(k, name)()
            got = [(k.send_quota, k.receive_quota, len(k)) for k in (ji, ti)]
        assert got[0] == got[1], step
    nj, nt = ji.next_immediate(), ti.next_immediate()
    assert (nj and nj.packet_id) == (nt and nt.packet_id)
    assert [x.packet_id for x in ti.clone().get_all(False)] == [x.packet_id for x in ji.clone().get_all(False)]
    bulk = [publish(tp, i) for i in range(30, 50)]
    assert ti.set_bulk(bulk) == ji.set_bulk([publish(jp, i) for i in range(30, 50)])


@pytest.mark.parametrize("maximum,start,held", [(0xFFFF, 0, ()), (0xFFFF, 0, (1, 2, 4)), (5, 5, ()),
                                                (4, 0, (1, 2, 3, 4)), (6, 3, (4, 5, 6, 1))])
def test_packet_id_allocation_equals_the_jax_package(maximum, start, held):
    (srv, jcl, _), (ops, tcl, _) = twins()
    srv.options.capabilities.maximum_packet_id = ops.options.capabilities.maximum_packet_id = maximum
    for cl, p in ((jcl, jp), (tcl, tp)):
        cl.state.packet_id = start
        for i in held:
            cl.state.inflight.set(publish(p, i))

    def ids(cl, codes):
        out = []
        for _ in range(6):
            try:
                i = cl.next_packet_id()
            except codes.Code as e:
                out.append(("code", e.code, e.reason))
                break
            out.append(i)
            cl.state.inflight.set(publish(tp if codes is tp else jp, i & 0xFFFF))
        return out

    assert ids(tcl, tp) == ids(jcl, jp)


@pytest.mark.parametrize("version", [3, 4, 5])
@pytest.mark.parametrize("props", [{}, {"receive_maximum": 1000}, {"receive_maximum": 3, "topic_alias_maximum": 7},
                                   {"session_expiry_interval": 5, "session_expiry_interval_flag": True}])
def test_parse_connect_clamps_equal_the_jax_package(version, props):
    (srv, jcl, _), (ops, tcl, _) = twins(maximum_inflight=8)
    got = []
    for cl, p in ((jcl, jp), (tcl, tp)):
        pk = p.Packet(fixed_header=p.FixedHeader(type=p.CONNECT), protocol_version=version,
                      connect=p.ConnectParams(protocol_name=b"MQTT", clean=True, keepalive=3,
                                              client_identifier="zen", will_flag=True, will_qos=1,
                                              will_topic="lwt", will_payload=b"bye"))
        pk.connect.will_properties.will_delay_interval = 30
        for k, v in props.items():
            setattr(pk.properties, k, v)
        cl.parse_connect("t9", pk)
        got.append((cl.id, cl.net.listener, cl.properties.protocol_version, canon(cl.properties.props),
                    canon(cl.properties.will), cl.state.keepalive, cl.state.inflight.maximum_send_quota,
                    cl.state.inflight.maximum_receive_quota, cl.state.topic_aliases.outbound.maximum))
    assert got[1] == got[0]
    # an empty client id is assigned one, in both packages
    for cl, p in ((jcl, jp), (tcl, tp)):
        pk = p.Packet(protocol_version=5, connect=p.ConnectParams(protocol_name=b"MQTT", client_identifier=""))
        cl.parse_connect("t1", pk)
        assert len(cl.id) == 20 and cl.properties.props.assigned_client_id == cl.id


def _outbound_packets(p):
    """Packets of every kind a client writes, with the v5 mods that
    ``write_packet`` sets."""
    out = [
        publish(p, 0, qos=0, topic="a/b", payload=b"hello"),
        publish(p, 7, qos=1, topic="x/y/z", payload=b"\x00\x01" * 40),
        publish(p, 9, qos=2, topic="t", payload=b""),
        p.Packet(fixed_header=p.FixedHeader(type=p.PUBACK), packet_id=7, reason_code=0x10),
        p.Packet(fixed_header=p.FixedHeader(type=p.CONNACK), session_present=True, reason_code=0),
        p.Packet(fixed_header=p.FixedHeader(type=p.SUBACK), packet_id=3, reason_codes=b"\x00\x01\x80"),
        p.Packet(fixed_header=p.FixedHeader(type=p.PINGRESP)),
        p.Packet(fixed_header=p.FixedHeader(type=p.DISCONNECT), reason_code=0x8E),
    ]
    out[1].properties.subscription_identifier = [3, 9]
    out[1].properties.topic_alias, out[1].properties.topic_alias_flag = 4, True
    out[2].fixed_header.retain = True
    out[4].properties.response_info = "resp"
    out[4].properties.reason_string = "why"
    return out


@pytest.mark.parametrize("version", [4, 5])
@pytest.mark.parametrize("client_props", [{}, {"request_problem_info": 0, "request_problem_info_flag": True},
                                          {"request_response_info": 1}, {"maximum_packet_size": 40}])
def test_write_packet_bytes_equal_the_jax_package(version, client_props):
    (srv, jcl, jw), (ops, tcl, tw) = twins()
    for cl in (jcl, tcl):
        cl.properties.protocol_version = version
        for k, v in client_props.items():
            setattr(cl.properties.props, k, v)
    errs = []
    for (cl, p) in ((jcl, jp), (tcl, tp)):
        e = []
        for pk in _outbound_packets(p):
            try:
                cl.write_packet(pk)
                e.append(None)
            except p.Code as x:
                e.append((x.code, x.reason))
        errs.append(e)
    assert errs[1] == errs[0]
    assert tw.data == jw.data and len(tw.data) > 0
    assert (ops.info.bytes_sent, ops.info.packets_sent, ops.info.messages_sent) == \
        (srv.info.bytes_sent, srv.info.packets_sent, srv.info.messages_sent)
    assert (tcl.state.out_bytes, tcl.state.out_writes) == (jcl.state.out_bytes, jcl.state.out_writes)


def test_write_frame_and_the_frame_cache_equal_the_jax_package():
    from mqtt_tpu.server import _FrameCache as JCache
    from mqtt_tpu.server import publish_frame_topic as jtopic

    (srv, jcl, jw), (ops, tcl, tw) = twins()
    jcache, tcache = JCache(publish(jp, 0, qos=0, topic="r/d/m", payload=b"p")), \
        tserver._FrameCache(publish(tp, 0, qos=0, topic="r/d/m", payload=b"p"))
    for version in (3, 4, 5):
        for retain in (False, True):
            jf, tf = jcache.get(version, retain), tcache.get(version, retain)
            assert tf == jf and tcache.get(version, retain) is tf
            jcl.write_frame(jf)
            tcl.write_frame(tf)
            assert tserver.publish_frame_topic(tf) == jtopic(jf) == ("r/d/m", 2)
            assert tserver.publish_frame_body_offset(tf) == 2
    assert tw.data == jw.data
    assert tserver.publish_frame_topic(b"\x30\x05\x00\x09ab") is None
    tcl.stop()
    with pytest.raises(tclients.ConnectionClosedError):
        tcl.write_frame(b"\x30\x00")


def _inbound_stream(p, rng, n=300):
    """A seeded stream of client-to-server packets (v5) and its frames."""
    frames = []
    for i in range(n):
        kind = rng.randrange(4)
        if kind == 0:
            pk = publish(p, (i % 60000) + 1 if i % 3 else 0, qos=1 if i % 3 else 0, topic=f"s/{i % 17}",
                         payload=bytes(rng.randrange(256) for _ in range(rng.randrange(0, 300))), version=5)
        elif kind == 1:
            pk = p.Packet(fixed_header=p.FixedHeader(type=p.PUBACK), packet_id=i + 1, protocol_version=5)
        elif kind == 2:
            pk = p.Packet(fixed_header=p.FixedHeader(type=p.PINGREQ), protocol_version=5)
        else:
            pk = p.Packet(fixed_header=p.FixedHeader(type=p.SUBSCRIBE, qos=1), packet_id=i + 1, protocol_version=5,
                          filters=[p.Subscription(filter=f"f/{i}/#", qos=1)])
        frames.append(p.encode_packet(pk))
    return frames


def _read(cl, chunks, hooks_on=True):
    """Run ``cl.read`` over a ``StreamReader`` fed ``chunks`` and closed;
    the packets handled and the error it ended with."""
    got = []

    async def go():
        reader = asyncio.StreamReader()
        for c in chunks:
            reader.feed_data(c)
        reader.feed_eof()
        cl.net.reader = reader
        try:
            await cl.read(lambda c, pk: got.append(canon(pk)))
        except Exception as e:  # the reader's EOF, or the stream's fault
            return type(e).__name__, getattr(e, "code", None), getattr(e, "reason", None)
        return None

    return got, asyncio.run(go())


@pytest.mark.parametrize("split", ["whole", "bytes", "seeded"])
def test_read_loop_equals_the_jax_package(split):
    rng = random.Random(5)
    stream = b"".join(_inbound_stream(tp, rng))
    assert stream == b"".join(_inbound_stream(jp, random.Random(5)))
    if split == "whole":
        chunks = [stream]
    elif split == "bytes":
        chunks = [stream[i : i + 1] for i in range(0, 4000)] + [stream[4000:]]
    else:
        cuts = sorted(rng.sample(range(1, len(stream)), 200))
        chunks = [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])]
    (srv, jcl, _), (ops, tcl, _) = twins()
    for cl in (jcl, tcl):
        cl.properties.protocol_version = 5
    jc, tc = Counting(jhooks), Counting(thooks)
    srv.hooks.add(jc.hook, None)
    ops.hooks.add(tc.hook, None)
    jgot, jend = _read(jcl, chunks)
    tgot, tend = _read(tcl, chunks)
    assert len(tgot) == 300 and tgot == jgot
    assert tend == jend == ("ConnectionClosedError", None, None)
    assert tc.calls == jc.calls
    for k in ("bytes_received", "packets_received", "messages_received"):
        assert getattr(ops.info, k) == getattr(srv.info, k), k


@pytest.mark.parametrize("fault", ["bad header", "bad varint", "too large", "truncated"])
def test_read_loop_faults_equal_the_jax_package(fault):
    good = tp.encode_packet(publish(tp, 0, qos=0, topic="ok", payload=b"1"))
    bad = {
        "bad header": b"\x00\x00",
        "bad varint": b"\x30\xff\xff\xff\xff\x01",
        "too large": tp.encode_packet(publish(tp, 0, qos=0, topic="big", payload=b"x" * 200)),
        "truncated": good[:-1],
    }[fault]
    (srv, jcl, _), (ops, tcl, _) = twins(maximum_packet_size=64)
    jgot, jend = _read(jcl, [good, good, bad])
    tgot, tend = _read(tcl, [good, good, bad])
    assert tgot == jgot and len(tgot) == 2
    assert tend == jend


def test_scan_gate_coalesces_reads_as_the_jax_package_does():
    """Four clients share one ``ScanGate``; their reads land in the same
    event-loop ticks, so each tick is one native multi-buffer scan. The
    handled packets, and the gate's batches and scans, are the JAX
    package's."""
    rng = random.Random(9)
    streams = [b"".join(_inbound_stream(tp, rng, n=80)) for _ in range(4)]

    def run(pkg_clients, twin_index):
        gate = pkg_clients.ScanGate()
        got = [[] for _ in streams]

        async def go():
            async def one(k, data):
                tw = twins()[twin_index]
                cl = tw[1]
                cl.properties.protocol_version = 5
                reader = asyncio.StreamReader()
                reader.feed_data(data)
                reader.feed_eof()
                cl.net.reader = reader
                cl.scan_gate = gate
                try:
                    await cl.read(lambda c, pk: got[k].append(canon(pk)))
                except pkg_clients.ConnectionClosedError:
                    pass

            await asyncio.gather(*(one(k, d) for k, d in enumerate(streams)))

        asyncio.run(go())
        return got, gate.batches, gate.scans

    jgot, jb, js = run(jclients, 0)
    tgot, tb, ts = run(tclients, 1)
    assert tgot == jgot and [len(g) for g in tgot] == [80] * 4
    assert (tb, ts) == (jb, js) and ts > tb > 0


def test_inflight_resend_and_clears_equal_the_jax_package():
    (srv, jcl, jw), (ops, tcl, tw) = twins()
    jc, tc = Counting(jhooks), Counting(thooks)
    srv.hooks.add(jc.hook, None)
    ops.hooks.add(tc.hook, None)
    for cl, p, info in ((jcl, jp, srv.info), (tcl, tp, ops.info)):
        for i, created in ((3, 300), (1, 100), (2, 200)):
            cl.state.inflight.set(publish(p, i, created=created))
            info.inflight += 1
        cl.state.inflight.set(p.Packet(fixed_header=p.FixedHeader(type=p.PUBACK), packet_id=4, created=50))
        info.inflight += 1
        cl.resend_inflight_messages(True)
        assert cl.clear_expired_inflights(10_000, 9_850) == [1]
        cl.clear_inflights()
    assert tw.data == jw.data and len(tw.data) > 0
    assert tc.calls == jc.calls
    assert ops.info.inflight == srv.info.inflight


def test_clients_registry_and_stop_equal_the_jax_package():
    (srv, jcl, _), (ops, tcl, _) = twins()
    jreg, treg = jclients.Clients(), tclients.Clients()
    jreg.add_client(jcl)
    treg.add_client(tcl)
    assert treg._lock.stats.name == jreg._lock.stats.name == "clients"
    assert [c.id for c in treg.get_by_listener("t1")] == [c.id for c in jreg.get_by_listener("t1")] == ["cl1"]
    for cl, p in ((jcl, jp), (tcl, tp)):
        cl.stop(p.CODE_DISCONNECT())
        first = cl.stop_cause
        cl.stop(p.ERR_SERVER_SHUTTING_DOWN())
        assert cl.stop_cause is first and cl.closed
    assert treg.get_by_listener("t1") == []
    assert (tcl.stop_cause.code, tcl.stop_cause.reason) == (jcl.stop_cause.code, jcl.stop_cause.reason)


def test_topic_aliases_equal_the_jax_package():
    rng = random.Random(2)
    for maximum in (0, 1, 5, 0xFFFF):
        j, t = jtopics.TopicAliases(maximum), ttopics.TopicAliases(maximum)
        for _ in range(200):
            topic = f"t/{rng.randrange(12)}"
            assert t.outbound.set(topic) == j.outbound.set(topic)
            aid, name = rng.randrange(1, 8), rng.choice(["", topic])
            assert t.inbound.set(aid, name) == j.inbound.set(aid, name)
        assert (t.outbound.internal, t.outbound.cursor, t.inbound.internal) == \
            (j.outbound.internal, j.outbound.cursor, j.inbound.internal)


def test_hooks_dispatch_equals_the_jax_package():
    """The modifier chains, the reject and ignore codes, the auth ORs and
    the stored readers through both dispatchers."""
    log = logging.getLogger("test")

    def chain(hk, p):
        class Tag(hk.Hook):
            def __init__(self, tag, reject=None):
                super().__init__()
                self.tag, self.reject = tag, reject

            def id(self):
                return self.tag

            def provides(self, b):
                return b in (hk.ON_PUBLISH, hk.ON_PACKET_READ, hk.ON_ACL_CHECK, hk.ON_SELECT_SUBSCRIBERS,
                             hk.STORED_CLIENTS)

            def on_publish(self, cl, pk):
                if self.reject is not None:
                    raise self.reject()
                pk.payload += self.tag.encode()
                return pk

            def on_packet_read(self, cl, pk):
                pk.topic_name += self.tag
                return pk

            def on_acl_check(self, cl, topic, write):
                return topic == self.tag

            def on_select_subscribers(self, subs, pk):
                subs.shared_selected = {self.tag: None}
                return subs

            def stored_clients(self):
                return [self.tag] if self.tag == "b" else []

        hooks = hk.Hooks(log)
        for tag, reject in (("a", None), ("b", None), ("c", p.CODE_SUCCESS_IGNORE), ("d", None)):
            hooks.add(Tag(tag, reject), None)
        pk = publish(p, 0, qos=0, topic="t", payload=b"")
        out = []
        try:
            hooks.on_publish(None, pk)
        except p.Code as e:
            out.append((e.code, e.reason))
        out.append(bytes(pk.payload))
        out.append(hooks.on_packet_read(None, pk).topic_name)
        out += [hooks.on_acl_check(None, x, False) for x in ("b", "z")]
        out.append(hooks.on_connect_authenticate(None, pk))
        out.append(hooks.stored_clients())
        out.append(hooks.provides(hk.ON_WILL, hk.ON_PUBLISH))
        out.append((len(hooks), hooks.generation))
        return out

    assert chain(thooks, tp) == chain(jhooks, jp)
