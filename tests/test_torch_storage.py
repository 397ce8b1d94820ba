"""The port's storage hooks (``mqtt_tpu_torch.hooks.storage``) held against
the JAX package's on the CPU: ``dumps`` gives the same bytes for the same
seeded records, the ``*_from_dict`` readers give the same records back,
``MemoryStore`` restores what it was given, and a ``MemoryStore`` attached
to each package's ``Server`` through a scripted session (the session of
``test_torch_server``) mirrors the same records, key for key.

The SQLite, LogKV and redis stores (the redis client is ``fake_redis``'s
stand-in: the ``redis`` package is absent) answer a seeded sequence of
writes, deletes and scans as the JAX stores do, across a reopen; a port
``Server`` restarts from each through ``read_store`` as the JAX server
does from the same records. LogKV's compaction, torn and corrupt records,
rotation, snapshots and crash points recover the JAX store's maps, and the
debug hook logs the JAX hook's lines.
"""

import asyncio
import json
import random
from dataclasses import asdict

import pytest

from test_torch_server import Broker, allow, package, pinned_clock, script_core  # noqa: F401 (fixture)


def modules(name):
    pkg = package(name)
    from importlib import import_module

    root = pkg.memory.__name__.rsplit(".", 1)[0]
    return import_module(root), import_module(root + ".base"), pkg


def seeded_records(name: str, seed: int) -> list:
    """One of each DTO with seeded fields, built in one package."""
    st, _, _ = modules(name)
    from importlib import import_module

    packets = import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".packets")
    system = import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".system")
    rng = random.Random(seed)
    users = [packets.UserProperty(f"k{i}", f"v{rng.randrange(99)}") for i in range(rng.randrange(3))]
    return [
        st.Client(id=f"c{seed}", remote="10.0.0.1:1", listener="t", username=bytes([rng.randrange(256)] * 3),
                  clean=rng.random() < 0.5, protocol_version=rng.choice([3, 4, 5]),
                  properties=st.ClientProperties(session_expiry_interval=rng.randrange(1 << 16),
                                                 session_expiry_interval_flag=True,
                                                 authentication_data=b"\x00\xff", receive_maximum=10, user=users),
                  will=st.ClientWill(payload=b"bye\x00", topic_name="will/t", flag=1, qos=1, retain=True,
                                     will_delay_interval=5, user=users)),
        st.Subscription(client=f"c{seed}", filter="a/+/#", identifier=rng.randrange(9), qos=rng.randrange(3),
                        retain_as_published=True, no_local=rng.random() < 0.5, retain_handling=2,
                        predicates=["$GT{v:%d}" % rng.randrange(9)]),
        st.Message(t=st.RETAINED_KEY, client=f"c{seed}", id="RET_a/b", origin="o", topic_name="a/b",
                   payload=bytes(rng.randrange(256) for _ in range(17)), created=1234, sent=5, packet_id=7,
                   qos=2, dup=True, retain=True, protocol_version=5, expiry=99999,
                   properties=st.MessageProperties(correlation_data=b"\x01", subscription_identifier=[1, 2],
                                                   user=users, content_type="json", response_topic="r/t",
                                                   message_expiry_interval=60, topic_alias=3,
                                                   payload_format=1, payload_format_flag=True)),
        st.SystemInfo(info=system.Info(version="0.1.0", started=1, bytes_received=rng.randrange(1 << 30),
                                       clients_connected=3, retained=rng.randrange(100))),
    ]


@pytest.mark.parametrize("seed", range(6))
def test_dumps_and_readers_equal_the_jax_package(seed):
    got = []
    for name in ("jax", "torch"):
        st, base, _ = modules(name)
        recs = seeded_records(name, seed)
        raw = [base.dumps(r) for r in recs]
        back = [
            base.client_from_dict(base._decode(json.loads(raw[0]))),
            base.subscription_from_dict(base._decode(json.loads(raw[1]))),
            base.message_from_dict(base._decode(json.loads(raw[2]))),
            base.sys_info_from_dict(base._decode(json.loads(raw[3]))),
        ]
        assert [base.dumps(b) for b in back] == raw  # the readers invert dumps
        got.append((raw, [json.dumps(asdict(b), default=repr, sort_keys=True) for b in back],
                    back[2].to_packet().payload, (st.SUBSCRIPTION_KEY, st.SYS_INFO_KEY, st.RETAINED_KEY,
                                                  st.INFLIGHT_KEY, st.CLIENT_KEY)))
    assert got[0] == got[1]


def test_memory_store_restores_what_it_mirrors():
    st, base, pkg = modules("torch")
    store = pkg.memory.MemoryStore()
    store.init({"CL_x": base.dumps(st.Client(id="x", protocol_version=5))})
    recs = seeded_records("torch", 3)
    store._set(st.SUBSCRIPTION_KEY + "_c3:a/+/#", base.dumps(recs[1]))
    store._set(st.RETAINED_KEY + "_a/b", base.dumps(recs[2]))
    store._set(st.SYS_INFO_KEY, base.dumps(recs[3]))
    assert [c.id for c in store.stored_clients()] == ["x"]
    assert base.dumps(store.stored_subscriptions()[0]) == base.dumps(recs[1])
    assert base.dumps(store.stored_retained_messages()[0]) == base.dumps(recs[2])
    assert store.stored_inflight_messages() == []
    assert store.stored_sys_info().info.retained == recs[3].info.retained
    store._del(st.SYS_INFO_KEY)
    assert store.stored_sys_info() is None
    assert store.id() == "memory-store" and store.provides(pkg.hooks.STORED_SUBSCRIPTIONS)


def test_server_mirrors_the_same_records_as_the_jax_server(pinned_clock):
    """The write-through hook under a scripted session: every client,
    subscription, retained and inflight record the port's server mirrors
    equals the JAX server's (the clients' ephemeral remote ports and the
    wall-clock $SYS snapshot aside)."""
    stores = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        store = pkg.memory.MemoryStore()

        async def main():
            b = Broker(pkg, hooks=allow(pkg) + [(store, None)])
            await b.start()
            await script_core(b)
            await b.close()

        asyncio.run(main())
        stores[name] = store

    def norm(store):
        out = {}
        for k, v in store.data.items():
            if k == "SYS":
                continue
            d = json.loads(v)
            d.pop("remote", None)
            out[k] = d
        return out

    j, t = norm(stores["jax"]), norm(stores["torch"])
    assert t == j
    kinds = {k.split("_", 1)[0] for k in t}
    assert kinds == {"CL", "SUB", "RET", "IFM"} and len(t) > 20


# -- the file-backed and redis stores ------------------------------------------------


def store_of(name: str, kind: str, tmp_path, server: dict = None, init: bool = True):
    """A store of ``kind`` in one package and its options, initialized
    unless ``init`` is False (``server`` is the fake redis process's key
    space)."""
    from importlib import import_module

    from fake_redis import FakeRedis

    root = "mqtt_tpu" if name == "jax" else "mqtt_tpu_torch"
    if kind == "sqlite":
        mod = import_module(root + ".hooks.storage.sqlite")
        store, conf = mod.SqliteStore(), mod.SqliteOptions(path=str(tmp_path / f"{name}.db"))
    elif kind == "logkv":
        mod = import_module(root + ".hooks.storage.logkv")
        store, conf = mod.LogKVStore(), mod.LogKVOptions(path=str(tmp_path / f"{name}-kv"), gc_interval=0)
    else:
        mod = import_module(root + ".hooks.storage.redis")
        store, conf = mod.RedisStore(), mod.RedisOptions(client=FakeRedis(server if server is not None else {}))
    if init:
        store.init(conf)
    return store, conf


KINDS = ["sqlite", "logkv", "redis"]


@pytest.mark.parametrize("kind", KINDS)
def test_store_verbs_equal_the_jax_store(kind, tmp_path):
    """``_set``/``_get``/``_del``/``_iter`` on one seeded sequence of
    keys in both packages' store of one kind, then a reopen: the same
    answers at every step and after the restart."""
    rng = random.Random(5)
    keys = [f"{rng.choice(['CL', 'SUB', 'RET', 'IFM'])}_{rng.randrange(40)}" for _ in range(300)]
    got = []
    for name in ("jax", "torch"):
        server: dict = {}
        store, _ = store_of(name, kind, tmp_path, server)
        trace = []
        for i, k in enumerate(keys):
            if i % 7 == 3:
                store._del(k)
            else:
                store._set(k, b"v%d" % i)
            trace.append(store._get(k))
        trace.append({p: sorted(store._iter(p)) for p in ("CL", "SUB", "RET", "IFM", "X")})
        store.stop()
        again, _ = store_of(name, kind, tmp_path, server)
        trace.append({p: sorted(again._iter(p)) for p in ("CL", "SUB", "RET", "IFM")})
        trace.append(again.id())
        again.stop()
        got.append(trace)
    assert got[0] == got[1]
    assert len(got[1][-2]["SUB"]) > 10


@pytest.mark.parametrize("kind", KINDS)
def test_server_restarts_from_each_store_as_the_jax_server(kind, tmp_path):
    """One seeded set of records (``test_torch_server.seeded_store``)
    written into a store of each kind in each package, then each
    package's ``Server`` restarts through ``read_store``: the same
    subscribers for 1,000 seeded topics, the same ``_durable`` counters
    (``replayed_keys`` is the LogKV store's), the same clients and
    inflight; the port's device matcher, folded, answers as its trie."""
    from test_torch_server import WORDS, cs_canon, options, seeded_store

    rng = random.Random(3)
    topics = ["/".join(rng.choice(WORDS) for _ in range(rng.randint(1, 4))) for _ in range(1000)]
    got = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        mem = seeded_store(pkg, n_subs=3000, n_clients=32, n_retained=100, n_inflight=40)
        server: dict = {}
        filled, _ = store_of(name, kind, tmp_path, server)
        for k, v in mem.data.items():
            filled._set(k, v)
        filled.stop()
        # the server opens the store anew, as a restarted broker does
        store, conf = store_of(name, kind, tmp_path, server, init=False)
        srv = pkg.server.Server(options(pkg, durable_restore_batch=500))
        srv.add_hook(store, conf)
        srv.read_store()
        try:
            subs = [cs_canon(srv.topics.subscribers(t)) for t in topics]
            durable = {k: v for k, v in srv._durable.items() if k != "recovery_seconds"}
            clients = {cid: (cl.properties.protocol_version, len(cl.state.inflight),
                             sorted(cl.state.subscriptions.get_all()))
                       for cid, cl in srv.clients.get_all().items()}
            if name == "torch":
                srv.matcher.flush()
                dev = srv.matcher.match_topics(topics)
                assert [cs_canon(r.materialize() if hasattr(r, "materialize") else r) for r in dev] == subs
        finally:
            srv.matcher.close()
            store.stop()
        got[name] = (subs, durable, clients)
    assert got["torch"] == got["jax"]
    subs, durable, clients = got["torch"]
    assert durable["restored_subscriptions"] > 2000 and durable["restored_retained"] == 100
    assert (durable["replayed_keys"] > 3000) == (kind == "logkv")
    assert sum(len(s[0]) for s in subs) > 300 and len(clients) > 20


@pytest.mark.parametrize("kind", KINDS)
def test_each_store_mirrors_a_session_as_the_jax_store(kind, tmp_path, pinned_clock):
    """The scripted session of ``test_torch_server`` with a store of each
    kind attached to each package's ``Server``: the store holds the same
    client, subscription, retained and inflight records, key for key (the
    clients' ephemeral remote ports and the $SYS snapshot aside), after the
    server closed it and it was opened again."""
    got = {}
    for name in ("jax", "torch"):
        pkg = package(name)
        server: dict = {}
        store, conf = store_of(name, kind, tmp_path / "live", server, init=False)

        async def main():
            b = Broker(pkg, hooks=allow(pkg) + [(store, conf)])
            await b.start()
            await script_core(b)
            await b.close()

        (tmp_path / "live").mkdir(exist_ok=True)
        asyncio.run(main())
        again, _ = store_of(name, kind, tmp_path / "live", server)
        out = {}
        for prefix in ("CL", "SUB", "RET", "IFM"):
            for v in again._iter(prefix):
                d = json.loads(v)
                d.pop("remote", None)
                if not (d.get("topic_name") or "").startswith("$SYS"):
                    out.setdefault(prefix, []).append(json.dumps(d, sort_keys=True))
        again.stop()
        got[name] = {k: sorted(v) for k, v in out.items()}
    assert got["torch"] == got["jax"]
    assert set(got["torch"]) == {"CL", "SUB", "RET", "IFM"} and sum(map(len, got["torch"].values())) > 20


def test_redis_store_is_gated_without_a_client():
    from mqtt_tpu_torch.hooks.storage.redis import RedisStore

    with pytest.raises(RuntimeError, match="redis"):
        RedisStore().init(None)  # the redis package is absent here


def test_redis_prefixes_isolate_two_brokers():
    from fake_redis import FakeRedis

    from mqtt_tpu_torch.hooks.storage.redis import RedisOptions, RedisStore

    server: dict = {}
    a, b = RedisStore(), RedisStore()
    a.init(RedisOptions(client=FakeRedis(server), h_prefix="a-"))
    b.init(RedisOptions(client=FakeRedis(server), h_prefix="b-"))
    a._set("CL_x", b"1")
    b._set("CL_x", b"2")
    assert (a._get("CL_x"), b._get("CL_x"), list(a._iter("CL"))) == (b"1", b"2", [b"1"])


# -- LogKV: compaction, crash tolerance, rotation, snapshots -------------------------


def logkv(name: str):
    from importlib import import_module

    return import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".hooks.storage.logkv")


def faults(name: str):
    """Each package's fault injector (its storage crash plans)."""
    from importlib import import_module

    return import_module(("mqtt_tpu" if name == "jax" else "mqtt_tpu_torch") + ".faults")


def _disk(path) -> list:
    import os

    return sorted((n, os.path.getsize(os.path.join(path, n))) for n in os.listdir(path))


@pytest.mark.parametrize("case", ["compaction", "torn-tail", "midfile-corruption", "rotation", "snapshot",
                                  "compact-crash"])
def test_logkv_equals_the_jax_store(case, tmp_path, caplog):
    """The JAX suite's LogKV cases (compaction dropping dead records, a
    torn tail record tolerated, a mid-file bit flip counted and logged
    with its offset, size rotation, snapshot + tail recovery, a crash
    between the compacted write and the old segments' deletes) in both
    packages: the same maps, files, counters and warnings."""
    import logging
    import os

    got = []
    for name in ("jax", "torch"):
        mod = logkv(name)
        path = str(tmp_path / name)
        opts = dict(path=path, gc_interval=0)
        if case == "rotation":
            opts["max_segment_bytes"] = 512
        s = mod.LogKVStore()
        s.init(mod.LogKVOptions(**opts))
        out = []
        if case == "compaction":
            for _ in range(200):
                s._set("CL_hot", b"v" * 100)
            before = sum(n for _, n in _disk(path))
            out.append(s.compact(0.5))
            out.append(sum(n for _, n in _disk(path)) < before / 10)
        elif case in ("torn-tail", "midfile-corruption"):
            for k in "abc":
                s._set("CL_" + k, b"v" + k.encode())
        elif case == "rotation":
            for i in range(50):
                s._set(f"CL_{i}", b"x" * 64)
            out.append(len(os.listdir(path)) > 1)
        elif case == "snapshot":
            for i in range(30):
                s._set(f"CL_{i}", b"s%d" % i)
            out.append(s.snapshot())
            for i in range(10):
                s._del(f"CL_{i}")
                s._set(f"RET_{i}", b"t%d" % i)
        else:
            for i in range(20):
                s._set(f"CL_{i}", f"v{i}".encode())
            for i in range(5):
                s._set(f"CL_{i}", f"w{i}".encode())
            for i in range(15, 20):
                s._del(f"CL_{i}")
            expected = dict(s._map)

            def crash(_p):
                raise OSError("crash injected before delete")

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(mod.os, "unlink", crash)
                with pytest.raises(OSError):
                    s.compact(0.0)
            s._file.close()
        if case != "compact-crash":
            s.stop()
        if case == "torn-tail":
            seg = os.path.join(path, sorted(os.listdir(path))[-1])
            os.truncate(seg, os.path.getsize(seg) - 2)
        elif case == "midfile-corruption":
            seg = os.path.join(path, sorted(os.listdir(path))[0])
            data = bytearray(open(seg, "rb").read())
            data[19 + 9 + 4] ^= 0xFF
            open(seg, "wb").write(bytes(data))
        caplog.clear()
        s2 = mod.LogKVStore()
        with caplog.at_level(logging.WARNING):
            s2.init(mod.LogKVOptions(path=path, gc_interval=0))
        warns = [r.getMessage() for r in caplog.records if "corrupt record" in r.getMessage()]
        st = s2.durable_stats()
        out += [dict(s2._map), _disk(path), warns, {k: st[k] for k in ("keys", "segments", "snapshot_seq",
                                                                       "replayed_keys", "replay_corruptions",
                                                                       "replay_skipped_bytes", "snapshot_invalid")}]
        if case == "compact-crash":
            out.append(s2._map == expected)
        s2.stop()
        got.append(out)
    assert got[1] == got[0]
    t = got[1]
    if case == "torn-tail":
        assert "CL_c" not in t[0] and t[0]["CL_a"] == b"va"
    if case == "midfile-corruption":
        assert t[0] == {"CL_a": b"va"} and t[3]["replay_corruptions"] == 1 and t[3]["replay_skipped_bytes"] == 38
        assert "offset=19" in t[2][0]
    if case == "snapshot":
        assert t[0] is True and t[4]["snapshot_seq"] >= 0 and len(t[1]) == 30
    if case == "compact-crash":
        assert t[-1] is True and t[-2]["replay_corruptions"] == 0


@pytest.mark.parametrize("point", ["append", "rotate", "snapshot.begin", "snapshot.rename", "snapshot.prune",
                                   "compact.rewrite", "compact.prune"])
def test_logkv_crash_points_replay_as_the_jax_store(point, tmp_path):
    """A simulated kill at each named crash point (the append torn after
    a seeded prefix), each package's ``faults.StorageCrashPlan`` on its
    own store, then a reopen: both packages recover the same map, and it
    holds every record written before the kill."""
    got = []
    for name in ("jax", "torch"):
        mod = logkv(name)
        path = str(tmp_path / name)
        s = mod.LogKVStore()
        s.init(mod.LogKVOptions(path=path, gc_interval=0, max_segment_bytes=600))
        durable = {}
        for i in range(12):
            s._set(f"CL_{i % 8}", b"d%d" % i)
            durable[f"CL_{i % 8}"] = b"d%d" % i
        s._del("CL_1")
        durable.pop("CL_1")
        plans = faults(name)
        if point == "append":
            s.crash_plan = plans.StorageCrashPlan(seed=7, crash_at_op=0, torn=True)
        else:
            s.crash_plan = plans.StorageCrashPlan(crash_point=point)
        with pytest.raises(mod.SimulatedCrash):
            if point.startswith("snapshot"):
                s.snapshot()
            elif point.startswith("compact"):
                s.compact(0.0)
            else:
                for i in range(40):
                    s._set(f"RET_{i}", b"x" * 40)
                    durable[f"RET_{i}"] = b"x" * 40
        s._file.close()
        s2 = mod.LogKVStore()
        s2.init(mod.LogKVOptions(path=path, gc_interval=0))
        for k, v in durable.items():
            if k.startswith("CL_"):
                assert s2._map.get(k) == v, (name, k)
        got.append((dict(s2._map), s2.replay_corruptions))
        s2.stop()
    assert got[1] == got[0]


# -- the debug hook ------------------------------------------------------------------


@pytest.mark.parametrize("show", [False, True], ids=["default", "show-all"])
def test_debug_hook_logs_what_the_jax_hook_logs(show, caplog):
    """Every event of the debug hook on the same packets in both packages:
    the same log lines (pings hidden unless ``show_pings``, payloads and
    passwords shown only when asked)."""
    import logging

    lines = []
    for name in ("jax", "torch"):
        from importlib import import_module

        root = "mqtt_tpu" if name == "jax" else "mqtt_tpu_torch"
        dbg = import_module(root + ".hooks.debug")
        p = import_module(root + ".packets")
        hook = dbg.DebugHook()
        hook.init(dbg.DebugOptions(show_packet_data=show, show_pings=show, show_passwords=show))
        hook.log = logging.getLogger(f"debugtest.{name}")
        cl = type("C", (), {"id": "c1"})()
        pks = [
            p.Packet(fixed_header=p.FixedHeader(type=p.CONNECT), protocol_version=4,
                     connect=p.ConnectParams(username=b"u", password=b"pw", client_identifier="c1", clean=True,
                                             keepalive=30)),
            p.Packet(fixed_header=p.FixedHeader(type=p.CONNACK), session_present=True),
            p.Packet(fixed_header=p.FixedHeader(type=p.PUBLISH, qos=1), topic_name="t/1", payload=b"x", packet_id=3),
            p.Packet(fixed_header=p.FixedHeader(type=p.SUBSCRIBE), filters=[p.Subscription(filter="a/#", qos=1)]),
            p.Packet(fixed_header=p.FixedHeader(type=p.SUBACK), reason_codes=bytes([1])),
            p.Packet(fixed_header=p.FixedHeader(type=p.PINGREQ)),
            p.Packet(fixed_header=p.FixedHeader(type=p.DISCONNECT)),
        ]
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=f"debugtest.{name}"):
            hook.on_started()
            for pk in pks:
                hook.on_packet_read(cl, pk)
                hook.on_packet_sent(cl, pk, b"")
            hook.on_retain_message(cl, pks[2], 1)
            hook.on_qos_publish(cl, pks[2], 0, 0)
            hook.on_qos_complete(cl, pks[2])
            hook.on_qos_dropped(cl, pks[2])
            hook.on_will_sent(cl, pks[2])
            hook.on_connect(cl, pks[0])
            hook.on_disconnect(cl, None, False)
            hook.on_session_established(cl, pks[0])
            hook.on_subscribed(cl, pks[3], b"\x01")
            hook.on_unsubscribed(cl, pks[3])
            hook.on_stopped()
        lines.append([r.getMessage() for r in caplog.records])
        assert hook.provides(0) and hook.id() == "debug"
    assert lines[1] == lines[0]
    text = "\n".join(lines[1])
    assert "PUBLISH << c1" in text and "CONNACK >> c1" in text
    assert ("PINGREQ" in text) == show and ("b'pw'" in text) == show and ("'payload'" in text) == show
